"""Culled curve intersector: the closest line and point of each ray
through the work items' cull (ops/instanced_intersect.py `precull`,
csrc/candidate_cull.cu as it is) and one walk kernel
(csrc/curve_intersect.cu), with the walk's plain PyTorch twin.

Replaces no TPU kernel: the JAX package sweeps every line and point
against every ray, as render/integrator.py merge_curves still does on
the CPU and in the fixed-trip loop. On the card that sweep takes some 40
ATen ops a chunk over [lanes, elements] temporaries; here it is a cull
and one launch.

  upload: the scene's lines and points as one element table [E, 8] (the
    lines first, each p1, r1, p2, r2; then the points, each p, r and four
    zeros), with each element's world box (element_boxes) clustered by
    instanced_intersect.item_clusters, once, when the route is built.
  element_boxes: a line's box spans its ends +- their radii, a point's
    its centre +- its radius, widened by BOX_PAD times the largest
    coordinate of any box, so that the float32 slab test of the cull meets
    every hit that the float32 element tests report (their closest-approach
    point lies within the radius of the axis, up to rounding).
  curve_walk_plain / curve_intersect_kernel: each warp of 32 rays walks
    its group's candidates in t_low order and stops once no ray's bound,
    min(line best t, point best t), reaches the next candidate's t_low;
    each ray tests the element with ops/geometry.py intersect_line or
    intersect_point and keeps the closest line and the closest point
    below the quad hit's t (tmax), lower indices winning ties (the
    kernel's comment gives the rules). The two compute the same function
    and agree bit for bit on the card; both count the (ray, element)
    pairs they test (`tested`).
  curve_intersect: the cull, then the walk under a `curve_walk`
    device_span (utils/timing.py: `rays`, `elements`, and, read when the
    units are, `candidates` (the cull's list entries) and `tested`).

render/integrator.py merge_curves turns the walk's closest line and point
into the merged Hit exactly as its sweep does, so on the card the route
gives the sweep's hits bit for bit. `curve_intersect_kernel.launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, intersect_line, intersect_point,
)
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

WARP = wl.WARP
GROUP_RAYS = ii.GROUP_RAYS  # rays per candidate list, as the work items'
FLAGS = ("-fmad=false",)
# an element box's margin, a share of the largest |coordinate| of any box:
# the element tests and the cull's slab test round apart by a few ulp of
# the rays' and elements' coordinates (some 1e-6 of them for rays that
# start within 20x the scene's extent of it)
BOX_PAD = 2e-5


class CurveTables(NamedTuple):
    elems: torch.Tensor  # f32 [E, 8] lines (p1, r1, p2, r2), then points
    n_lines: int
    clusters: ii.ItemClusters  # the elements' world boxes, clustered


class CurveBest(NamedTuple):
    """The walk's closest line and point of each ray."""

    line: torch.Tensor  # i32 [N] line index, -1: none
    line_t: torch.Tensor  # f32 [N] F32_MAX where none
    line_u: torch.Tensor  # f32 [N] segment parameter
    line_v: torch.Tensor  # f32 [N] radial fraction
    point: torch.Tensor  # i32 [N] point index (among the points), -1: none
    point_t: torch.Tensor  # f32 [N] F32_MAX where none


def element_boxes(line_verts, line_radius, point_pos, point_radius):
    """World boxes [L + P, 6] f32 (min xyz, max xyz) of the lines
    [L, 2, 3] (radii [L, 2]) and points [P, 3] (radii [P]), computed in
    float64 and widened by BOX_PAD (module docstring)."""
    lv, lr = line_verts.double(), line_radius.double().abs()
    pp, pr = point_pos.double(), point_radius.double().abs()
    lo = torch.cat([torch.minimum(lv[:, 0] - lr[:, 0:1], lv[:, 1] - lr[:, 1:2]),
                    pp - pr[:, None]])
    hi = torch.cat([torch.maximum(lv[:, 0] + lr[:, 0:1], lv[:, 1] + lr[:, 1:2]),
                    pp + pr[:, None]])
    if lo.shape[0] == 0:
        return torch.zeros((0, 6), dtype=torch.float32, device=lo.device)
    scale = torch.nan_to_num(torch.cat([lo, hi]).abs(), nan=0.0,
                             posinf=0.0).amax()
    pad = BOX_PAD * scale
    return torch.cat([lo - pad, hi + pad], dim=1).float()


def upload(line_verts, line_radius, point_pos, point_radius,
           device) -> CurveTables:
    """The curve elements as CurveTables on `device` (module docstring);
    the boxes are built and clustered on the host."""
    cpu = [x.detach().cpu() for x in (line_verts, line_radius, point_pos,
                                      point_radius)]
    lv, lr, pp, pr = cpu
    lines = torch.cat([lv[:, 0], lr[:, 0:1], lv[:, 1], lr[:, 1:2]], dim=1)
    points = torch.cat([pp, pr[:, None], torch.zeros(pp.shape[0], 4)], dim=1)
    elems = torch.cat([lines, points]).float().contiguous()
    cl = ii.item_clusters(element_boxes(*cpu))
    return CurveTables(
        elems=elems.to(device), n_lines=int(lv.shape[0]),
        clusters=ii.ItemClusters(*(x.to(device) for x in cl)))


def curve_walk_plain(tables: CurveTables, ro, rd, tmin, tmax, order, tlow,
                     cnt, group: int = GROUP_RAYS):
    """Plain PyTorch version of the kernel -> (CurveBest, tested: the
    (ray, element) pairs tested, an int64 tensor). One step per list
    position: the warps still walking take their next element (after the
    stopping rule) and their rays test it."""
    wl.check_group(group)
    n, dev, L = ro.shape[0], ro.device, tables.n_lines
    nw = -(-n // WARP)
    lane = torch.arange(n, device=dev)
    warp, row = lane // WARP, lane // group
    warp_cnt = cnt[torch.arange(nw, device=dev) * WARP // group]
    rays_in = (n - torch.arange(nw, device=dev) * WARP).clamp(max=WARP)
    lt, pt = tmax.clone(), tmax.clone()
    li = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lu = torch.zeros(n, device=dev)
    lv = torch.zeros(n, device=dev)
    tested = torch.zeros((), dtype=torch.int64, device=dev)
    walking = warp_cnt > 0
    for k in range(order.shape[1] if n else 0):
        reach = torch.zeros(nw * WARP, dtype=torch.bool, device=dev)
        reach[:n] = torch.minimum(lt, pt) >= tlow[row, k]
        walking &= (k < warp_cnt) & reach.view(nw, WARP).any(dim=1)
        if not bool(walking.any()):
            break
        tested += rays_in[walking].sum()
        w = torch.nonzero(walking[warp]).squeeze(1)  # rays of walking warps
        e = order[row[w], k].long()
        el = tables.elems[e]
        line = e < L
        r, e_ = w[line], e[line]
        if r.numel():
            h, s, v, t = intersect_line(ro[r], rd[r], tmin[r], tmax[r],
                                        el[line, 0:3], el[line, 4:7],
                                        el[line, 3], el[line, 7])
            take = h & ((t < lt[r]) | ((t == lt[r]) & (li[r] >= 0)
                                       & (e_ < li[r])))
            lt[r] = torch.where(take, t, lt[r])
            li[r] = torch.where(take, e_, li[r])
            lu[r] = torch.where(take, s, lu[r])
            lv[r] = torch.where(take, v, lv[r])
        r, p_ = w[~line], e[~line] - L
        if r.numel():
            h, t = intersect_point(ro[r], rd[r], tmin[r], tmax[r],
                                   el[~line, 0:3], el[~line, 3])
            take = h & ((t < pt[r]) | ((t == pt[r]) & (pi[r] >= 0)
                                       & (p_ < pi[r])))
            pt[r] = torch.where(take, t, pt[r])
            pi[r] = torch.where(take, p_, pi[r])
    best = CurveBest(
        line=li.to(torch.int32), line_t=torch.where(li >= 0, lt, F32_MAX),
        line_u=lu, line_v=lv, point=pi.to(torch.int32),
        point_t=torch.where(pi >= 0, pt, F32_MAX))
    return best, tested


def curve_intersect_kernel(tables: CurveTables, ro, rd, tmin, tmax, order,
                           tlow, cnt, group: int = GROUP_RAYS):
    """Launch csrc/curve_intersect.cu on CUDA tensors (raises otherwise)
    -> (CurveBest, tested: a 0-d int64 tensor on the device); nothing is
    read back and every shape is fixed by the inputs'."""
    if ro.device.type != "cuda":
        raise ValueError(f"curve_intersect_kernel: {ro.device} is not a "
                         "CUDA device")
    wl.check_group(group)
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    items = tables.elems.shape[0]
    ng = max(1, -(-n // group))
    wl._check(ro, f32, (n, 3), dev, "ro")
    wl._check(rd, f32, (n, 3), dev, "rd")
    wl._check(tmin, f32, (n,), dev, "tmin")
    wl._check(tmax, f32, (n,), dev, "tmax")
    wl._check(tables.elems, f32, (items, 8), dev, "elems")
    wl._check(order, i32, (ng, items), dev, "order")
    wl._check(tlow, f32, (ng, items), dev, "tlow")
    wl._check(cnt, i32, (ng,), dev, "cnt")
    line = torch.empty(n, dtype=i32, device=dev)
    point = torch.empty(n, dtype=i32, device=dev)
    lt, lu, lv, pt = (torch.empty(n, dtype=f32, device=dev) for _ in range(4))
    tested = torch.zeros((), dtype=torch.int64, device=dev)
    err = _lib().curve_walk_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        tables.elems.data_ptr(), tables.n_lines, order.data_ptr(),
        tlow.data_ptr(), cnt.data_ptr(), items, group, line.data_ptr(),
        lt.data_ptr(), lu.data_ptr(), lv.data_ptr(), point.data_ptr(),
        pt.data_ptr(), tested.data_ptr(), cuda_build.stream_handle(dev))
    cuda_build.check(err, "curve_intersect")
    if n:  # the launcher launches nothing for no rays
        curve_intersect_kernel.launches += 1
    return CurveBest(line, lt, lu, lv, point, pt), tested


timing.counter(curve_intersect_kernel, "launches")


def _lib():
    lib = cuda_build.load("curve_intersect", FLAGS)
    fn = lib.curve_walk_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, p, p, p, i, i, p, p, p, p, p, p,
                       p, p]
        fn.restype = ctypes.c_int
    return lib


def curve_intersect(tables: CurveTables, ro, rd, tmin, tmax) -> CurveBest:
    """Closest line and point of rays ro/rd [N, 3], tmin/tmax [N] (tmax:
    the quad hit's t) among the curve elements: precull over their boxes,
    then curve_walk_plain for CPU tensors or the kernel for CUDA tensors,
    with candidate lists per GROUP_RAYS rays."""
    n, items = ro.shape[0], tables.elems.shape[0]
    lists = ii.precull(ro, rd, tmin, tmax, tables.clusters)
    with roofline.kernel_region() as counter:
        with timing.device_span("curve_walk", ro.device, rays=n,
                                elements=items) as sp:
            if ro.device.type == "cpu":
                best, tested = curve_walk_plain(tables, ro, rd, tmin, tmax,
                                                *lists)
            else:
                best, tested = curve_intersect_kernel(tables, ro, rd, tmin,
                                                      tmax, *lists)
            sp.add(candidates=lists[2].sum(dtype=torch.int64), tested=tested)
        if counter is not None:
            counter.add_kernel("curve_intersect",
                               kf.curve_walk_cost(n, items))
    return best
