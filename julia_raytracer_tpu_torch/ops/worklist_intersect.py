"""Worklist cluster intersector for scenes of 113 to ~150k quads: the
table packing, the precull, the wrapper of csrc/worklist_intersect.cu and
its plain PyTorch version.

Replaces make_cluster_intersect_worklist and its Pallas TPU kernel
_make_kernel_worklist (julia_raytracer_tpu/ops/pallas_cluster.py).

  pack_tables: cluster tables (ops/cluster_tables.py) padded to S
    superclusters of `sup` clusters, packed as tab [S*sup, 16, 128]
    (transform rows 0-11, normal rows 12-14, instance row 15), bbox
    [S*sup, 8] and supercluster boxes sbbox [S, 8].
  precull: per group of `group` rays (GROUP_RAYS = 32 by default; the JAX
    package's 1,024 in the tests), the superclusters its rays enter, front
    to back by the group's nearest entry (a stable sort: rays that start
    inside several boxes tie at 0), and their count. Plain tensor code on
    the rays' device; nothing is read back to the host. Rays are padded to
    whole groups with zeros (tmin = tmax = 0), as the JAX package pads
    them; a padding ray never hits.
  worklist_intersect_kernel / worklist_intersect_plain: each warp of 32
    rays walks its group's list (superclusters in order, clusters in index
    order), each ray culls each cluster box with its running best t and
    takes the closest hit of the 128 triangles of a cluster it wants (the
    first minimum, as a strict `<` in index order finds it). The two
    compute the same function in the same order and agree bit for bit on
    the card. The plain version also counts the work: the (ray, cluster)
    pairs that pass the cull, which bound the kernel, and the warps,
    (warp, supercluster) steps, mask votes and (warp, cluster) table
    loads the kernel pays for.

`worklist_intersect` runs the precull, then the plain version for CPU
tensors and the kernel for CUDA tensors (or raises), in one `worklist`
device_span (utils/timing.py: `rays`, and `device_ns` read when the
units are).
`worklist_intersect_kernel.launches` counts the kernel's launches.

Differences from the JAX function, none of which changes a hit: the work
lists belong to groups of 32 rays, not 1,024; the TPU's bf16 `split3`
matmul workaround is not carried over (the port computes in fp32, the
JAX package's `highest` mode off the TPU); the cull is per ray rather
than per 128-lane row; a cluster without a hit never updates a ray's
record (the TPU kernel's argmin over a hitless row could, for tmax =
+inf); and the `JRT_WL_SUP` / `JRT_WL_FLAT` environment knobs are gone
(`sup` is an argument)."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops.cluster_tables import (
    TRIS, WL_SUPER, _wl_super_bbox, load_cluster_tables,
)
from julia_raytracer_tpu_torch.ops.traversal import Hit, Intersector
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

WARP = 32  # rays of a walking warp
GROUP_RAYS = 32  # rays per work list (the JAX package's: 1,024)
ROWS = 16  # table rows per cluster
MAX_SUP = 128  # the kernel's cluster mask: 4 words of 32 bits
SLACK = 1.00000024  # box-test slack of the TPU kernel (2 ulp at 1.0)
TINY_DIR = 1e-30  # stands in for a zero direction component
# [rays, S] precull temporaries above this many bytes are cut into chunks
PRECULL_BYTES = 200e6
# (ray, box) tests per step of the cost counts (needed_pairs,
# instanced_intersect.needed_work): bounds their [entries, boxes, 8] gathers
COUNT_TESTS = 1 << 22


class WorklistTables(NamedTuple):
    tab: torch.Tensor  # f32 [S*sup, 16, 128]
    bbox: torch.Tensor  # f32 [S*sup, 8]
    sbbox: torch.Tensor  # f32 [S, 8]
    n_prims: int
    sup: int


def pack_tables(prim_verts: np.ndarray, prim_instance=None,
                sup: int = WL_SUPER, device="cpu",
                cache_key: str = "") -> WorklistTables:
    """[Q, 4, 3] quads in BVH order (+ [Q] instance ids) -> the packed
    tables on `device` (the JAX function's lines 1099-1131); the cluster
    tables through the disk cache under `cache_key`."""
    if not (1 <= sup <= MAX_SUP and (sup <= 8 or sup % 8 == 0)):
        raise ValueError(f"sup={sup}: must be <= 8 or a multiple of 8, "
                         f"at most {MAX_SUP}")
    q = len(prim_verts)
    tfm, nrm, bbox, n_clusters = load_cluster_tables(
        np.asarray(prim_verts, np.float64), prim_instance, cache_key
    )
    sbbox = _wl_super_bbox(bbox, sup)
    n_super = len(sbbox)
    c_pad = n_super * sup
    if c_pad > n_clusters:
        padb = np.zeros((c_pad - n_clusters, 8), np.float32)
        padb[:, 0:6] = 3e38  # never-entered box
        bbox = np.concatenate([bbox, padb], axis=0)
        padt = np.zeros((c_pad - n_clusters,) + tfm.shape[1:], np.float32)
        padt[:, 11, :] = 1.0  # never-hit transforms
        tfm = np.concatenate([tfm, padt], axis=0)
        nrm = np.concatenate(
            [nrm, np.zeros((c_pad - n_clusters,) + nrm.shape[1:], np.float32)],
            axis=0,
        )
    tab = np.concatenate([tfm, nrm], axis=1)  # [S*sup, 16, TRIS]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return WorklistTables(put(tab), put(bbox), put(sbbox), q, sup)


def _inverse_dir(rd):
    return 1.0 / torch.where(rd == 0.0, TINY_DIR, rd)


def check_group(group: int) -> None:
    """Rays per work list: a power of two from one warp to 1,024."""
    if not (WARP <= group <= 1024 and group & (group - 1) == 0):
        raise ValueError(f"group={group}: a power of two in [{WARP}, 1024]")


def _precull_groups(ro, rd, tmin, tmax, sbbox, group):
    """Rays of whole groups -> (order [ng, S] i32, cnt [ng] i32)."""
    ng = ro.shape[0] // group
    s = sbbox.shape[0]
    o = ro[:, None, :]
    di = _inverse_dir(rd)[:, None, :]
    t0 = (sbbox[None, :, 0:3] - o) * di
    t1 = (sbbox[None, :, 3:6] - o) * di
    enter = torch.minimum(t0, t1).amax(dim=-1)
    exit_ = torch.maximum(t0, t1).amin(dim=-1)
    enter = torch.maximum(enter, tmin[:, None])
    exit_ = torch.minimum(exit_, tmax[:, None])
    ray_hit = enter <= exit_ * SLACK  # [rays, S]
    grp_hit = ray_hit.view(ng, group, s).any(dim=1)
    enter_m = torch.where(ray_hit, enter.clamp(min=0.0), float("inf"))
    grp_enter = enter_m.view(ng, group, s).amin(dim=1)
    key = torch.where(grp_hit, grp_enter, float("inf"))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    cnt = grp_hit.sum(dim=1, dtype=torch.int32)
    return order, cnt


def pad_rays(ro, rd, tmin, tmax, group):
    """Rays padded to whole groups (at least one) with zeros (tmin = tmax
    = 0), as the JAX package pads them; a padding ray never hits."""
    n = ro.shape[0]
    pad = max(1, -(-n // group)) * group - n
    if pad:
        ro = torch.nn.functional.pad(ro, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rd, (0, 0, 0, pad))
        tmin = torch.nn.functional.pad(tmin, (0, pad))
        tmax = torch.nn.functional.pad(tmax, (0, pad))
    return ro, rd, tmin, tmax


def precull(ro, rd, tmin, tmax, sbbox, group: int = GROUP_RAYS):
    """Front-to-back supercluster work list of each group of `group`
    rays: (order [ng, S] i32, cnt [ng] i32), on the rays' device."""
    check_group(group)
    ro, rd, tmin, tmax = pad_rays(ro, rd, tmin, tmax, group)
    ng = ro.shape[0] // group
    s = sbbox.shape[0]
    chunk = max(1, int(PRECULL_BYTES // (group * s * 4)))
    if chunk >= ng:
        return _precull_groups(ro, rd, tmin, tmax, sbbox, group)
    parts = [
        _precull_groups(*(x[g0 * group:(g0 + chunk) * group]
                          for x in (ro, rd, tmin, tmax)), sbbox, group)
        for g0 in range(0, ng, chunk)
    ]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _cluster_cull(o, inv, tmin, tlim, box):
    """[m] rays against [m] boxes: cluster_cull of the .cu file."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    exit_ = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    enter = torch.maximum(enter, tmin)
    exit_ = torch.minimum(exit_, tlim)
    return enter <= exit_ * SLACK


def cull_all(o, inv, tmin, tlim, boxes):
    """[n] rays against their [n, k] boxes: cluster_cull for every box of
    each ray at once -> [n, k]."""
    t0 = (boxes[..., 0:3] - o[:, None]) * inv[:, None]
    t1 = (boxes[..., 3:6] - o[:, None]) * inv[:, None]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    exit_ = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    enter = torch.maximum(enter, tmin[:, None])
    exit_ = torch.minimum(exit_, tlim[:, None])
    return enter <= exit_ * SLACK


def _tri_tests(o, d, tmin, best, c):
    """[m] rays against their [m] clusters' 128 triangles (c: [m, 16, 128]):
    tri_test of the .cu file -> (hit, t, u, v), each [m, 128]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    opx = ((c[:, 0] * ox + c[:, 1] * oy) + c[:, 2] * oz) + c[:, 9]
    opy = ((c[:, 3] * ox + c[:, 4] * oy) + c[:, 5] * oz) + c[:, 10]
    opz = ((c[:, 6] * ox + c[:, 7] * oy) + c[:, 8] * oz) + c[:, 11]
    dpx = (c[:, 0] * dx + c[:, 1] * dy) + c[:, 2] * dz
    dpy = (c[:, 3] * dx + c[:, 4] * dy) + c[:, 5] * dz
    dpz = (c[:, 6] * dx + c[:, 7] * dy) + c[:, 8] * dz
    t = -opz / torch.where(dpz == 0.0, TINY_DIR, dpz)
    u = opx + t * dpx
    v = opy + t * dpy
    hit = ((dpz != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= tmin[:, None]) & (t < best[:, None]))
    return hit, t, u, v


def _closest_tri(o, d, tmin, best, c):
    """[m] rays against their [m] cluster tables c ([m, 16, 128], or
    [1, 16, 128] for one table): closest_tri of the .cu files ->
    (found [m], arg [m] i64, t, u, v): the first minimum of the hits
    closer than best, u and v flipped on odd triangles."""
    hit, t, u, v = _tri_tests(o, d, tmin, best, c)
    arg = torch.argmin(torch.where(hit, t, float("inf")), dim=1,
                       keepdim=True)  # first minimum
    found = hit.gather(1, arg)[:, 0]
    odd = (arg[:, 0] % 2) == 1
    u = u.gather(1, arg)[:, 0]
    v = v.gather(1, arg)[:, 0]
    return (found, arg[:, 0], t.gather(1, arg)[:, 0],
            torch.where(odd, 1.0 - u, u), torch.where(odd, 1.0 - v, v))


def real_tris(c):
    """Cluster tables [..., 16, 128] -> [...] their real triangles: those
    with a unit normal row (padding and degenerate triangles carry the
    never-hit transform, whose rows 6-8 are zero)."""
    return (c[..., 6:9, :] != 0).any(dim=-2).sum(dim=-1)


def _finish(tables, ro, rd, tmax, best, best_tri, bu, bv, bn, binst) -> Hit:
    prim = torch.where(best_tri >= 0, best_tri // 2, -1)
    prim = torch.where(prim >= tables.n_prims, -1, prim).to(torch.int32)
    hit = prim >= 0
    t = torch.where(hit, best, tmax)
    pos = ro + t[:, None] * rd
    return Hit(hit, prim, bu, bv, t, pos, bn, (binst + 0.5).to(torch.int32))


def worklist_intersect_plain(tables: WorklistTables, ro, rd, tmin, tmax,
                             order, cnt,
                             group: int = GROUP_RAYS) -> tuple[Hit, dict]:
    """Plain PyTorch version of the kernel -> (Hit, work). Vectorised over
    rays, one step per (list position, cluster index); reads counts back
    to the host. work counts the (ray, cluster) pairs that passed the cull
    (`pairs`) and what the kernel pays for them: the warps that walk
    (`groups`), the (warp, supercluster) steps (`steps`), the steps in
    which a ray enters the supercluster's box against its running best,
    each one mask vote (`votes`; the others are skipped after one vote),
    the (warp, cluster) pairs with a ray that wants the cluster, each one
    table load (`warp_pairs`), and the real (not padding) triangles of
    the pairs' clusters (`tri_slots`: over pairs x 128, the share of the
    triangle loop's lane slots that test a real triangle)."""
    check_group(group)
    n = ro.shape[0]
    dev = ro.device
    sup = tables.sup
    lane = torch.arange(n, device=dev)
    row, warp = lane // group, lane // WARP
    nw = -(-n // WARP)
    warp_cnt = cnt[torch.arange(nw, device=dev) * WARP // group]
    inv = _inverse_dir(rd)
    ray_cnt = cnt[row]
    best = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    bn = torch.zeros((n, 3), device=dev)
    binst = torch.zeros(n, device=dev)
    work = dict(pairs=0, warp_pairs=0, tri_slots=0,
                groups=int((warp_cnt > 0).sum()), steps=int(warp_cnt.sum()),
                votes=0)
    steps = int(cnt.max()) if n else 0
    for k in range(steps):
        listed = k < ray_cnt
        sc = order[row, k].to(torch.int64)
        enter = listed & _cluster_cull(ro, inv, tmin, torch.minimum(tmax, best),
                                       tables.sbbox[sc])
        work["votes"] += torch.unique(warp[enter]).numel()
        for ci in range(sup):
            cl = sc * sup + ci
            want = listed & _cluster_cull(ro, inv, tmin,
                                          torch.minimum(tmax, best),
                                          tables.bbox[cl])
            idx = torch.nonzero(want).squeeze(1)
            if idx.numel() == 0:
                continue
            work["pairs"] += idx.numel()
            work["warp_pairs"] += torch.unique_consecutive(idx // WARP).numel()
            c = tables.tab[cl[idx]]
            work["tri_slots"] += int(real_tris(c).sum())
            found, arg, t, u, v = _closest_tri(ro[idx], rd[idx], tmin[idx],
                                               best[idx], c)
            sel = idx[found]
            arg = arg[found]
            best[sel] = t[found]
            bu[sel] = u[found]
            bv[sel] = v[found]
            attrs = c[found].gather(2, arg[:, None, None].expand(-1, ROWS, 1))[..., 0]
            bn[sel] = attrs[:, 12:15]
            binst[sel] = attrs[:, 15]
            best_tri[sel] = cl[sel] * TRIS + arg
    return _finish(tables, ro, rd, tmax, best, best_tri, bu, bv, bn, binst), work


def _check(x, dtype, shape, device, name):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def worklist_intersect_kernel(tables: WorklistTables, ro, rd, tmin, tmax,
                              order, cnt, group: int = GROUP_RAYS) -> Hit:
    """Launch csrc/worklist_intersect.cu on CUDA tensors (raises
    otherwise): rays ro/rd [N, 3], tmin/tmax [N]; the work lists of
    `group` rays from precull."""
    if ro.device.type != "cuda":
        raise ValueError(f"worklist_intersect_kernel: {ro.device} is not a "
                         "CUDA device")
    check_group(group)
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    c_total, s, sup = tables.tab.shape[0], tables.sbbox.shape[0], tables.sup
    ng = max(1, -(-n // group))
    _check(ro, f32, (n, 3), dev, "ro")
    _check(rd, f32, (n, 3), dev, "rd")
    _check(tmin, f32, (n,), dev, "tmin")
    _check(tmax, f32, (n,), dev, "tmax")
    _check(tables.tab, f32, (s * sup, ROWS, TRIS), dev, "tab")
    _check(tables.bbox, f32, (c_total, 8), dev, "bbox")
    _check(tables.sbbox, f32, (s, 8), dev, "sbbox")
    _check(order, i32, (ng, s), dev, "order")
    _check(cnt, i32, (ng,), dev, "cnt")
    lib = _lib()
    prim = torch.empty(n, dtype=i32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    t = torch.empty(n, dtype=f32, device=dev)
    pos = torch.empty((n, 3), dtype=f32, device=dev)
    nrm = torch.empty((n, 3), dtype=f32, device=dev)
    inst = torch.empty(n, dtype=i32, device=dev)
    err = lib.worklist_intersect_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        tables.tab.data_ptr(), tables.bbox.data_ptr(),
        tables.sbbox.data_ptr(), order.data_ptr(), cnt.data_ptr(), s, sup,
        group, tables.n_prims, prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), t.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(), inst.data_ptr(), cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, "worklist_intersect")
    if n:  # the launcher launches nothing for no rays
        worklist_intersect_kernel.launches += 1
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


timing.counter(worklist_intersect_kernel, "launches")

FLAGS = ("-fmad=false",)


def _lib():
    lib = cuda_build.load("worklist_intersect", FLAGS)
    fn = lib.worklist_intersect_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, i,
                       p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def list_entries(cnt, group: int, n: int, boxes_per_entry: int = 1):
    """Every (ray, list position) of n rays whose lists (groups of `group`
    rays, cnt [groups] entries each) hold it, as (ray [m] i64, position
    [m] i64) blocks of whole groups of about COUNT_TESTS /
    boxes_per_entry entries (one host read of the counts)."""
    if n == 0:
        return
    dev = cnt.device
    ray_cnt = cnt.long()[torch.arange(n, device=dev) // group]
    ends = torch.cumsum(ray_cnt, 0)
    n_groups = -(-n // group)
    last = torch.clamp(torch.arange(1, n_groups + 1, device=dev) * group,
                       max=n) - 1
    group_ends = ends[last].cpu().numpy()
    step = max(1, COUNT_TESTS // boxes_per_entry)
    g0, done = 0, 0
    while g0 < n_groups:
        g1 = max(g0 + 1, int(np.searchsorted(group_ends, done + step, "right")))
        r0, r1 = g0 * group, min(g1 * group, n)
        rc = ray_cnt[r0:r1]
        ray = torch.repeat_interleave(torch.arange(r0, r1, device=dev), rc)
        first = torch.repeat_interleave(torch.cumsum(rc, 0) - rc, rc)
        yield ray, torch.arange(ray.shape[0], device=dev) - first
        g0, done = g1, int(group_ends[g1 - 1])


def needed_pairs(tables: WorklistTables, ro, rd, tmin, t_hit, order, cnt,
                 group: int = GROUP_RAYS) -> tuple[int, int]:
    """(pairs, clusters): the (ray, cluster) pairs of the rays' work lists
    whose box the ray enters before its closest hit t_hit (the hit's t,
    tmax for a miss), and the distinct clusters among them. Every correct
    walk over these lists tests at least these pairs: the least work the
    call needs (the kernel's walk against its running best tests more,
    worklist_intersect_plain's `pairs`)."""
    dev, sup = ro.device, tables.sup
    inv = _inverse_dir(rd)
    boxes = tables.bbox.view(-1, sup, 8)
    touched = torch.zeros(boxes.shape[0] * sup, dtype=torch.bool, device=dev)
    cl_of = torch.arange(sup, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for r, k in list_entries(cnt, group, ro.shape[0], sup):
        sc = order[r // group, k].long()
        want = cull_all(ro[r], inv[r], tmin[r], t_hit[r], boxes[sc])
        pairs += want.sum()
        touched[(sc[:, None] * sup + cl_of)[want]] = True
    return int(pairs), int(touched.sum())


def call_cost(tables: WorklistTables, ro, rd, tmin, t_hit, order, cnt,
              group: int = GROUP_RAYS) -> dict:
    """kernel_flops.worklist_intersect_cost of one call: the pairs it
    needs (needed_pairs), the tables and the lists."""
    pairs, _ = needed_pairs(tables, ro, rd, tmin, t_hit, order, cnt, group)
    table_bytes = (tables.tab.numel() + tables.bbox.numel()
                   + tables.sbbox.numel()) * 4
    return kf.worklist_intersect_cost(
        ro.shape[0], table_bytes, (order.numel() + cnt.numel()) * 4, pairs)


def worklist_intersect(tables: WorklistTables, ro, rd, tmin, tmax) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] over the packed
    tables: precull (work lists per GROUP_RAYS rays), then the plain
    version for CPU tensors and the CUDA kernel for CUDA tensors; under
    roofline.count_cost the walk reports call_cost. A `worklist` span
    (utils/timing.py device_span, `rays=`) covers the precull and the
    walk."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"worklist_intersect: unsupported device {ro.device}")
    with timing.device_span("worklist", ro.device, rays=ro.shape[0]):
        order, cnt = precull(ro, rd, tmin, tmax, tables.sbbox)
        with roofline.kernel_region() as counter:
            if ro.device.type == "cpu":
                hit = worklist_intersect_plain(tables, ro, rd, tmin, tmax,
                                               order, cnt)[0]
            else:
                hit = worklist_intersect_kernel(tables, ro, rd, tmin, tmax,
                                                order, cnt)
            if counter is not None:
                counter.add_kernel("worklist_intersect", call_cost(
                    tables, ro, rd, tmin, hit.t, order, cnt))
    return hit


def make_worklist_intersect(prim_verts: np.ndarray, prim_instance, device,
                            sup: int = WL_SUPER, cache_key: str = ""):
    """The Intersector over a fixed quad soup, on `device` (the cluster
    tables, `tables`, through the disk cache under `cache_key`)."""
    tables = pack_tables(prim_verts, prim_instance, sup, device, cache_key)

    def intersect(ro, rd, tmin, tmax):
        return worklist_intersect(tables, ro, rd, tmin, tmax)

    return Intersector(intersect, tables=tables)
