"""Worklist cluster intersector for scenes of 113 to ~150k quads: the
table packing, the precull, the wrapper of csrc/worklist_intersect.cu and
its plain PyTorch version.

Replaces make_cluster_intersect_worklist and its Pallas TPU kernel
_make_kernel_worklist (julia_raytracer_tpu/ops/pallas_cluster.py).

  pack_tables: cluster tables (ops/cluster_tables.py) padded to S
    superclusters of `sup` clusters, packed as tab [S*sup, 16, 128]
    (transform rows 0-11, normal rows 12-14, instance row 15), bbox
    [S*sup, 8] and supercluster boxes sbbox [S, 8].
  precull: per 1024-ray block, the superclusters its rays enter, front to
    back by the block's nearest entry (a stable sort: rays that start
    inside several boxes tie at 0), and their count. Plain tensor code on
    the rays' device; nothing is read back to the host. Rays are padded to
    a multiple of 1024 with zeros (tmin = tmax = 0), as the JAX package
    pads them; a padding ray never hits.
  worklist_intersect_kernel / worklist_intersect_plain: walk each block's
    list (superclusters in order, clusters in index order), cull each ray
    against each cluster box with its running best t, and test the 128
    triangles of a cluster it wants in index order with a strict `<`. The
    two compute the same function in the same order and agree bit for bit
    on the card. The plain version also counts the (ray, cluster) pairs
    that pass the cull, the work that bounds the kernel, and the (warp,
    cluster) and (block, cluster) pairs the kernel pays for.

`worklist_intersect` runs the precull, then the plain version for CPU
tensors and the kernel for CUDA tensors (or raises).
`worklist_intersect_kernel.launches` counts the kernel's launches.

Differences from the JAX function, none of which changes a hit: the
TPU's bf16 `split3` matmul workaround is not carried over (the port
computes in fp32, the JAX package's `highest` mode off the TPU); the cull
is per ray rather than per 128-lane row; a cluster without a hit never
updates a ray's record (the TPU kernel's argmin over a hitless row could,
for tmax = +inf); and the `JRT_WL_SUP` / `JRT_WL_FLAT` environment knobs
are gone (`sup` is an argument).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops.cluster_tables import (
    TRIS, WL_SUPER, _wl_super_bbox, build_cluster_tables,
)
from julia_raytracer_tpu_torch.ops.traversal import Hit

BLOCK_RAYS = 1024
ROWS = 16  # table rows per cluster
MAX_SUP = 128  # the kernel's shared-memory box array
SLACK = 1.00000024  # box-test slack of the TPU kernel (2 ulp at 1.0)
TINY_DIR = 1e-30  # stands in for a zero direction component
# [rays, S] precull temporaries above this many bytes are cut into chunks
PRECULL_BYTES = 200e6
# fp32 arithmetic of one triangle test, counted from tri_test in the .cu
# (18 for o', 15 for d', negate and divide for t, 4 for u and v, 1 for
# u + v; compares and selects not counted)
OPS_PER_TRI_TEST = 40


class WorklistTables(NamedTuple):
    tab: torch.Tensor  # f32 [S*sup, 16, 128]
    bbox: torch.Tensor  # f32 [S*sup, 8]
    sbbox: torch.Tensor  # f32 [S, 8]
    n_prims: int
    sup: int


def pack_tables(prim_verts: np.ndarray, prim_instance=None,
                sup: int = WL_SUPER, device="cpu") -> WorklistTables:
    """[Q, 4, 3] quads in BVH order (+ [Q] instance ids) -> the packed
    tables on `device` (the JAX function's lines 1099-1131)."""
    if not (1 <= sup <= MAX_SUP and (sup <= 8 or sup % 8 == 0)):
        raise ValueError(f"sup={sup}: must be <= 8 or a multiple of 8, "
                         f"at most {MAX_SUP}")
    q = len(prim_verts)
    tfm, nrm, bbox, n_clusters = build_cluster_tables(
        np.asarray(prim_verts, np.float64), prim_instance
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


def _precull_blocks(ro, rd, tmin, tmax, sbbox):
    """Rays of whole blocks -> (order [nb, S] i32, cnt [nb] i32)."""
    nb = ro.shape[0] // BLOCK_RAYS
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
    blk_hit = ray_hit.view(nb, BLOCK_RAYS, s).any(dim=1)
    enter_m = torch.where(ray_hit, enter.clamp(min=0.0), float("inf"))
    blk_enter = enter_m.view(nb, BLOCK_RAYS, s).amin(dim=1)
    key = torch.where(blk_hit, blk_enter, float("inf"))
    order = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    cnt = blk_hit.sum(dim=1, dtype=torch.int32)
    return order, cnt


def precull(ro, rd, tmin, tmax, sbbox):
    """Front-to-back supercluster work list of each 1024-ray block:
    (order [nb, S] i32, cnt [nb] i32), on the rays' device."""
    n = ro.shape[0]
    nb = max(1, -(-n // BLOCK_RAYS))
    pad = nb * BLOCK_RAYS - n
    if pad:
        ro = torch.nn.functional.pad(ro, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rd, (0, 0, 0, pad))
        tmin = torch.nn.functional.pad(tmin, (0, pad))
        tmax = torch.nn.functional.pad(tmax, (0, pad))
    s = sbbox.shape[0]
    chunk = max(1, int(PRECULL_BYTES // (BLOCK_RAYS * s * 4)))
    if chunk >= nb:
        return _precull_blocks(ro, rd, tmin, tmax, sbbox)
    parts = [
        _precull_blocks(*(x[b0 * BLOCK_RAYS:(b0 + chunk) * BLOCK_RAYS]
                          for x in (ro, rd, tmin, tmax)), sbbox)
        for b0 in range(0, nb, chunk)
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


def _finish(tables, ro, rd, tmax, best, best_tri, bu, bv, bn, binst) -> Hit:
    prim = torch.where(best_tri >= 0, best_tri // 2, -1)
    prim = torch.where(prim >= tables.n_prims, -1, prim).to(torch.int32)
    hit = prim >= 0
    t = torch.where(hit, best, tmax)
    pos = ro + t[:, None] * rd
    return Hit(hit, prim, bu, bv, t, pos, bn, (binst + 0.5).to(torch.int32))


def worklist_intersect_plain(tables: WorklistTables, ro, rd, tmin, tmax,
                             order, cnt) -> tuple[Hit, dict]:
    """Plain PyTorch version of the kernel -> (Hit, work), where work
    counts the (ray, cluster) pairs that passed the cull (`pairs`) and
    the (32-ray warp, cluster) and (1024-ray block, cluster) pairs with at
    least one such ray (`warp_pairs`, `block_pairs`: the kernel's
    triangle loops and table loads). Vectorised over rays, one step per
    (list position, cluster index); reads counts back to the host."""
    n = ro.shape[0]
    dev = ro.device
    sup = tables.sup
    blk = torch.arange(n, device=dev) // BLOCK_RAYS
    inv = _inverse_dir(rd)
    ray_cnt = cnt[blk]
    best = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    bn = torch.zeros((n, 3), device=dev)
    binst = torch.zeros(n, device=dev)
    work = dict(pairs=0, warp_pairs=0, block_pairs=0)
    steps = int(cnt.max()) if n else 0
    for k in range(steps):
        listed = k < ray_cnt
        sc = order[blk, k].to(torch.int64)
        for ci in range(sup):
            cl = sc * sup + ci
            want = listed & _cluster_cull(ro, inv, tmin,
                                          torch.minimum(tmax, best),
                                          tables.bbox[cl])
            idx = torch.nonzero(want).squeeze(1)
            if idx.numel() == 0:
                continue
            work["pairs"] += idx.numel()
            work["warp_pairs"] += torch.unique_consecutive(idx // 32).numel()
            work["block_pairs"] += torch.unique_consecutive(
                idx // BLOCK_RAYS).numel()
            c = tables.tab[cl[idx]]
            hit, t, u, v = _tri_tests(ro[idx], rd[idx], tmin[idx], best[idx], c)
            arg = torch.argmin(torch.where(hit, t, float("inf")), dim=1,
                               keepdim=True)  # first minimum
            found = hit.gather(1, arg)[:, 0]
            sel = idx[found]
            arg = arg[found]
            odd = (arg[:, 0] % 2) == 1
            u = u[found].gather(1, arg)[:, 0]
            v = v[found].gather(1, arg)[:, 0]
            best[sel] = t[found].gather(1, arg)[:, 0]
            bu[sel] = torch.where(odd, 1.0 - u, u)
            bv[sel] = torch.where(odd, 1.0 - v, v)
            attrs = c[found].gather(2, arg[:, None, :].expand(-1, ROWS, 1))[..., 0]
            bn[sel] = attrs[:, 12:15]
            binst[sel] = attrs[:, 15]
            best_tri[sel] = cl[sel] * TRIS + arg[:, 0]
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
                              order, cnt) -> Hit:
    """Launch csrc/worklist_intersect.cu on CUDA tensors (raises
    otherwise): rays ro/rd [N, 3], tmin/tmax [N]; the work list from
    precull."""
    if ro.device.type != "cuda":
        raise ValueError(f"worklist_intersect_kernel: {ro.device} is not a "
                         "CUDA device")
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    c_total, s, sup = tables.tab.shape[0], tables.sbbox.shape[0], tables.sup
    nb = max(1, -(-n // BLOCK_RAYS))
    _check(ro, f32, (n, 3), dev, "ro")
    _check(rd, f32, (n, 3), dev, "rd")
    _check(tmin, f32, (n,), dev, "tmin")
    _check(tmax, f32, (n,), dev, "tmax")
    _check(tables.tab, f32, (s * sup, ROWS, TRIS), dev, "tab")
    _check(tables.bbox, f32, (c_total, 8), dev, "bbox")
    _check(order, i32, (nb, s), dev, "order")
    _check(cnt, i32, (nb,), dev, "cnt")
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
        tables.tab.data_ptr(), tables.bbox.data_ptr(), order.data_ptr(),
        cnt.data_ptr(), s, sup, tables.n_prims, prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), t.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(), inst.data_ptr(), cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, "worklist_intersect")
    if n:  # the launcher launches nothing for no rays
        worklist_intersect_kernel.launches += 1
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


worklist_intersect_kernel.launches = 0

FLAGS = ("-fmad=false",)


def _lib():
    lib = cuda_build.load("worklist_intersect", FLAGS)
    fn = lib.worklist_intersect_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i,
                       p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def worklist_intersect(tables: WorklistTables, ro, rd, tmin, tmax) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] over the packed
    tables: precull, then the plain version for CPU tensors and the CUDA
    kernel for CUDA tensors."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"worklist_intersect: unsupported device {ro.device}")
    order, cnt = precull(ro, rd, tmin, tmax, tables.sbbox)
    if ro.device.type == "cpu":
        return worklist_intersect_plain(tables, ro, rd, tmin, tmax, order, cnt)[0]
    return worklist_intersect_kernel(tables, ro, rd, tmin, tmax, order, cnt)


def make_worklist_intersect(prim_verts: np.ndarray, prim_instance, device,
                            sup: int = WL_SUPER):
    """intersect(ro, rd, tmin, tmax) -> Hit over a fixed quad soup, on
    `device`."""
    tables = pack_tables(prim_verts, prim_instance, sup, device)

    def intersect(ro, rd, tmin, tmax):
        return worklist_intersect(tables, ro, rd, tmin, tmax)

    intersect.tables = tables
    return intersect
