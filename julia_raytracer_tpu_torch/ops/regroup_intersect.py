"""Regroup cluster intersector for heavy scenes (>= 150,000 quads): the
count stage, the merge, the wrappers of the three kernels of
csrc/regroup_intersect.cu and their plain PyTorch versions.

Replaces make_cluster_intersect_regroup and its Pallas TPU kernels
_make_pack_kernel, _make_tritest_kernel and _make_unpack_kernel
(julia_raytracer_tpu/ops/pallas_regroup.py).

The worklist kernel (ops/worklist_intersect.py) tests a 1024-ray block
against the union of its rays' superclusters; divergent bounce rays make
that union far larger than any one ray's. Regroup inverts the loop. Per
chunk of `chunk_blocks` 1024-ray tiles:

  count (plain PyTorch): slab-test every ray against every supercluster
    box -> bits [T, S, 1024] (bool), the set bits per (tile, super) and
    per super, each super's segment of packed slots padded to whole
    1024-slot groups, the slot of each (tile, super) pair's first ray,
    and the group -> super map. One host read per chunk (the group count
    and the live rays) decides between regroup and the worklist fallback.
  regroup_pack (kernel): each set bit's ray payload (ox oy oz dx dy dz
    tmin tmax) to its slot, stable by (super, tile, lane).
  regroup_tritest (kernel): each group of 1024 slots against its super's
    128 clusters -> per slot (tri, t).
  regroup_unpack (kernel): per ray, the (tri, t) of its slots merged over
    the supers in index order -> (tri, t).
  merge (plain PyTorch): the winner's u, v, normal and instance
    recomputed from its triangle's transform row -> Hit.

Fallback: a chunk whose packed rows exceed the capacity (`blk_cap`
128-slot blocks, less the JAX package's per-segment slack of 8 blocks,
so the same `blk_cap` falls back at the same counts) or whose share of
live rays (tmax > 0) is under `livegate` goes to the worklist kernel
over the same tables: the JAX package's own rule (pallas_regroup.py:
613-627, :923-929), a lax.cond there and one host read here.
`regroup_intersect.host_syncs` counts those reads and
`regroup_intersect.fallbacks` the chunks that fell back.

Differences from the JAX function, none of which changes a hit: the tri
test culls per slot rather than per 128-slot row, and in fp32 (no bf16
split3); segments carry no slack; the `JRT_RG_*` environment knobs are
arguments, and the uv-fast test (`JRT_RG_UVFAST`, not winner-exact) is
not ported. Across superclusters an exact t tie may pick another prim
than the worklist kernel's front-to-back walk: hold the two to
testing.check_hits, not bit equality.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.cluster_tables import TRIS
from julia_raytracer_tpu_torch.ops.traversal import Hit

TILE = 1024  # rays per tile = slots per tri-test group
LANES = 128
GRP = 8  # 128-slot rows per group
PAYLOAD = 8  # ox oy oz dx dy dz tmin tmax
# the JAX package's defaults (pallas_regroup.py:83-84, :626)
DEF_BLK_CAP = 49152
DEF_CHUNK_BLOCKS = 288
DEF_LIVEGATE = 0.45
# slots culled and (slot, cluster) pairs tested per step of the plain
# tri-test: bound its [slots, 128] cull and [pairs, 16, 128] table gather
PLAIN_SLOTS = 1 << 15
PLAIN_PAIRS = 1 << 15


class Plan(NamedTuple):
    """The count stage's output for one chunk of T tiles."""

    bits: torch.Tensor  # bool [T, S, 1024]
    cnt_ts: torch.Tensor  # i32 [T, S]
    base_ts: torch.Tensor  # i32 [T, S] slot of the pair's first ray
    seg_base: torch.Tensor  # i32 [S]
    cnt_s: torch.Tensor  # i32 [S]
    groups_s: torch.Tensor  # i32 [S] 1024-slot groups of each segment


def count_stage(rays8: torch.Tensor, sbbox: torch.Tensor) -> Plan:
    """rays8 [T * 1024, 8] (dead and padding rays at tmax < 0) against the
    supercluster boxes sbbox [S, 8], in the kernels' [T, S, 1024] layout
    (JAX :753-818). Nothing is read back to the host."""
    nb = rays8.shape[0] // TILE
    r = rays8.view(nb, 1, TILE, PAYLOAD)
    box = sbbox[None, :, None, :]
    enter = exit_ = None
    for ax in range(3):
        d = r[..., 3 + ax]
        di = 1.0 / torch.where(d == 0.0, wl.TINY_DIR, d)
        t0 = (box[..., ax] - r[..., ax]) * di
        t1 = (box[..., 3 + ax] - r[..., ax]) * di
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        enter = lo if enter is None else torch.maximum(enter, lo)
        exit_ = hi if exit_ is None else torch.minimum(exit_, hi)
    enter = torch.maximum(enter, r[..., 6])
    exit_ = torch.minimum(exit_, r[..., 7])
    bits = enter <= exit_ * wl.SLACK  # [T, S, 1024]
    i32 = torch.int32
    cnt_ts = bits.sum(dim=-1, dtype=i32)
    cnt_s = cnt_ts.sum(dim=0, dtype=i32)
    groups_s = (cnt_s + (TILE - 1)) // TILE
    seg_base = (torch.cumsum(groups_s, 0, dtype=i32) - groups_s) * TILE
    base_ts = seg_base[None, :] + torch.cumsum(cnt_ts, 0, dtype=i32) - cnt_ts
    return Plan(bits, cnt_ts, base_ts.contiguous(), seg_base, cnt_s, groups_s)


def _ranks(bits):
    """Exclusive rank of each set lane among its (tile, super)'s set
    lanes, [T, S, 1024] i32 (what the kernels' ballot/popc scan gives)."""
    return torch.cumsum(bits, dim=-1, dtype=torch.int32) - 1


def regroup_pack_plain(plan: Plan, rays8, n_slots: int):
    """Plain version of the pack kernel -> packed [n_slots, 8] f32."""
    out = torch.zeros((n_slots, PAYLOAD), dtype=torch.float32,
                      device=rays8.device)
    out[:, 7] = -1.0
    t, s, lane = torch.nonzero(plan.bits, as_tuple=True)
    slot = plan.base_ts[t, s] + _ranks(plan.bits)[t, s, lane]
    out[slot.long()] = rays8[t * TILE + lane]
    return out


def regroup_tritest_plain(packed, tables: wl.WorklistTables, grp_super):
    """Plain version of the tri-test kernel -> (out [slots, 2] i32, work),
    where work counts the (slot, cluster) pairs that pass the cull
    (`passes`, each 128 triangle tests), the (group, cluster) pairs with
    at least one (`group_passes`: the kernel's table loads) and the
    distinct clusters among them (`clusters`).

    The kernel culls with the slot's tmax, never its running best, so the
    clusters a slot tests do not depend on what it has hit, and its
    in-order scan with a strict `<` keeps the first (cluster, triangle) of
    least t among them. This version computes that first minimum directly:
    every culled (slot, cluster) pair's 128 tests against tmax, each
    pair's first minimum, then per slot the least t and, among the pairs
    that reach it, the least triangle id. Each t is the kernel's own
    arithmetic, so the two agree bit for bit."""
    dev = packed.device
    sup = tables.sup
    n = packed.shape[0]
    o, d = packed[:, 0:3], packed[:, 3:6]
    tmin, tmax = packed[:, 6], packed[:, 7]
    inv = wl._inverse_dir(d)
    sc = grp_super.long().repeat_interleave(TILE)
    boxes = tables.bbox.view(-1, sup, 8)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    pair_slot, pair_ci = [none], [none]
    for lo in range(0, n, PLAIN_SLOTS):  # the cull, [slots, sup] at a time
        sl = slice(lo, min(lo + PLAIN_SLOTS, n))
        m = sl.stop - lo

        def rep(x):
            return x[sl, None].expand((m, sup) + x.shape[1:]).reshape((m * sup,) + x.shape[1:])

        want = wl._cluster_cull(rep(o), rep(inv), rep(tmin), rep(tmax),
                                boxes[sc[sl]].reshape(-1, 8)).view(m, sup)
        slot, ci = torch.nonzero(want, as_tuple=True)
        pair_slot.append(slot + lo)
        pair_ci.append(ci)
    slot_p, ci_p = torch.cat(pair_slot), torch.cat(pair_ci)
    cl_p = sc[slot_p] * sup + ci_p
    t_pair = torch.empty(slot_p.shape[0], device=dev)
    tri_pair = torch.empty(slot_p.shape[0], dtype=torch.int64, device=dev)
    for lo in range(0, slot_p.shape[0], PLAIN_PAIRS):  # the tri tests
        k = slice(lo, lo + PLAIN_PAIRS)
        sp = slot_p[k]
        hit, t, _, _ = wl._tri_tests(o[sp], d[sp], tmin[sp], tmax[sp],
                                     tables.tab[cl_p[k]])
        t = torch.where(hit, t, float("inf"))
        arg = torch.argmin(t, dim=1, keepdim=True)  # first minimum
        t_pair[k] = t.gather(1, arg)[:, 0]
        tri_pair[k] = cl_p[k] * TRIS + arg[:, 0]
    best = tmax.clone()
    best.scatter_reduce_(0, slot_p, t_pair, "amin")
    won = t_pair == best[slot_p]  # a hit is < tmax, so tmax never ties
    no_tri = torch.iinfo(torch.int64).max
    best_tri = torch.full((n,), no_tri, dtype=torch.int64, device=dev)
    best_tri.scatter_reduce_(0, slot_p[won], tri_pair[won], "amin")
    best_tri = torch.where(best_tri == no_tri, -1, best_tri)
    valid = (best_tri >= 0) & (best_tri < 2 * tables.n_prims)
    tri = torch.where(valid, best_tri, -1).to(torch.int32)
    t = torch.where(valid, best, tmax)
    work = dict(passes=slot_p.numel(),
                group_passes=torch.unique((slot_p // TILE) * sup + ci_p).numel(),
                clusters=torch.unique(cl_p).numel())
    return torch.stack([tri, t.view(torch.int32)], dim=1), work


def regroup_unpack_plain(plan: Plan, trires):
    """Plain version of the unpack kernel -> [T * 1024, 2] i32 (tri, t
    bits): per ray, supers in index order, merged where t > 0 and t <
    best."""
    nb, n_super, _ = plan.bits.shape
    dev = plan.bits.device
    best = torch.full((nb, TILE), float("inf"), device=dev)
    best_tri = torch.full((nb, TILE), -1, dtype=torch.int32, device=dev)
    if trires.shape[0]:
        tri_all, t_all = trires[:, 0], trires[:, 1].view(torch.float32)
        ranks = _ranks(plan.bits)
        for s in range(n_super):
            b = plan.bits[:, s]
            slot = torch.where(b, plan.base_ts[:, s:s + 1] + ranks[:, s], 0).long()
            tt = t_all[slot]
            upd = b & (tt > 0.0) & (tt < best)
            best = torch.where(upd, tt, best)
            best_tri = torch.where(upd, tri_all[slot], best_tri)
    return torch.stack([best_tri, best.view(torch.int32)], dim=-1).view(-1, 2)


def _require_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: {x.device} is not a CUDA device")


def _check(x, dtype, shape, device, name):
    wl._check(x, dtype, shape, device, name)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def regroup_pack(plan: Plan, rays8, n_slots: int):
    """Pack kernel on CUDA tensors, its plain version on CPU tensors (any
    other device raises) -> packed [n_slots, 8] f32. `n_slots` must be the
    plan's segment total (1024 x its groups)."""
    if rays8.device.type == "cpu":
        return regroup_pack_plain(plan, rays8, n_slots)
    _require_cuda(rays8, "regroup_pack")
    nb, n_super, _ = plan.bits.shape
    dev, i32 = rays8.device, torch.int32
    _check(plan.bits, torch.bool, (nb, n_super, TILE), dev, "bits")
    _check(rays8, torch.float32, (nb * TILE, PAYLOAD), dev, "rays")
    _check(plan.cnt_ts, i32, (nb, n_super), dev, "cnt_ts")
    _check(plan.base_ts, i32, (nb, n_super), dev, "base_ts")
    _check(plan.seg_base, i32, (n_super,), dev, "seg_base")
    _check(plan.cnt_s, i32, (n_super,), dev, "cnt_s")
    out = torch.empty((n_slots, PAYLOAD), dtype=torch.float32, device=dev)
    if nb == 0 or n_slots == 0:
        return out
    err = _lib().regroup_pack_launch(
        plan.bits.data_ptr(), rays8.data_ptr(), plan.cnt_ts.data_ptr(),
        plan.base_ts.data_ptr(), plan.seg_base.data_ptr(),
        plan.cnt_s.data_ptr(), nb, n_super, out.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(err, "regroup_pack")
    regroup_pack.launches += 1
    return out


def regroup_tritest(packed, tables: wl.WorklistTables, grp_super):
    """Tri-test kernel on CUDA tensors, its plain version on CPU tensors
    -> [slots, 2] i32 (tri, t bits)."""
    if packed.device.type == "cpu":
        return regroup_tritest_plain(packed, tables, grp_super)[0]
    _require_cuda(packed, "regroup_tritest")
    groups, dev = grp_super.shape[0], packed.device
    c_total, sup = tables.tab.shape[0], tables.sup
    _check(packed, torch.float32, (groups * TILE, PAYLOAD), dev, "packed")
    _check(grp_super, torch.int32, (groups,), dev, "grp_super")
    _check(tables.tab, torch.float32, (c_total, wl.ROWS, TRIS), dev, "tab")
    _check(tables.bbox, torch.float32, (c_total, 8), dev, "bbox")
    out = torch.empty((groups * TILE, 2), dtype=torch.int32, device=dev)
    if groups == 0:
        return out
    err = _lib().regroup_tritest_launch(
        packed.data_ptr(), tables.tab.data_ptr(), tables.bbox.data_ptr(),
        grp_super.data_ptr(), groups, sup, tables.n_prims, out.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(err, "regroup_tritest")
    regroup_tritest.launches += 1
    return out


def regroup_unpack(plan: Plan, trires):
    """Unpack kernel on CUDA tensors, its plain version on CPU tensors ->
    [T * 1024, 2] i32 (tri, t bits)."""
    if trires.device.type == "cpu":
        return regroup_unpack_plain(plan, trires)
    _require_cuda(trires, "regroup_unpack")
    nb, n_super, _ = plan.bits.shape
    dev, i32 = trires.device, torch.int32
    _check(plan.bits, torch.bool, (nb, n_super, TILE), dev, "bits")
    _check(plan.cnt_ts, i32, (nb, n_super), dev, "cnt_ts")
    _check(plan.base_ts, i32, (nb, n_super), dev, "base_ts")
    _check(trires, i32, (trires.shape[0], 2), dev, "trires")
    out = torch.empty((nb * TILE, 2), dtype=i32, device=dev)
    if nb == 0:
        return out
    err = _lib().regroup_unpack_launch(
        plan.bits.data_ptr(), plan.cnt_ts.data_ptr(), plan.base_ts.data_ptr(),
        trires.data_ptr(), nb, n_super, out.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(err, "regroup_unpack")
    regroup_unpack.launches += 1
    return out


regroup_pack.launches = 0
regroup_tritest.launches = 0
regroup_unpack.launches = 0

FLAGS = ("-fmad=false",)


def _lib():
    lib = cuda_build.load("regroup_intersect", FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
        ("regroup_pack_launch", [p, p, p, p, p, p, i, i, p, p]),
        ("regroup_tritest_launch", [p, p, p, p, i, i, i, p, p]),
        ("regroup_unpack_launch", [p, p, p, p, i, i, p, p]),
    ):
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def merge(tables: wl.WorklistTables, rays8, res) -> Hit:
    """(tri, t bits) per ray -> Hit: the winner's u, v, normal and instance
    recomputed from its triangle's transform row (JAX :841-897, the same
    arithmetic as the tri test, with the odd-triangle uv flip)."""
    tri = res[:, 0]
    hit = tri >= 0
    tri_c = tri.clamp(min=0).long()
    cl, ln = tri_c // TRIS, tri_c % TRIS
    fidx = ((cl * wl.ROWS)[:, None]
            + torch.arange(wl.ROWS, device=tri.device)[None, :]) * TRIS + ln[:, None]
    rows = tables.tab.view(-1)[fidx]  # [n, 16]
    o, d = rays8[:, 0:3], rays8[:, 3:6]

    def dot3(k, v):
        return rows[:, k] * v[:, 0] + rows[:, k + 1] * v[:, 1] + rows[:, k + 2] * v[:, 2]

    opx, opy, opz = dot3(0, o) + rows[:, 9], dot3(3, o) + rows[:, 10], dot3(6, o) + rows[:, 11]
    dpx, dpy, dpz = dot3(0, d), dot3(3, d), dot3(6, d)
    tt = -opz / torch.where(dpz == 0.0, wl.TINY_DIR, dpz)
    u = opx + tt * dpx
    v = opy + tt * dpy
    odd = (tri % 2) == 1
    u = torch.where(hit, torch.where(odd, 1.0 - u, u), 0.0)
    v = torch.where(hit, torch.where(odd, 1.0 - v, v), 0.0)
    nrm = torch.where(hit[:, None], rows[:, 12:15], 0.0)
    inst = torch.where(hit, (rows[:, 15] + 0.5).to(torch.int32), 0)
    t = torch.where(hit, res[:, 1].view(torch.float32), rays8[:, 7])
    prim = torch.where(hit, tri // 2, -1)
    return Hit(hit, prim, u, v, t, o + t[:, None] * d, nrm, inst)


def _capacity_exceeded(n_groups: int, n_super: int, blk_cap: int) -> bool:
    """The JAX package's overflow rule in 128-slot rows (pallas_regroup.py
    :604, :816), its per-segment slack of GRP rows included."""
    rows = n_groups * GRP
    rows_cap = max(GRP, (blk_cap - n_super * GRP - GRP) // GRP * GRP)
    return rows > rows_cap or rows + n_super * GRP > blk_cap


def _regroup_chunk(tables, rays8, blk_cap, livegate):
    n_super = tables.sbbox.shape[0]
    plan = count_stage(rays8, tables.sbbox)
    n_groups_t = plan.groups_s.sum(dtype=torch.int64)
    live_t = (rays8[:, 7] > 0.0).sum()
    n_groups, live = torch.stack([n_groups_t, live_t]).tolist()
    regroup_intersect.host_syncs += 1
    use_fb = _capacity_exceeded(n_groups, n_super, blk_cap)
    if livegate > 0.0:
        use_fb = use_fb or live < int(livegate * rays8.shape[0])
    if use_fb:
        regroup_intersect.fallbacks += 1
        return wl.worklist_intersect(
            tables, *(rays8[:, k].contiguous()
                      for k in (slice(0, 3), slice(3, 6), 6, 7)))
    grp_super = torch.repeat_interleave(
        torch.arange(n_super, dtype=torch.int32, device=rays8.device),
        plan.groups_s.long(), output_size=n_groups)
    packed = regroup_pack(plan, rays8, n_groups * TILE)
    trires = regroup_tritest(packed, tables, grp_super)
    return merge(tables, rays8, regroup_unpack(plan, trires))


def regroup_intersect(tables: wl.WorklistTables, ro, rd, tmin, tmax,
                      blk_cap: int = DEF_BLK_CAP,
                      chunk_blocks: int = DEF_CHUNK_BLOCKS,
                      livegate: float = DEF_LIVEGATE) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] over the packed
    worklist tables, by regrouping (module docstring): the kernels for
    CUDA tensors, their plain versions for CPU tensors. Rays are padded
    to whole 1024-ray tiles with tmax = -1 (no bit set)."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"regroup_intersect: unsupported device {ro.device}")
    n = ro.shape[0]
    nb = max(1, -(-n // TILE))
    rays8 = torch.cat([ro, rd, tmin[:, None], tmax[:, None]], dim=1)
    if nb * TILE > n:
        pad = torch.zeros((nb * TILE - n, PAYLOAD), device=ro.device)
        pad[:, 7] = -1.0
        rays8 = torch.cat([rays8, pad])
    # tiles per chunk: bounds the count stage's [T, S, 1024] temporaries
    # (the JAX package's rule, pallas_regroup.py:610-611)
    step = max(16, min(chunk_blocks, 73000 // max(tables.sbbox.shape[0], 1)))
    parts = [_regroup_chunk(tables, rays8[b0 * TILE:(b0 + step) * TILE],
                            blk_cap, livegate)
             for b0 in range(0, nb, step)]
    return Hit(*(torch.cat(f)[:n] for f in zip(*parts)))


regroup_intersect.host_syncs = 0
regroup_intersect.fallbacks = 0


def make_regroup_intersect(prim_verts: np.ndarray, prim_instance, device,
                           blk_cap: int = DEF_BLK_CAP,
                           chunk_blocks: int = DEF_CHUNK_BLOCKS,
                           livegate: float | None = None):
    """intersect(ro, rd, tmin, tmax) -> Hit over a fixed quad soup, on
    `device`, by regrouping; `.primary` is the worklist intersector over
    the same tables, for coherent camera rays (JAX :1036-1042). `livegate`
    None means DEF_LIVEGATE."""
    tables = wl.pack_tables(prim_verts, prim_instance, wl.WL_SUPER, device)
    gate = DEF_LIVEGATE if livegate is None else livegate

    def intersect(ro, rd, tmin, tmax):
        return regroup_intersect(tables, ro, rd, tmin, tmax, blk_cap,
                                 chunk_blocks, gate)

    def primary(ro, rd, tmin, tmax):
        return wl.worklist_intersect(tables, ro, rd, tmin, tmax)

    intersect.tables = primary.tables = tables
    intersect.livegate = gate
    intersect.primary = primary
    return intersect
