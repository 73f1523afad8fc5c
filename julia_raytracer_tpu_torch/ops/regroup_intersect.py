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
    and the group -> super map. A host read of the group count decides
    whether the packed rows fit (Fallback, below).
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
613-627, :923-929), a lax.cond there and host reads here: the live count
first, so that a chunk the gate sends to the worklist skips the count
stage, then the group count. `regroup_intersect.host_syncs` counts those
reads (each in a `regroup_read` span, utils/timing.py) and
`regroup_intersect.fallbacks` the chunks that fell back.

Differences from the JAX function, none of which changes a hit: the tri
test culls per slot rather than per 128-slot row, and in fp32 (no bf16
split3); segments carry no slack; the `JRT_RG_*` environment knobs are
arguments, and the uv-fast test (`JRT_RG_UVFAST`, not winner-exact) is
not ported. Across superclusters an exact t tie may pick another prim
than the worklist kernel's front-to-back walk: hold the two to
testing.check_hits, not bit equality. At tmax = +inf (the renderer sends
FLT_MAX) the JAX intersectors turn a live ray whose 128-ray row enters a
cluster without a hit into a hit at t = FLT_MAX, their miss fill
(pallas_regroup.py:531-537); here, as in the port's worklist, it misses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.cluster_tables import TRIS
from julia_raytracer_tpu_torch.ops.traversal import Hit, Intersector
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline
from julia_raytracer_tpu_torch.utils.timing import counter, span

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
    return plan_from_bits(enter <= exit_ * wl.SLACK)


def plan_from_bits(bits: torch.Tensor) -> Plan:
    """The rest of the plan from bits [T, S, 1024] (bool): the counts, the
    segments (super-major, each padded to whole 1024-slot groups) and the
    slot of each (tile, super) pair's first ray."""
    i32 = torch.int32
    cnt_ts = bits.sum(dim=-1, dtype=i32)
    cnt_s = cnt_ts.sum(dim=0, dtype=i32)
    groups_s = (cnt_s + (TILE - 1)) // TILE
    seg_base = (torch.cumsum(groups_s, 0, dtype=i32) - groups_s) * TILE
    base_ts = seg_base[None, :] + torch.cumsum(cnt_ts, 0, dtype=i32) - cnt_ts
    return Plan(bits, cnt_ts, base_ts.contiguous(), seg_base, cnt_s, groups_s)


def _ranks(bits):
    """Exclusive rank of each set lane among its (tile, super)'s set
    lanes, [T, S, 1024] i32 (what the kernels' pair walk gives:
    pair_ranks_by_words)."""
    return torch.cumsum(bits, dim=-1, dtype=torch.int32) - 1


def _popc32(x):
    """Set bits of each int64 in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def pair_ranks_by_words(bits):
    """The kernels' pair walk in plain PyTorch, for the tests: each (tile,
    super) pair's 1,024 bits as 32 words of 32, word c's offset the set
    bits of the words before it, and lane j of word c ranked off_c +
    popc(mask_c & ((1 << j) - 1)) -> [T, S, 1024] i32, the rank of each
    set lane (_ranks there) and -1 elsewhere."""
    nb, n_super, _ = bits.shape
    j = torch.arange(32, dtype=torch.int64, device=bits.device)
    set_ = bits.view(nb, n_super, 32, 32)
    mask = (set_.to(torch.int64) << j).sum(dim=-1)  # [T, S, 32] words
    count = _popc32(mask)
    off = torch.cumsum(count, dim=-1) - count
    rank = off[..., None] + _popc32(mask[..., None] & ((1 << j) - 1))
    return torch.where(set_, rank, -1).view(nb, n_super, TILE).to(torch.int32)


def unpack_by_keys(plan: Plan, trires):
    """The unpack kernel's key-min merge in plain PyTorch, for the tests:
    each set lane's key (t bits << 32 | slot) where 0 < t < +inf, the
    least key per ray, (-1, +inf) where there is none, else (tri of the
    key's slot, t) -> [T * 1024, 2] i32. Equal to regroup_unpack_plain's
    serial walk: positive finite floats order as their bits, and a ray's
    slots rise with the super."""
    nb, _, _ = plan.bits.shape
    dev = plan.bits.device
    no_key = torch.iinfo(torch.int64).max  # above every key of a finite t
    key = torch.full((nb * TILE,), no_key, dtype=torch.int64, device=dev)
    t_i, s_i, lane = torch.nonzero(plan.bits, as_tuple=True)
    slot = (plan.base_ts[t_i, s_i]
            + pair_ranks_by_words(plan.bits)[t_i, s_i, lane]).long()
    t_bits = trires[slot, 1].long()
    tt = trires[slot, 1].view(torch.float32)
    ok = (tt > 0.0) & (tt < float("inf"))
    key.scatter_reduce_(0, (t_i * TILE + lane)[ok], ((t_bits << 32) | slot)[ok], "amin")
    hit = key != no_key
    tri = torch.full_like(key, -1)
    tri[hit] = trires[key[hit] & 0xFFFFFFFF, 0].long()
    t = torch.where(hit, key >> 32, 0x7F800000)
    return torch.stack([tri, t], dim=1).to(torch.int32)


def regroup_pack_plain(plan: Plan, rays8, n_slots: int):
    """Plain version of the pack kernel -> packed [n_slots, 8] f32."""
    out = torch.zeros((n_slots, PAYLOAD), dtype=torch.float32,
                      device=rays8.device)
    out[:, 7] = -1.0
    t, s, lane = torch.nonzero(plan.bits, as_tuple=True)
    slot = plan.base_ts[t, s] + _ranks(plan.bits)[t, s, lane]
    out[slot.long()] = rays8[t * TILE + lane]
    return out


def tritest_pairs(packed, tables: wl.WorklistTables, grp_super):
    """The (slot, cluster) pairs the tri-test tests: each slot against the
    clusters of its group's super, culled against the slot's tmax ->
    (slot, cluster index in the super, cluster id), each [pairs] i64."""
    dev = packed.device
    sup = tables.sup
    n = packed.shape[0]
    o, tmin, tmax = packed[:, 0:3], packed[:, 6], packed[:, 7]
    inv = wl._inverse_dir(packed[:, 3:6])
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
    return slot_p, ci_p, sc[slot_p] * sup + ci_p


def regroup_tritest_plain(packed, tables: wl.WorklistTables, grp_super):
    """Plain version of the tri-test kernel -> (out [slots, 2] i32, work),
    where work counts the (slot, cluster) pairs that pass the cull
    (`passes`, each 128 triangle tests), the (group, cluster) pairs with
    at least one (`group_passes`) and the distinct clusters among them
    (`clusters`); and what the kernel's per-warp walk pays for them: the
    warps it launches (`warps`, 32 slots each), those with a slot that can
    enter a box (tmin <= tmax * SLACK), each one mask vote (`votes`; the
    others leave at once), the (warp, cluster) pairs with a slot that
    wants the cluster, each one table load (`warp_pairs`), and the real
    (not padding) triangles of the passes' clusters (`tri_slots`: over
    passes x 128, the share of the triangle loop's lane slots that test a
    real triangle).

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
    slot_p, ci_p, cl_p = tritest_pairs(packed, tables, grp_super)
    t_pair = torch.empty(slot_p.shape[0], device=dev)
    tri_pair = torch.empty(slot_p.shape[0], dtype=torch.int64, device=dev)
    hit_pair = torch.empty(slot_p.shape[0], dtype=torch.bool, device=dev)
    for lo in range(0, slot_p.shape[0], PLAIN_PAIRS):  # the tri tests
        k = slice(lo, lo + PLAIN_PAIRS)
        sp = slot_p[k]
        hit, t, _, _ = wl._tri_tests(o[sp], d[sp], tmin[sp], tmax[sp],
                                     tables.tab[cl_p[k]])
        t = torch.where(hit, t, float("inf"))
        arg = torch.argmin(t, dim=1, keepdim=True)  # first minimum
        t_pair[k] = t.gather(1, arg)[:, 0]
        tri_pair[k] = cl_p[k] * TRIS + arg[:, 0]
        hit_pair[k] = hit.gather(1, arg)[:, 0]
    best = tmax.clone()
    best.scatter_reduce_(0, slot_p, t_pair, "amin")
    # a pair without a hit never wins, not even at tmax = +inf
    won = hit_pair & (t_pair == best[slot_p])
    no_tri = torch.iinfo(torch.int64).max
    best_tri = torch.full((n,), no_tri, dtype=torch.int64, device=dev)
    best_tri.scatter_reduce_(0, slot_p[won], tri_pair[won], "amin")
    best_tri = torch.where(best_tri == no_tri, -1, best_tri)
    valid = (best_tri >= 0) & (best_tri < 2 * tables.n_prims)
    tri = torch.where(valid, best_tri, -1).to(torch.int32)
    t = torch.where(valid, best, tmax)
    enter = tmin <= tmax * wl.SLACK
    work = dict(passes=slot_p.numel(),
                group_passes=torch.unique((slot_p // TILE) * sup + ci_p).numel(),
                clusters=torch.unique(cl_p).numel(),
                warps=n // wl.WARP,
                votes=int(enter.view(-1, wl.WARP).any(dim=1).sum()),
                warp_pairs=torch.unique((slot_p // wl.WARP) * sup + ci_p).numel(),
                tri_slots=int(wl.real_tris(tables.tab)[cl_p].sum()))
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


def plan_bytes(plan: Plan) -> int:
    """kernel_flops.regroup_plan_bytes of a plan."""
    return kf.regroup_plan_bytes(plan.cnt_ts.numel(),
                                 int((plan.cnt_ts > 0).sum()))


def regroup_pack(plan: Plan, rays8, n_slots: int):
    """Pack kernel on CUDA tensors, its plain version on CPU tensors (any
    other device raises) -> packed [n_slots, 8] f32. `n_slots` must be the
    plan's segment total (1024 x its groups). Under roofline.count_cost
    the call reports kernel_flops.regroup_pack_cost."""
    with roofline.kernel_region() as counter:
        out = _regroup_pack(plan, rays8, n_slots)
        if counter is not None:
            counter.add_kernel("regroup_pack", kf.regroup_pack_cost(
                plan_bytes(plan), plan.bits.shape[1],
                int(plan.bits.any(dim=1).sum()), out.numel()))
    return out


def _regroup_pack(plan: Plan, rays8, n_slots: int):
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
    -> [slots, 2] i32 (tri, t bits). Under roofline.count_cost the call
    reports kernel_flops.regroup_tritest_cost (its passes: tritest_pairs)."""
    with roofline.kernel_region() as counter:
        out = _regroup_tritest(packed, tables, grp_super)
        if counter is not None:
            _, _, cl_p = tritest_pairs(packed, tables, grp_super)
            counter.add_kernel("regroup_tritest", kf.regroup_tritest_cost(
                packed.numel(), torch.unique(cl_p).numel(),
                torch.unique(grp_super).numel(), tables.sup,
                grp_super.numel(), out.numel(), cl_p.numel()))
    return out


def _regroup_tritest(packed, tables: wl.WorklistTables, grp_super):
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
    [T * 1024, 2] i32 (tri, t bits). Under roofline.count_cost the call
    reports kernel_flops.regroup_unpack_cost."""
    with roofline.kernel_region() as counter:
        out = _regroup_unpack(plan, trires)
        if counter is not None:
            counter.add_kernel("regroup_unpack", kf.regroup_unpack_cost(
                plan_bytes(plan), int(plan.cnt_s.sum()), out.numel()))
    return out


def _regroup_unpack(plan: Plan, trires):
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


counter(regroup_pack, "launches")
counter(regroup_tritest, "launches")
counter(regroup_unpack, "launches")

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


def _fallback(tables, rays8):
    regroup_intersect.fallbacks += 1
    return wl.worklist_intersect(
        tables, *(rays8[:, k].contiguous()
                  for k in (slice(0, 3), slice(3, 6), 6, 7)))


def _regroup_chunk(tables, rays8, blk_cap, livegate):
    # the liveness gate first, so a chunk that falls back for it skips the
    # count stage (the JAX package computes both before its lax.cond)
    if livegate > 0.0:
        with span("regroup_read"):
            live = int((rays8[:, 7] > 0.0).sum())
        regroup_intersect.host_syncs += 1
        if live < int(livegate * rays8.shape[0]):
            return _fallback(tables, rays8)
    n_super = tables.sbbox.shape[0]
    plan = count_stage(rays8, tables.sbbox)
    with span("regroup_read"):
        n_groups = int(plan.groups_s.sum(dtype=torch.int64))
    regroup_intersect.host_syncs += 1
    if _capacity_exceeded(n_groups, n_super, blk_cap):
        return _fallback(tables, rays8)
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


counter(regroup_intersect, "host_syncs")
counter(regroup_intersect, "fallbacks")


def make_regroup_intersect(prim_verts: np.ndarray, prim_instance, device,
                           blk_cap: int = DEF_BLK_CAP,
                           chunk_blocks: int = DEF_CHUNK_BLOCKS,
                           livegate: float | None = None,
                           cache_key: str = "") -> Intersector:
    """The Intersector over a fixed quad soup, on `device`: `hit` by
    regrouping, `primary` the worklist over the same tables, for coherent
    camera rays (JAX :1036-1042). `livegate` None means DEF_LIVEGATE; the
    cluster tables go through the disk cache under `cache_key`."""
    tables = wl.pack_tables(prim_verts, prim_instance, wl.WL_SUPER, device,
                            cache_key)
    gate = DEF_LIVEGATE if livegate is None else livegate

    def intersect(ro, rd, tmin, tmax):
        return regroup_intersect(tables, ro, rd, tmin, tmax, blk_cap,
                                 chunk_blocks, gate)

    def primary(ro, rd, tmin, tmax):
        return wl.worklist_intersect(tables, ro, rd, tmin, tmax)

    return Intersector(intersect, primary, tables=tables, livegate=gate)
