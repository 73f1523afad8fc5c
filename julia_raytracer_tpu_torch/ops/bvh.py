"""Host-side BVH build (vectorized numpy) + flat GPU/TPU-friendly layout.

The port's own copy of julia_raytracer_tpu/ops/bvh.py, kept as it is:
the BVH leaf order decides primitive ids and cluster membership, so it
must equal the JAX package's (tests/test_torch_scene.py holds the two
to the same `order` and `nodes`).

Design notes (TPU-first): the reference builds a pointer-ish two-level
BVH with per-node middle/SAH splits in a serial loop (src/bvh.jl:138-304)
and traverses it with per-thread stacks. Here the builder is fully
vectorized: primitives are sorted by Morton code once, then the tree is a
*median split in Morton order*, built level-synchronously with numpy
(every level's nodes are produced in one batch; leaf bounding boxes come
from `np.minimum.reduceat`). That builds 16.8M-primitive scenes (ecosys)
in seconds without native code while preserving the reference's leaf size
of 4 (src/bvh.jl:32).

Flat layout for wavefront traversal: internal nodes store BOTH children's
bboxes inline so a traversal step does a single 16-float gather:

  nodes f32 [N, 16] = [minL(3) maxL(3) minR(3) maxR(3) childL childR 0 0]

child links are int32 bitcast into the float row: id >= 0 is an internal
node; id < 0 encodes a leaf as -(start * 8 + count) - 1 with count <= 7.
Primitive arrays are reordered so leaves are contiguous ranges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_SIZE = 4  # matches BVH_MAX_PRIMS (src/bvh.jl:32)


@dataclass
class FlatBVH:
    nodes: np.ndarray  # f32 [N, 16] packed (see module docstring)
    order: np.ndarray  # i64 [Q] permutation applied to primitive arrays
    n_prims: int
    root_is_leaf: bool  # tiny scenes: no internal nodes, brute-force all prims


def encode_leaf(start: np.ndarray, count: np.ndarray) -> np.ndarray:
    return -(start * 8 + count) - 1


def decode_leaf(code):
    """code < 0 -> (start, count); works in numpy and jnp."""
    v = -(code + 1)
    return v // 8, v % 8


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 21-bit coords into 63-bit Morton codes (uint64)."""
    x = x.astype(np.uint64)

    def split(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        split(x[:, 0]) | (split(x[:, 1]) << np.uint64(1)) | (split(x[:, 2]) << np.uint64(2))
    )


def _sah_levels(
    bb_min: np.ndarray, bb_max: np.ndarray, order: np.ndarray, leaf_size: int,
    n_bins: int = 16,
):
    """Level-synchronous binned-SAH split structure (reference: split_sah,
    src/bvh.jl:218-274 — 16 bins, all 3 axes). Mutates `order` by
    partitioning every active range at its best (axis, bin) plane and
    returns (order, levels) where levels mirrors the median builder's
    (starts, ends) pairing contract (children of internal ranges only,
    interleaved 2k/2k+1).

    Fully vectorized across ranges: per-prim bin ids are keyed by
    (range, axis, bin) and histogrammed with one bincount; each level's
    partition is a single stable lexsort."""
    q = len(order)
    centers = (bb_min + bb_max) * 0.5
    ext = bb_max - bb_min
    area = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])

    levels = []
    starts = np.array([0], np.int64)
    ends = np.array([q], np.int64)
    while True:
        levels.append((starts, ends))
        counts = ends - starts
        internal = counts > leaf_size
        if not internal.any():
            break
        a_starts, a_ends = starts[internal], ends[internal]
        r = len(a_starts)

        # vectorized per-position range ids over the sorted order
        mark = np.zeros(q + 1, np.int64)
        np.add.at(mark, a_starts, 1)
        np.add.at(mark, a_ends, -1)
        inside = np.cumsum(mark[:q]) > 0
        rmark = np.zeros(q, np.int64)
        rmark[a_starts] = 1
        rid_all = np.cumsum(rmark) - 1
        prid = rid_all[inside]
        pid = order[inside]

        c = centers[pid]
        lo = np.full((r, 3), np.inf)
        hi = np.full((r, 3), -np.inf)
        np.minimum.at(lo, prid, c)
        np.maximum.at(hi, prid, c)
        extent = np.where(hi - lo > 0, hi - lo, 1.0)
        binid = np.clip(
            ((c - lo[prid]) / extent[prid] * n_bins).astype(np.int64), 0, n_bins - 1
        )  # [P, 3]
        w = area[pid]
        key = (prid[:, None] * 3 + np.arange(3)[None, :]) * n_bins + binid
        cnt = np.bincount(key.ravel(), minlength=r * 3 * n_bins).reshape(r, 3, n_bins)
        asum = np.bincount(
            key.ravel(), weights=np.repeat(w, 3), minlength=r * 3 * n_bins
        ).reshape(r, 3, n_bins)
        cl = np.cumsum(cnt, axis=2)
        al = np.cumsum(asum, axis=2)
        cr = cl[:, :, -1:] - cl
        ar = al[:, :, -1:] - al
        # binned SAH proxy: sum-of-areas x count per side (matches the
        # reference's bbox_area x count ranking in spirit)
        cost = (al * cl + ar * cr)[:, :, :-1]
        bad = (cl[:, :, :-1] == 0) | (cr[:, :, :-1] == 0)
        cost = np.where(bad, np.inf, cost)
        flat = cost.reshape(r, -1)
        best = np.argmin(flat, axis=1)
        best_axis = best // (n_bins - 1)
        best_bin = best % (n_bins - 1)
        no_split = ~np.isfinite(flat[np.arange(r), best])

        side = (
            binid[np.arange(len(prid)), best_axis[prid]] > best_bin[prid]
        ).astype(np.int64)
        if no_split.any():
            pos_in_range = np.nonzero(inside)[0] - a_starts[prid]
            med = (a_ends - a_starts)[prid] // 2
            side = np.where(
                no_split[prid], (pos_in_range >= med).astype(np.int64), side
            )
        # stable partition of every active range at once
        perm = np.lexsort((side, prid))
        order[inside] = pid[perm]

        right_counts = np.bincount(prid, weights=side, minlength=r).astype(np.int64)
        mids = a_ends - right_counts
        mids = np.clip(mids, a_starts + 1, a_ends - 1)  # guarantee progress
        nxt_starts = np.empty(2 * r, np.int64)
        nxt_ends = np.empty(2 * r, np.int64)
        nxt_starts[0::2] = a_starts
        nxt_ends[0::2] = mids
        nxt_starts[1::2] = mids
        nxt_ends[1::2] = a_ends
        starts, ends = nxt_starts, nxt_ends
    return order, levels


def build_bvh(
    bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int = LEAF_SIZE,
    sah: bool = False,
) -> FlatBVH:
    """Build from per-primitive bboxes; returns flat nodes + prim permutation.

    `sah=True` (--highqualitybvh) refines the Morton order with binned
    SAH partitions before emitting the packed nodes."""
    q = len(bb_min)
    if q == 0:
        return FlatBVH(
            nodes=np.zeros((1, 16), np.float32),
            order=np.zeros(0, np.int64),
            n_prims=0,
            root_is_leaf=True,
        )

    centers = (bb_min + bb_max) * 0.5
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    extent = np.where(hi - lo > 0, hi - lo, 1.0)
    grid = np.clip(
        ((centers - lo) / extent * ((1 << 21) - 1)), 0, (1 << 21) - 1
    ).astype(np.uint64)
    order = np.argsort(_morton3(grid), kind="stable")

    if q <= leaf_size:
        return FlatBVH(
            nodes=np.zeros((1, 16), np.float32),
            order=order,
            n_prims=q,
            root_is_leaf=True,
        )

    if sah:
        order, levels = _sah_levels(bb_min, bb_max, order, leaf_size)
    else:
        # level-synchronous construction of median (in Morton order) splits
        levels = []
        starts = np.array([0], np.int64)
        ends = np.array([q], np.int64)
        while True:
            levels.append((starts, ends))
            counts = ends - starts
            internal = counts > leaf_size
            if not internal.any():
                break
            mids = (starts[internal] + ends[internal]) // 2
            nxt_starts = np.empty(2 * internal.sum(), np.int64)
            nxt_ends = np.empty_like(nxt_starts)
            nxt_starts[0::2] = starts[internal]
            nxt_ends[0::2] = mids
            nxt_starts[1::2] = mids
            nxt_ends[1::2] = ends[internal]
            starts, ends = nxt_starts, nxt_ends

    smin, smax = bb_min[order], bb_max[order]

    # global ids: internal nodes only, BFS order
    level_internal_mask = []
    level_internal_offset = []
    n_internal = 0
    for starts, ends in levels:
        mask = (ends - starts) > leaf_size
        level_internal_mask.append(mask)
        ids = np.full(len(mask), -1, np.int64)
        ids[mask] = n_internal + np.arange(mask.sum())
        level_internal_offset.append(ids)
        n_internal += int(mask.sum())

    # per-range bboxes, fully vectorized: ranges at one level are disjoint
    # and both endpoints appear in the boundary set, so a reduceat over the
    # sorted boundaries yields every range's bbox in one pass (a range's
    # bbox equals the union of its children's, so no bottom-up merge needed)
    range_min = [None] * len(levels)
    range_max = [None] * len(levels)
    for d, (starts, ends) in enumerate(levels):
        bounds = np.unique(np.concatenate([starts, ends]))
        if bounds[-1] >= q:
            bounds = bounds[:-1]
        seg_min = np.minimum.reduceat(smin, bounds, axis=0)
        seg_max = np.maximum.reduceat(smax, bounds, axis=0)
        idx = np.searchsorted(bounds, starts)
        range_min[d] = seg_min[idx]
        range_max[d] = seg_max[idx]

    # emit packed internal nodes
    nodes = np.zeros((max(n_internal, 1), 16), np.float32)
    child_ints = np.zeros((max(n_internal, 1), 2), np.int32)
    for d, (starts, ends) in enumerate(levels):
        mask = level_internal_mask[d]
        if not mask.any():
            continue
        my_ids = level_internal_offset[d][mask]
        child_starts = levels[d + 1][0]
        child_ends = levels[d + 1][1]
        child_ids = level_internal_offset[d + 1]
        cmin, cmax = range_min[d + 1], range_max[d + 1]
        kL = 2 * np.arange(mask.sum())
        kR = kL + 1

        def link(k):
            ids = child_ids[k].copy()
            is_leaf = ids < 0
            leaf_code = encode_leaf(child_starts[k], child_ends[k] - child_starts[k])
            return np.where(is_leaf, leaf_code, ids).astype(np.int32)

        nodes[my_ids, 0:3] = cmin[kL]
        nodes[my_ids, 3:6] = cmax[kL]
        nodes[my_ids, 6:9] = cmin[kR]
        nodes[my_ids, 9:12] = cmax[kR]
        child_ints[my_ids, 0] = link(kL)
        child_ints[my_ids, 1] = link(kR)
    nodes[:, 12:14] = child_ints.view(np.float32)

    return FlatBVH(nodes=nodes, order=order, n_prims=q, root_is_leaf=False)


def quad_bounds(prim_verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-quad bbox over the 4 corners (src/geometry.jl:67-68)."""
    return prim_verts.min(axis=1), prim_verts.max(axis=1)
