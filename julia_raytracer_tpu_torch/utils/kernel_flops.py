"""Cost models of the port's hand-written kernels: fp32 operations and
bytes of one call, from the call's inputs and counts (port of
julia_raytracer_tpu/utils/kernel_flops.py).

The JAX package's per-pass costs (`tritest_pass_flops` with its split3
and uv-fast variants, `pack_pair_flops`, `unpack_pair_flops`,
`worklist_pass_flops`) price the TPU kernels' MXU passes: bf16 matmul
splits, one-hot selections, 128 x 128 slabs whatever the rays need. They
price a TPU pass, not the work, and none of them is carried over. Here one
function per kernel of the kernel table (PERF.md section 6) counts what a
call needs, by the roofline rule: each input byte read once,
each output byte written once, and the fp32 operations the kernel's
arithmetic does on this call's data (compares and selects not counted);
where the work depends on the data, the counts the caller passes are what
these inputs need. The same call costs the same whether the plain version
or the kernel runs it. utils/roofline.py `bound` turns a cost into the
least time on the card; the kernel wrappers report their call's cost to
roofline.count_cost inside a kernel region.

Kept verbatim from the JAX module (held equal to it by
tests/test_torch_kernel_flops.py): `_slab`, `regroup_dispatch_stats` and
`worklist_dispatch_stats`, the numpy reproductions of a dispatch's counts.
`regroup_dispatch_flops` and `worklist_dispatch_flops` keep their names
and keys but price those counts with this module's per-unit costs.
"""

from __future__ import annotations

import numpy as np

LANES = 128
TRIS = 128
SUP = 128
TILE = 1024
GRP = 8

ROWS = 16  # table rows of a cluster (12 transform, 3 normal, 1 instance)
PAYLOAD = 8  # floats of a packed regroup ray: o, d, tmin, tmax
RAY_IN_BYTES = 32  # origin, direction, tmin, tmax
HIT_OUT_BYTES = 44  # prim, u, v, t, position, normal, instance
CLUSTER_BYTES = ROWS * TRIS * 4  # one cluster's table
# fp32 arithmetic of one Moller-Trumbore test in dense_intersect.cu by how
# far its pre-test lets it go (compares and selects not counted): every
# test 25 (9 pvec, 5 det, 3 tvec, 5 u numerator, |det|, 2|det|, 2^-23
# |det|), past the pre-test 24 more (9 qvec, the reciprocal, u, 6 v, 6 t,
# u + v)
DENSE_OPS = (25, 24)
# the test with its 6 edge subtractions and no pre-test (the count of the
# kernel before its table was precomputed)
DENSE_OPS_PER_TRI_TEST = 52
# fp32 arithmetic of one triangle test, counted from tri_test in
# warp_walk.cuh / worklist_intersect.cu (18 for o', 15 for d', negate and
# divide for t, 4 for u and v, 1 for u + v)
OPS_PER_TRI_TEST = 40
# fp32 operations of one (ray, item) slab test of the cull, counted in
# candidate_cull.cu: 6 subtracts, 6 multiplies, 6 min/max, 4 for the entry
# and exit, 2 clips, the slack, the compare, the clamp and the group min
CULL_OPS_PER_TEST = 28
# the same test of a ray against the root or a cluster box: no clamp, no min
MAY_ENTER_OPS = 26
# fp32 operations of one line and one point test, counted in
# csrc/curve_intersect.cu line_test (6 differences, 5 dot products of 5,
# det 3, t 4, the segment parameter and its clamp 6, the two points and
# their difference 15, d2 5, the radius 4, sqrt and divide, r * r) and
# point_test (3, two dot products, a divide, 6, 3, 5, 1)
LINE_TEST_OPS = 71
POINT_TEST_OPS = 29
CURVE_ELEM_BYTES = 32  # an element of the walk's table
CURVE_HIT_BYTES = 24  # line, t, u, v, point, t
# the shading kernel (csrc/shade_path.cu) a lane: the state it reads (ray
# direction 12, hit record 53, radiance and weight 24, RNG state, bounce
# and flags 10, first-hit AOVs 24) and writes (next ray 24, tmin and tmax
# 8, radiance and weight 24, RNG state, bounce and flags 10, AOVs 24)
SHADE_IN_BYTES = 111
SHADE_OUT_BYTES = 90
# fp32 operations of a matte lane, counted in shade_path.cu: the facing
# normal and emission 16, the basis and the cosine sample 57, the lobe's
# value and pdf 30, the MIS weight and roulette 22; and of one light
# triangle's test in the exact pdf (6 edge differences, 2 crosses 18, the
# origin's difference 3, 4 dot products 20, the reciprocal and 3 products)
SHADE_LANE_OPS = 125
LIGHT_TRI_OPS = 51
# fp32 operations of the regroup merge a ray (regroup_intersect.merge):
# the triangle test's arithmetic on the winner, the odd-triangle flip (2)
# and the position (6)
MERGE_OPS = OPS_PER_TRI_TEST + 8


def _cost(n_bytes: float, ops: float) -> dict:
    return dict(ops=float(ops), bytes=float(n_bytes))


# ---- one function per kernel of the kernel table ----------------------

def dense_intersect_cost(n_rays: int, table_bytes: int, tests: int,
                         reach: int) -> dict:
    """Row 1: the rays in, the hits out, the prim and parameter tables;
    DENSE_OPS[0] a triangle test and DENSE_OPS[1] more for each test that
    passes the pre-test (`tests`, `reach`: dense_intersect.pretest_counts)."""
    return _cost(n_rays * (RAY_IN_BYTES + HIT_OUT_BYTES) + table_bytes,
                 tests * DENSE_OPS[0] + reach * DENSE_OPS[1])


def lane_compact_cost(planes: int, n: int, cap: int) -> dict:
    """Row 2: the [planes, n] int32 planes and the n-lane mask in, the
    [planes, cap] prefix out; no arithmetic."""
    return _cost(planes * n * 4 + n + planes * cap * 4, 0)


def lane_expand_cost(planes: int, cap: int, n: int) -> dict:
    """Row 3: the [planes, cap] narrow planes, the mask and the [planes, n]
    fallback in, [planes, n] out; no arithmetic."""
    return _cost((planes * cap + 2 * planes * n) * 4 + n, 0)


def cluster_sweep_cost(n_rays: int, box_bytes: int, clusters: int,
                       pairs: int) -> dict:
    """Rows 4 and 5: the rays in, the hits out, the cluster (and
    supercluster) boxes, the table of each cluster tested; a triangle test
    for each of the 128 triangles of each (ray, cluster) pair needed."""
    return _cost(n_rays * (RAY_IN_BYTES + HIT_OUT_BYTES) + box_bytes
                 + clusters * CLUSTER_BYTES,
                 pairs * TRIS * OPS_PER_TRI_TEST)


def worklist_intersect_cost(n_rays: int, table_bytes: int, list_bytes: int,
                            pairs: int) -> dict:
    """Row 6: the rays in, the hits out, the packed tables and the work
    lists; a triangle test for each triangle of each (ray, cluster) pair."""
    return _cost(n_rays * (RAY_IN_BYTES + HIT_OUT_BYTES) + table_bytes
                 + list_bytes, pairs * TRIS * OPS_PER_TRI_TEST)


def instanced_intersect_cost(n_rays: int, n_groups: int, steps: int,
                             supers: int, sup: int, instances: int,
                             clusters: int, pairs: int) -> dict:
    """Row 7: the rays, the group counts, the list entries the warps walk
    (order, t_low, the item's supercluster and instance: 16 bytes a
    (warp, entry) step), the boxes of the superclusters, the rows of the
    instances and the tables of the clusters visited; the hits out; a
    triangle test for each triangle of each (ray, cluster) pair."""
    return _cost(n_rays * (RAY_IN_BYTES + HIT_OUT_BYTES) + n_groups * 4
                 + steps * 16 + supers * sup * 32 + instances * 96
                 + clusters * CLUSTER_BYTES,
                 pairs * TRIS * OPS_PER_TRI_TEST)


def curve_walk_cost(n_rays: int, elements: int) -> dict:
    """The curve walk (not a pallas_call; csrc/curve_intersect.cu): the
    rays in, their closest line and point out, the element table read
    once; one line test and one point test a ray, the least a ray whose
    closest element is one of each needs (a floor: the walk tests every
    candidate its warp reaches)."""
    return _cost(n_rays * (RAY_IN_BYTES + CURVE_HIT_BYTES)
                 + elements * CURVE_ELEM_BYTES,
                 n_rays * (LINE_TEST_OPS + POINT_TEST_OPS))


def shade_path_cost(n_lanes: int, light_elements: int) -> dict:
    """The shading kernel (not a pallas_call; csrc/shade_path.cu): each
    lane's state in and out once (u, v and the prim counted whether or not
    the scene reads them), the material rows and light elements, read
    through the caches by every lane, not counted; a matte lane's
    arithmetic and the exact light pdf's two triangle tests an element, the
    least a lane needs (a floor: glossy lobes and the hits of the light
    elements add more)."""
    ops = SHADE_LANE_OPS + 2 * LIGHT_TRI_OPS * light_elements
    return _cost(n_lanes * (SHADE_IN_BYTES + SHADE_OUT_BYTES), n_lanes * ops)


def candidate_cull_cost(n_rays: int, n_groups: int, group: int, items: int,
                        clusters: int, cluster_tests: int, item_tests: int,
                        candidates: int) -> dict:
    """The candidate cull (not a pallas_call): the rays, the items' slots
    (box and item) and the cluster and root boxes in, each group's sorted
    candidates (key and item) and count out; a test of every ray of a group
    against the root box, of each ray that may enter it against every
    cluster box (cluster_tests), and of each ray that may enter a cluster
    against the cluster's items (item_tests)."""
    return _cost(n_rays * RAY_IN_BYTES + (items + clusters + 1) * 24
                 + items * 4 + candidates * 8 + n_groups * 4,
                 (n_groups * group + cluster_tests) * MAY_ENTER_OPS
                 + item_tests * CULL_OPS_PER_TEST)


def regroup_plan_bytes(tile_super_pairs: int, live_pairs: int) -> int:
    """The plan as pack and unpack must read it: every (tile, super) pair's
    count (to skip the empty pairs), and the bits and slot base of the
    live pairs only."""
    return 4 * tile_super_pairs + live_pairs * (TILE + 4)


def regroup_pack_cost(plan_bytes: int, n_super: int, live_lanes: int,
                      packed_elems: int) -> dict:
    """Row 8: the plan, seg_base and cnt_s, each lane that enters a super
    read once, every slot (padding included) written once."""
    return _cost(plan_bytes + 8 * n_super + live_lanes * PAYLOAD * 4
                 + packed_elems * 4, 0)


def regroup_tritest_cost(packed_elems: int, clusters: int, group_supers: int,
                         sup: int, n_groups: int, out_elems: int,
                         passes: int) -> dict:
    """Row 9: the packed slots, each tested cluster's table once and the
    boxes of the supers its groups test, the group -> super map, the
    (tri, t) out; a triangle test for each triangle of each (slot,
    cluster) pass."""
    return _cost(packed_elems * 4 + clusters * CLUSTER_BYTES
                 + group_supers * sup * 8 * 4 + n_groups * 4 + out_elems * 4,
                 passes * TRIS * OPS_PER_TRI_TEST)


def regroup_unpack_cost(plan_bytes: int, set_bits: int, out_elems: int) -> dict:
    """Row 10: the plan, the (tri, t) of each set bit's slot, each ray's
    result written once; no arithmetic (compares only)."""
    return _cost(plan_bytes + set_bits * 8 + out_elems * 4, 0)


# ---- dynamic counts from the scene + a ray dispatch -------------------

def count_stage_flops(n_rays: int, n_super: int) -> float:
    """One slab test of every ray against every supercluster box."""
    return n_rays * n_super * float(CULL_OPS_PER_TEST)


def _slab(o, d, tmin, tmax, bb):
    di = 1.0 / np.where(d == 0, 1e-30, d)
    t0 = (bb[None, :, 0:3] - o[:, None]) * di[:, None]
    t1 = (bb[None, :, 3:6] - o[:, None]) * di[:, None]
    enter = np.maximum(np.minimum(t0, t1).max(-1), tmin[:, None])
    exit_ = np.minimum(np.maximum(t0, t1).min(-1), tmax[:, None])
    return enter <= exit_ * np.float32(1.00000024)


def regroup_dispatch_stats(o, d, tmin, tmax, cbbox, sup: int = SUP) -> dict:
    """Reproduce the regroup pipeline's dynamic counts for one dispatch.

    cbbox: [C, 6] cluster bboxes in Morton order (pallas_cluster table
    order). Returns live pairs, touched blocks, rows, and tri-test pass
    counts — the inputs to the flop model."""
    n = len(o)
    c = len(cbbox)
    s_count = -(-c // sup)
    pad = s_count * sup - c
    cb = (np.concatenate([cbbox, np.tile(cbbox[-1:], (pad, 1))])
          if pad else cbbox)
    sb = np.concatenate(
        [cb.reshape(s_count, sup, 6)[:, :, 0:3].min(1),
         cb.reshape(s_count, sup, 6)[:, :, 3:6].max(1)], axis=1)
    bits = _slab(o, d, tmin, tmax, sb)              # [rays, S]
    n_tiles = -(-n // TILE)
    padr = n_tiles * TILE - n
    if padr:
        bits = np.concatenate(
            [bits, np.zeros((padr, s_count), bool)], axis=0)
    bt = bits.reshape(n_tiles, TILE, s_count)
    cnt_ts = bt.sum(axis=1)                          # [tiles, S]
    pairs_live = int((cnt_ts > 0).sum())
    # touched window blocks per live pair: depends on the running lane
    # offset; reproduce the cursor walk (vectorized over tiles per super)
    touched = 0
    rows = 0
    passes = 0
    groups_live = 0
    for s in range(s_count):
        cnts = cnt_ts[:, s]
        live_t = cnts > 0
        if live_t.any():
            cur_b = np.cumsum(cnts) - cnts           # offsets before tile
            off = cur_b[live_t] % LANES
            c = cnts[live_t]
            touched += int(((off + c - 1) // LANES + 1).sum())
        cur = int(cnts.sum())
        nrow = -(-(-(-cur // LANES)) // GRP) * GRP
        rows += nrow
        if cur == 0:
            continue
        # tri-test passes: per row, clusters any ray in the row wants
        rs = np.nonzero(bits[:, s])[0]  # pad rows are all-zero: rs < n
        nr = -(-len(rs) // LANES)
        groups_live += -(-nr // GRP)
        sb_s = cb[s * sup:(s + 1) * sup]
        # 16384-ray (128-row-aligned) chunks bound the slab temporaries
        for g in range(0, len(rs), 16384):
            rg_ = rs[g:g + 16384]
            cl = _slab(o[rg_], d[rg_], tmin[rg_], tmax[rg_], sb_s)
            nr_g = -(-len(rg_) // LANES)
            pad_r = nr_g * LANES - len(rg_)
            if pad_r:
                cl = np.concatenate(
                    [cl, np.zeros((pad_r, cl.shape[1]), bool)], axis=0)
            passes += int(cl.reshape(nr_g, LANES, -1).any(1).sum())
    return dict(
        n_rays=n, n_super=s_count, pairs_live=pairs_live,
        touched_blocks=touched, rows=rows, passes=passes,
        groups_live=groups_live,
    )


def regroup_dispatch_flops(stats: dict) -> dict:
    """Operations and principal HBM bytes of one regroup dispatch, from
    regroup_dispatch_stats' counts, by this module's per-unit costs: the
    count stage one slab test a (ray, super); pack and unpack move data
    only; the tri-test a slab test of every slot of a row against its
    super's clusters and, per (128-slot row, cluster) pass, 128 slots x 128
    triangle tests (the row granularity of the stats: at most the port's
    per-slot passes); the merge MERGE_OPS a ray."""
    fl = dict(
        count=count_stage_flops(stats["n_rays"], stats["n_super"]),
        pack=0.0,
        tri=float(stats["passes"] * LANES * TRIS * OPS_PER_TRI_TEST
                  + stats["rows"] * LANES * SUP * CULL_OPS_PER_TEST),
        unpack=0.0,
        merge=stats["n_rays"] * float(MERGE_OPS),
    )
    fl["total"] = sum(fl.values())
    # principal HBM traffic: tables streamed once per segment run +
    # packed rays written+read + bits + chunk planes + outputs
    tab_bytes = stats["n_super"] * SUP * CLUSTER_BYTES
    packed = stats["rows"] * LANES * PAYLOAD * 4
    fl["bytes"] = float(
        stats["n_rays"] * stats["n_super"] * 4      # bits write+read(/2)
        + stats["n_rays"] * 40 * 4                  # chunk planes
        + 2 * packed                                # pack write, tri read
        + tab_bytes                                 # one table sweep
        + stats["rows"] * LANES * 8 * 4             # tri out
        + stats["n_rays"] * (16 + 10) * 4           # merge gathers/out
    )
    return fl


def worklist_dispatch_stats(o, d, tmin, tmax, cbbox, sup: int = SUP) -> dict:
    """Approximate the worklist kernel's dynamic counts: per 1024-ray
    block, live supers = union over rays; per (block, super), cluster
    passes = per-row lane unions (cull vs tmax — the kernel's running
    best-t termination makes true counts somewhat lower, so worklist
    mfu from this model is an upper bound on its work, i.e. a FLOOR on
    its wall-time efficiency)."""
    n = len(o)
    c = len(cbbox)
    s_count = -(-c // sup)
    pad = s_count * sup - c
    cb = (np.concatenate([cbbox, np.tile(cbbox[-1:], (pad, 1))])
          if pad else cbbox)
    sb = np.concatenate(
        [cb.reshape(s_count, sup, 6)[:, :, 0:3].min(1),
         cb.reshape(s_count, sup, 6)[:, :, 3:6].max(1)], axis=1)
    bits = _slab(o, d, tmin, tmax, sb)
    n_tiles = -(-n // TILE)
    passes = 0
    pairs = 0
    for t in range(n_tiles):
        lo, hi = t * TILE, min((t + 1) * TILE, n)
        live_s = np.nonzero(bits[lo:hi].any(0))[0]
        if not len(live_s):
            continue
        pairs += len(live_s)
        nr = -(-(hi - lo) // LANES)
        pad_r = nr * LANES - (hi - lo)
        # live supers in 32-super chunks: bounds the [rays, C, 3] slab
        # temporaries to ~50 MB
        for g in range(0, len(live_s), 32):
            ls = live_s[g:g + 32]
            cidx = (ls[:, None] * sup + np.arange(sup)[None, :]).reshape(-1)
            cl = _slab(o[lo:hi], d[lo:hi], tmin[lo:hi], tmax[lo:hi], cb[cidx])
            if pad_r:
                cl = np.concatenate(
                    [cl, np.zeros((pad_r, cl.shape[1]), bool)], axis=0)
            passes += int(cl.reshape(nr, LANES, -1).any(1).sum())
    return dict(n_rays=n, n_super=s_count, pairs_live=pairs, passes=passes)


def worklist_dispatch_flops(stats: dict) -> dict:
    """Operations and principal HBM bytes of one worklist dispatch from
    worklist_dispatch_stats' counts: the precull one slab test a (ray,
    super); per live (1024-ray block, super) pair a slab test of each ray
    against each of the super's clusters; per (128-ray row, cluster) pass
    128 rays x 128 triangle tests (at most the port's per-ray pairs)."""
    fl = dict(
        precull=count_stage_flops(stats["n_rays"], stats["n_super"]),
        cull=float(stats["pairs_live"] * SUP * TILE * CULL_OPS_PER_TEST),
        tri=float(stats["passes"] * LANES * TRIS * OPS_PER_TRI_TEST),
    )
    fl["total"] = sum(fl.values())
    tab_bytes = stats["pairs_live"] * SUP * CLUSTER_BYTES
    fl["bytes"] = float(
        tab_bytes + stats["n_rays"] * (8 + 11) * 4
    )
    return fl
