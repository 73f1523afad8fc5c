"""The regroup intersector's plain PyTorch path (count stage, the plain
versions of csrc/regroup_intersect.cu's three kernels, merge: what the
wrappers run for CPU tensors) against the JAX package's regroup
intersector in interpret mode and against the port's worklist plain
version, on the clustered quad soup of tests/test_regroup.py (12,000
quads, 7 instance ids: 2 superclusters), with coherent and divergent
rays, a ragged ray count and dead lanes (tmax = -1).

Tolerances: check() of tests/test_pallas_kernels.py (testing.check_hits):
hit masks equal, > 99.9% same prim on hits, t within rtol 1e-4, u, v and
position within 5e-3, normal within 1e-3, the instance equal where the
prims agree. The TPU kernels test triangles with bf16-split matmuls, the
port in fp32, so t and uv differ in the last bits; against the port's
worklist the arithmetic is the same, and only an exact t tie across
superclusters could pick another prim."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.pallas_regroup import make_cluster_intersect_regroup
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.testing import (
    adversarial_trires, check_hits, regroup_bits,
)

N_PRIMS = 12000
N_RAYS = 1024 + 333  # not a multiple of the 1024-ray tile
# packed capacity in 128-slot blocks, room for 4x the rays here: the JAX
# tri-test's interpret-mode grid runs over the whole capacity
BLK_CAP = 512
F32_MAX = np.float32(3.4028235e38)


def _soup(n_prims, rng):
    """tests/test_regroup.py's soup: morton-ordered small quads in the
    unit cube."""
    centers = rng.random((n_prims, 3))
    order = np.argsort(
        (centers[:, 0] * 64).astype(np.int64) * 4096
        + (centers[:, 1] * 64).astype(np.int64) * 64
        + (centers[:, 2] * 64).astype(np.int64)
    )
    centers = centers[order]
    e1 = rng.normal(size=(n_prims, 3)) * 0.02
    e2 = rng.normal(size=(n_prims, 3)) * 0.02
    return np.stack(
        [centers, centers + e1, centers + e1 + e2, centers + e2], axis=1
    ).astype(np.float32)


def _rays(rng, n, divergent, dead=0.1, tmax_live=3.0e38):
    if divergent:
        o = rng.random((n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (n, 1))
        d = (rng.random((n, 3)) - [0.5, 0.5, -1.5]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, tmax_live, np.float32)
    tmax[rng.random(n) < dead] = -1.0  # dead lanes, as the integrator sends them
    return o, d.astype(np.float32), np.full(n, 1e-4, np.float32), tmax


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(11)
    pv = _soup(N_PRIMS, rng)
    inst = (np.arange(N_PRIMS) % 7).astype(np.int32)
    jax_rg = make_cluster_intersect_regroup(pv, inst, interpret=True,
                                            blk_cap=BLK_CAP)
    return pv, inst, wl.pack_tables(pv, inst), jax_rg


@pytest.fixture(scope="module", params=["coherent", "divergent", "coherent_inf"])
def case(request, soup):
    """`coherent_inf`: the coherent rays with tmax = +inf on the live
    lanes, so that live slots enter clusters that hold no hit."""
    pv, inst, tables, jax_rg = soup
    rays = _rays(np.random.default_rng(5), N_RAYS,
                 request.param == "divergent",
                 tmax_live=np.inf if request.param.endswith("_inf") else 3.0e38)
    targs = [torch.from_numpy(x) for x in rays]
    fb0 = rg.regroup_intersect.fallbacks
    got = rg.regroup_intersect(tables, *targs, blk_cap=BLK_CAP)
    assert rg.regroup_intersect.fallbacks == fb0  # the kernels' path ran
    want = jax_rg(*(jnp.asarray(x) for x in rays))
    order, cnt = wl.precull(*targs, tables.sbbox)
    worklist = wl.worklist_intersect_plain(tables, *targs, order, cnt)[0]
    return dict(name=request.param, rays=rays, targs=targs, tables=tables,
                inst=inst, got=got, want=want, worklist=worklist)


def test_regroup_matches_jax_regroup(case):
    """At tmax = +inf the JAX intersectors, its worklist as well, turn a
    live ray whose 128-ray row enters a cluster and hits nothing in it into
    a hit at t = FLT_MAX, their miss fill (pallas_regroup.py:531-537: the
    fill is below tmax); the port answers the miss there, as its worklist
    intersector does. The renderer sends FLT_MAX, never +inf."""
    got = case["got"]
    want = [np.asarray(f) for f in case["want"][:8]]
    fill = want[0] & (want[4] == F32_MAX)
    assert fill.any() == case["name"].endswith("_inf")
    check_hits([f[~fill] for f in want], [f.numpy()[~fill] for f in got])
    assert not got.hit.numpy()[fill].any()
    assert np.isinf(got.t.numpy()[fill]).all()
    assert not case["worklist"].hit.numpy()[fill].any()
    hit = got.hit.numpy()
    assert 0.05 < hit.mean() < 0.95
    assert not hit[case["rays"][3] < 0].any()  # dead lanes never hit
    # the miss convention: prim -1, t = tmax, instance 0
    np.testing.assert_array_equal(got.prim.numpy()[~hit], -1)
    np.testing.assert_array_equal(got.t.numpy()[~hit], case["rays"][3][~hit])
    np.testing.assert_array_equal(got.instance.numpy()[~hit], 0)
    np.testing.assert_array_equal(got.instance.numpy()[hit],
                                  case["inst"][got.prim.numpy()[hit]])
    if case["name"].endswith("_inf"):
        # live rays that enter a supercluster and hit nothing in it miss
        # here as in the JAX regroup, with t = +inf
        plan = rg.count_stage(_rays8(case["targs"]), case["tables"].sbbox)
        entered = plan.bits.any(dim=1).reshape(-1)[:N_RAYS].numpy()
        live = case["rays"][3] > 0
        assert np.isinf(case["rays"][3][live]).all()
        assert (entered & live & ~hit).sum() > 0


def test_regroup_matches_port_worklist(case):
    check_hits(case["worklist"], case["got"])


def test_count_stage_and_tritest_work(case):
    """Segments are whole 1024-slot groups, super-major; the plain
    tri-test counts its passes."""
    tables = case["tables"]
    rays8 = _rays8(case["targs"])
    plan = rg.count_stage(rays8, tables.sbbox)
    assert plan.bits.dtype == torch.bool
    assert plan.bits.shape == (rays8.shape[0] // rg.TILE, 2, rg.TILE)
    assert torch.equal(plan.cnt_s, plan.bits.sum(dim=(0, 2)).int())
    assert torch.equal(plan.groups_s, (plan.cnt_s + 1023) // 1024)
    assert plan.seg_base.tolist() == [0, int(plan.groups_s[0]) * 1024]
    # dead and padding lanes set no bit
    dead = rays8[:, 7] < 0
    assert not plan.bits.permute(0, 2, 1).reshape(-1, 2)[dead].any()
    n_slots = int(plan.groups_s.sum()) * rg.TILE
    packed = rg.regroup_pack(plan, rays8, n_slots)
    grp_super = torch.repeat_interleave(torch.arange(2, dtype=torch.int32),
                                        plan.groups_s.long())
    out, work = rg.regroup_tritest_plain(packed, tables, grp_super)
    assert torch.equal(out, rg.regroup_tritest(packed, tables, grp_super))
    assert 0 < work["group_passes"] <= work["passes"]


def _numpy_walk_counts(packed, tables, grp_super):
    """Brute force in numpy float32: every slot against every cluster of
    its group's supercluster with the kernels' slab test (cluster_cull:
    NaN-propagating min/max, 1e-30 for a zero direction, the 1.00000024
    slack) against its tmax -> the counters of the tri-test's walk."""
    p = packed.numpy()
    sup, tab = tables.sup, tables.tab.numpy()
    boxes = tables.bbox.numpy().reshape(-1, sup, 8)
    n = len(p)
    sc = np.repeat(grp_super.numpy(), rg.TILE)
    o, d, tmin, tmax = p[:, 0:3], p[:, 3:6], p[:, 6], p[:, 7]
    inv = np.float32(1.0) / np.where(d == 0, np.float32(1e-30), d)
    b = boxes[sc]  # [n, sup, 8]
    with np.errstate(over="ignore", invalid="ignore"):
        t0 = (b[:, :, 0:3] - o[:, None]) * inv[:, None]
        t1 = (b[:, :, 3:6] - o[:, None]) * inv[:, None]
    enter = np.maximum(np.minimum(t0, t1).max(axis=2), tmin[:, None])
    exit_ = np.minimum(np.maximum(t0, t1).min(axis=2), tmax[:, None])
    want = enter <= exit_ * np.float32(1.00000024)  # [n, sup]
    warp_want = want.reshape(n // 32, 32, sup).any(axis=1)
    can_enter = tmin <= tmax * np.float32(1.00000024)
    real = (tab[:, 6:9] != 0).any(axis=1).sum(axis=1)  # [C]
    cl = sc[:, None] * sup + np.arange(sup)[None]
    return dict(passes=int(want.sum()), warps=n // 32,
                votes=int(can_enter.reshape(-1, 32).any(axis=1).sum()),
                warp_pairs=int(warp_want.sum()),
                tri_slots=int(real[cl][want].sum()))


def test_tritest_walk_counters_match_numpy(case):
    """The plain tri-test's counts of the kernel's per-warp walk (warps,
    mask votes, (warp, cluster) table loads, real-triangle lane slots)
    equal a numpy brute force over every (slot, cluster) pair; padding
    slots vote in no warp of their own."""
    tables = case["tables"]
    plan = rg.count_stage(_rays8(case["targs"]), tables.sbbox)
    n_slots = int(plan.groups_s.sum()) * rg.TILE
    packed = rg.regroup_pack(plan, _rays8(case["targs"]), n_slots)
    grp_super = torch.repeat_interleave(torch.arange(2, dtype=torch.int32),
                                        plan.groups_s.long())
    _, work = rg.regroup_tritest_plain(packed, tables, grp_super)
    want = _numpy_walk_counts(packed, tables, grp_super)
    assert {k: work[k] for k in want} == want
    # segments start on whole groups, live slots first: a warp votes iff
    # it holds a live slot
    assert work["votes"] == sum(-(-int(c) // 32) for c in plan.cnt_s)
    assert work["votes"] < work["warps"]
    assert work["group_passes"] <= work["warp_pairs"] <= work["passes"]
    assert 0 < work["tri_slots"] <= work["passes"] * 128


def test_tritest_infinite_tmax(case):
    """Live slots at tmax = +inf get the triangles they get at 3e38 (the
    scene lies well inside either), and a slot whose clusters hold no hit
    answers -1 with t = +inf, as the kernel's walk does (no cluster of a
    missing slot may win on t = tmax)."""
    tables = case["tables"]
    rays8 = _rays8(case["targs"])
    plan = rg.count_stage(rays8, tables.sbbox)
    n_slots = int(plan.groups_s.sum()) * rg.TILE
    packed = rg.regroup_pack(plan, rays8, n_slots)
    grp_super = torch.repeat_interleave(torch.arange(2, dtype=torch.int32),
                                        plan.groups_s.long())
    live = packed[:, 7] > 0
    finite, _ = rg.regroup_tritest_plain(packed, tables, grp_super)
    packed[live, 7] = float("inf")
    inf, work = rg.regroup_tritest_plain(packed, tables, grp_super)
    assert torch.equal(inf[:, 0], finite[:, 0])
    miss = live & (inf[:, 0] == -1)
    assert int(miss.sum()) > 0 and work["passes"] > 0
    assert torch.isinf(inf[miss, 1].view(torch.float32)).all()


def _rays8(targs):
    ro, rd, tmin, tmax = targs
    n = ro.shape[0]
    nb = -(-n // rg.TILE)
    rays8 = torch.zeros((nb * rg.TILE, 8))
    rays8[:, 7] = -1.0
    rays8[:n] = torch.cat([ro, rd, tmin[:, None], tmax[:, None]], dim=1)
    return rays8


def test_pack_is_stable_and_unpack_inverts_it(case):
    """Pack puts each set (tile, super, lane) bit's payload at its slot in
    (super, ray) order; unpack gives each ray its own slots back, merged
    over supers in index order with a strict `<`."""
    plan = rg.count_stage(_rays8(case["targs"]), case["tables"].sbbox)
    n_rays = plan.bits.shape[0] * rg.TILE
    ids = torch.zeros((n_rays, 8))
    ids[:, 0] = torch.arange(n_rays, dtype=torch.float32)
    n_slots = int(plan.groups_s.sum()) * rg.TILE
    packed = rg.regroup_pack(plan, ids, n_slots)
    # the stable (super, ray) order, padding slots at tmax = -1
    s_idx, t_idx, lane = torch.nonzero(plan.bits.permute(1, 0, 2), as_tuple=True)
    want_ids = (t_idx * rg.TILE + lane).float()
    real = packed[:, 7] == 0.0
    assert int(real.sum()) == want_ids.numel()
    assert torch.equal(packed[real, 0], want_ids)
    assert (packed[~real, :7] == 0.0).all() and (packed[~real, 7] == -1.0).all()
    for s in range(2):
        seg = packed[int(plan.seg_base[s]):][: int(plan.cnt_s[s]), 0]
        assert (seg[1:] > seg[:-1]).all()
    # trires: each slot answers (its ray id, t = 1 + its super)
    slot_super = torch.repeat_interleave(torch.arange(2), plan.groups_s.long() * rg.TILE)
    tri = torch.where(real, packed[:, 0].int(), -1)
    t = (1.0 + slot_super.float()).view(torch.int32)
    res = rg.regroup_unpack(plan, torch.stack([tri, t], dim=1))
    any_bit = plan.bits.any(dim=1).view(-1)
    first_super = plan.bits.int().argmax(dim=1).view(-1)
    assert torch.equal(res[any_bit, 0], torch.arange(n_rays)[any_bit].int())
    assert torch.equal(res[any_bit, 1].view(torch.float32),
                       1.0 + first_super[any_bit].float())
    assert (res[~any_bit, 0] == -1).all()
    assert torch.isinf(res[~any_bit, 1].view(torch.float32)).all()


@pytest.mark.parametrize("trigger", ["overflow", "livegate"])
def test_fallback_gives_the_worklist_result(soup, trigger):
    """A chunk over the packed capacity (blk_cap=64 blocks of 128 slots,
    less the JAX rule's slack) or under the liveness gate (90% dead
    lanes, gate 0.45) goes to the worklist kernel, and counts."""
    _, _, tables, _ = soup
    rng = np.random.default_rng(9)
    if trigger == "overflow":
        rays, kw = _rays(rng, 4 * 1024 + 77, True, dead=0.0), dict(blk_cap=64)
    else:
        rays, kw = _rays(rng, N_RAYS, True, dead=0.9), {}
    targs = [torch.from_numpy(x) for x in rays]
    fb0 = rg.regroup_intersect.fallbacks
    syncs = rg.regroup_intersect.host_syncs
    got = rg.regroup_intersect(tables, *targs, **kw)
    assert rg.regroup_intersect.fallbacks > fb0
    # the gate reads the live count and skips the count stage; an overflow
    # is seen in the group count, read after it
    assert rg.regroup_intersect.host_syncs == syncs + (
        1 if trigger == "livegate" else 2)
    order, cnt = wl.precull(*targs, tables.sbbox)
    want = wl.worklist_intersect_plain(tables, *targs, order, cnt)[0]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # with room and no gate the same rays take the kernels' path
    fb1 = rg.regroup_intersect.fallbacks
    check_hits(want, rg.regroup_intersect(tables, *targs, livegate=0.0))
    assert rg.regroup_intersect.fallbacks == fb1


def test_make_regroup_intersect_and_bad_input(soup):
    pv, inst, tables, _ = soup
    isect = rg.make_regroup_intersect(pv, inst, "cpu", livegate=0.2)
    assert isect.livegate == 0.2 and isect.tables.sup == wl.WL_SUPER
    assert torch.equal(isect.tables.tab, tables.tab)
    rays = [torch.from_numpy(x) for x in _rays(np.random.default_rng(2), 300, False)]
    syncs = rg.regroup_intersect.host_syncs
    check_hits(isect.primary(*rays), isect(*rays))
    # a live chunk: the live count, then the group count
    assert rg.regroup_intersect.host_syncs == syncs + 2
    meta = [torch.zeros(s, device="meta") for s in ((4, 3), (4, 3), (4,), (4,))]
    with pytest.raises(ValueError):
        rg.regroup_intersect(tables, *meta)
    plan = rg.count_stage(_rays8(rays), tables.sbbox)
    with pytest.raises(ValueError):  # the kernels take CUDA tensors only
        rg.regroup_unpack(plan, torch.zeros((0, 2), dtype=torch.int32,
                                            device="meta"))


def test_rays_that_enter_no_supercluster(soup):
    """No set bit at all (live rays pointing away from the soup): no
    group to pack or test, every ray misses with t = tmax, no fallback."""
    _, _, tables, _ = soup
    n = 700
    ro = torch.tensor([[2.0, 2.0, 2.0]]).repeat(n, 1)
    rd = torch.nn.functional.normalize(torch.rand(n, 3) + 0.1, dim=1)
    tmax = torch.full((n,), 3.0e38)
    fb = rg.regroup_intersect.fallbacks
    got = rg.regroup_intersect(tables, ro, rd, torch.full((n,), 1e-4), tmax)
    assert rg.regroup_intersect.fallbacks == fb
    assert not got.hit.any() and (got.prim == -1).all()
    assert torch.equal(got.t, tmax)


def test_chunks_agree(soup):
    """Rays over several chunks (20 tiles at chunk_blocks=16, the least
    the JAX rule allows) give the one-chunk result exactly, two host
    reads per live chunk."""
    _, _, tables, _ = soup
    rays = [torch.from_numpy(x)
            for x in _rays(np.random.default_rng(4), 20 * 1024 - 5, True)]
    whole = rg.regroup_intersect(tables, *rays)
    syncs = rg.regroup_intersect.host_syncs
    parts = rg.regroup_intersect(tables, *rays, chunk_blocks=16)
    assert rg.regroup_intersect.host_syncs == syncs + 4
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pairs", ["full", "lane0", "lane1023", "empty", "mixed"])
def test_pair_ranks_by_words_equals_ranks(pairs):
    """The kernels' word scan (pair_ranks_by_words: 32 words of 32 bits,
    popcounts, each word's offset) ranks every set lane as _ranks does, on
    pairs with all 1,024 lanes set, only lane 0, only lane 1,023, none,
    and a mixed hand-built plan; unset lanes get -1."""
    if pairs == "mixed":
        bits = regroup_bits(5, seed=1)
    else:
        bits = torch.zeros((2, 3, rg.TILE), dtype=torch.bool)
        if pairs == "full":
            bits[:, 1] = True
        elif pairs == "lane0":
            bits[:, :, 0] = True
        elif pairs == "lane1023":
            bits[:, :, 1023] = True
    got = rg.pair_ranks_by_words(bits)
    assert got.dtype == torch.int32 and got.shape == bits.shape
    assert torch.equal(got[bits], rg._ranks(bits)[bits])
    assert (got[~bits] == -1).all()
    if pairs == "full":
        assert torch.equal(got[0, 1], torch.arange(rg.TILE, dtype=torch.int32))


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("n_super", [1, 2, 188, 600])
def test_unpack_by_keys_equals_plain(n_super, padding):
    """The unpack kernel's key-min merge (unpack_by_keys) equals the serial
    walk (regroup_unpack_plain) on hand-built plans and adversarial trires:
    exact t ties across supers, misses at tmax, +-0, denormals, NaN, +-inf
    and negative t. Without padding every segment is whole groups."""
    bits = regroup_bits(n_super, padding=padding, seed=n_super)
    plan = rg.plan_from_bits(bits)
    assert bool((plan.cnt_s % rg.TILE != 0).any()) == padding
    n_slots = int(plan.groups_s.sum()) * rg.TILE
    trires = adversarial_trires(n_slots, seed=n_super)
    got = rg.unpack_by_keys(plan, trires)
    want = rg.regroup_unpack_plain(plan, trires)
    assert torch.equal(got, want)
    # some rays meet their least t in two or more supers, and the first wins
    t_i, s_i, lane = torch.nonzero(plan.bits, as_tuple=True)
    slot = (plan.base_ts[t_i, s_i] + rg._ranks(plan.bits)[t_i, s_i, lane]).long()
    ray = t_i * rg.TILE + lane
    at_best = trires[slot, 1] == want[ray, 1]
    ties = torch.bincount(ray[at_best], minlength=want.shape[0])
    if n_super > 1:
        assert int((ties > 1).sum()) > 0
    # hits, and rays left at (-1, +inf); with few supers a ray, also
    # misses merged at tmax
    t = want[:, 1].view(torch.float32)
    assert bool((want[:, 0] >= 0).any()) and bool(torch.isinf(t).any())
    if n_super <= 2:
        assert bool(((want[:, 0] == -1) & (t == 3e38)).any())
