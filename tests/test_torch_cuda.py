"""The port's CUDA kernels against their plain PyTorch versions on edge
cases, on the card. Marked `cuda`: they skip where no CUDA device is
available. Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU machine
need not have; this file imports only the port.)"""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    adversarial_rays, adversarial_trires, check_hits, check_vs_flat,
    cornell_scene, dense_soup, hybrid_scene, image_close, instanced_scene,
    regroup_bits, render_instanced, sphere_grid_scene,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _same_bits(got, want) -> bool:
    """Every field of two Hit tuples equal bit for bit (NaN included)."""
    return all(torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
               for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("q", [0, 1, 18, 37, di.MAX_PRIMS])
def test_dense_intersect_kernel_equals_plain(dev, q):
    """Random quads (half of them degenerate) at n = 5,000 random rays (not
    a multiple of the block size), then the adversarial soup's first q
    quads (mixed scales) against its adversarial rays (through vertices
    and along edges, zero and tiny det, -0.0, NaN and +-inf components)
    with tmin 1e-4, -0.0 or -1 and tmax finite, +-inf or -1: bit-equal."""
    g = np.random.default_rng(q)
    base = g.uniform(-1, 1, (q, 3)).astype(np.float32)
    e1 = g.uniform(-0.5, 0.5, (q, 3)).astype(np.float32)
    e2 = g.uniform(-0.5, 0.5, (q, 3)).astype(np.float32)
    verts = np.stack([base, base + e1, base + e1 + e2, base + e2], axis=1)
    verts[::2, 3] = verts[::2, 2]  # degenerate quads
    n = 5000
    ro = g.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = (g.normal(size=(n, 3)) - 0.3 * ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(g.random(n) < 0.1, -1.0, 1e30).astype(np.float32)
    tmin = np.full(n, 1e-4, np.float32)
    cases = [(verts, ro, rd, tmin, tmax)]
    if q:
        soup = dense_soup()[:q]
        ro, rd = adversarial_rays(soup, g)
        m = len(ro)
        tmin = np.where(np.arange(m) % 3 == 0, -0.0, 1e-4).astype(np.float32)
        tmin[1::7] = -1.0
        tmax = g.uniform(0.5, 5.0, m).astype(np.float32)
        tmax[::4], tmax[1::4], tmax[2::9] = np.inf, -np.inf, -1.0
        cases.append((soup, ro, rd, tmin, tmax))
    for verts, *rays in cases:
        table = di.make_dense_table(verts, g.integers(0, 50, q), dev)
        args = [torch.from_numpy(x).to(dev) for x in rays]
        got = di.dense_intersect(table, *args)
        want = di.dense_intersect_plain(table.prims, *args)
        assert _same_bits(got, want)
    assert bool(got.hit.any()) == (q > 0)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.3, 1.0])
def test_lane_compact_and_expand_kernels_equal_plain(dev, frac):
    g = np.random.default_rng(int(frac * 100))
    n, p = 64 * lc.TILE, 45
    alive = torch.from_numpy(g.random(n) < frac).to(dev)
    vals = torch.from_numpy(
        g.integers(-(2**31), 2**31, (p, n), dtype=np.int64).astype(np.int32)
    ).to(dev)
    total = int(alive.sum())
    for cap in (max(total, 1), n):
        got = lc.compact_planes(vals, alive, cap)
        want = lc.compact_planes_plain(vals, alive, cap)
        assert torch.equal(got[:, :total], want[:, :total])
        fallback = vals.flip(1).contiguous()
        assert torch.equal(lc.expand_planes(got, alive, fallback),
                           lc.expand_planes_plain(want, alive, fallback))


def test_kernels_reject_bad_input(dev):
    vals = torch.zeros((3, 1000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # not a multiple of 1024 lanes
        lc.compact_planes(vals, torch.zeros(1000, dtype=torch.bool, device=dev), 8)
    table = di.make_dense_table(np.zeros((4, 4, 3), np.float32), None, dev)
    with pytest.raises(ValueError):  # strided rays
        ro = torch.zeros((8, 6), device=dev)[:, :3]
        di.dense_intersect(table, ro, ro, torch.zeros(8, device=dev),
                           torch.zeros(8, device=dev))


@pytest.mark.parametrize("sup,group", [(2, 32), (8, 64), (16, 32),
                                       (wl.WL_SUPER, 32), (wl.WL_SUPER, 1024)])
def test_worklist_kernel_equals_plain(dev, sup, group):
    """Sphere grid (1,030 quads) at n = 5,000 rays (not a multiple of the
    group): camera rays, rays from inside the room with zero direction
    components, finite and dead (tmax = -1) lanes, work lists per `group`
    rays. Bit-equal expected."""
    _, cfg = build_device_scene(sphere_grid_scene(2, 16), device="cpu")
    tables = wl.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance,
                            sup=sup, device=dev)
    g = np.random.default_rng(sup)
    n = 5000
    ro = g.uniform([-0.95, 0.02, -0.95], [0.95, 1.95, 0.95], (n, 3))
    ro[: n // 2] = [0.0, 1.0, 3.9]
    rd = g.normal(size=(n, 3))
    rd[: n // 2, 2] = -np.abs(rd[: n // 2, 2]) - 2.0
    rd[::7, 1] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(g.random(n) < 0.1, -1.0, 3.4e38)
    tmax[::3] = g.uniform(0.2, 3.0, len(tmax[::3]))
    args = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
            (ro, rd, np.full(n, 1e-4), tmax)]
    order, cnt = wl.precull(*args, tables.sbbox, group)
    got = wl.worklist_intersect_kernel(tables, *args, order, cnt, group)
    want, work = wl.worklist_intersect_plain(tables, *args, order, cnt, group)
    torch.cuda.synchronize()
    check_hits(want, got)
    assert work["pairs"] > 0 and 0.3 < float(got.hit.float().mean()) < 1.0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(wl.worklist_intersect(tables, *args).prim, got.prim)


def test_render_on_card_matches_cpu(dev):
    scene = cornell_scene()
    params = Params(resolution=32, samples=2, batch=2, bounces=4, seed=1)
    images = []
    for device in (dev, "cpu"):
        r = Renderer(scene, params, device=device)
        st = make_trace_state(scene, params, device=device)
        r.trace_samples(st)
        images.append(r.get_image(st))
    image_close(*images)


def test_sphere_render_on_card_matches_cpu(dev):
    """The worklist kernel's path on the card against its plain version
    on the CPU, with the default device (the card) for the card side."""
    scene = sphere_grid_scene(2, 16)
    params = Params(resolution=32, samples=2, batch=2, bounces=4, seed=1)
    r = Renderer(scene, params)
    st = make_trace_state(scene, params)
    assert st.image.device.type == "cuda"
    wl.worklist_intersect_kernel.launches = 0
    r.trace_samples(st)
    assert wl.worklist_intersect_kernel.launches > 0
    rc = Renderer(scene, params, device="cpu")
    stc = make_trace_state(scene, params, device="cpu")
    rc.trace_samples(stc)
    image_close(r.get_image(st), rc.get_image(stc))


def _soup_quads():
    """12,000 small morton-ordered quads in the unit cube (2 superclusters
    of 128 clusters)."""
    g = np.random.default_rng(11)
    centers = g.random((12000, 3))
    centers = centers[np.argsort((centers * 64).astype(np.int64)
                                 @ np.array([4096, 64, 1]))]
    e1 = g.normal(size=(12000, 3)) * 0.02
    e2 = g.normal(size=(12000, 3)) * 0.02
    return np.stack([centers, centers + e1, centers + e1 + e2, centers + e2],
                    axis=1).astype(np.float32)


def _soup_tables(dev):
    """The soup's tables, 7 instances."""
    return wl.pack_tables(_soup_quads(), np.arange(12000) % 7, device=dev)


@pytest.mark.parametrize("divergent", [False, True])
def test_regroup_kernels_equal_plain(dev, divergent):
    """Each regroup kernel bit-equal to its plain version on the card, at
    n = 5,000 rays (not a multiple of 1024) with 10% dead lanes; the whole
    regroup intersector within check() of the worklist kernel."""
    tables = _soup_tables(dev)
    g = np.random.default_rng(int(divergent))
    n = 5000
    if divergent:
        ro = g.random((n, 3))
        rd = g.normal(size=(n, 3))
    else:
        ro = np.tile([0.5, 0.5, -1.0], (n, 1))
        rd = g.random((n, 3)) - [0.5, 0.5, -1.5]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(g.random(n) < 0.1, -1.0, 3.0e38)
    rays = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
            (ro, rd, np.full(n, 1e-4), tmax)]
    rays8 = torch.full((5 * 1024, 8), 0.0, device=dev)
    rays8[:, 7] = -1.0
    rays8[:n] = torch.cat([rays[0], rays[1], rays[2][:, None], rays[3][:, None]], 1)
    plan = rg.count_stage(rays8, tables.sbbox)
    n_groups = int(plan.groups_s.sum())
    grp_super = torch.repeat_interleave(
        torch.arange(len(plan.groups_s), dtype=torch.int32, device=dev),
        plan.groups_s.long())
    packed = rg.regroup_pack(plan, rays8, n_groups * 1024)
    want = rg.regroup_pack_plain(plan, rays8, n_groups * 1024)
    assert torch.equal(packed.view(torch.int32), want.view(torch.int32))
    tri = rg.regroup_tritest(packed, tables, grp_super)
    tri_want, work = rg.regroup_tritest_plain(packed, tables, grp_super)
    assert work["passes"] > 0 and torch.equal(tri, tri_want)
    res = rg.regroup_unpack(plan, tri)
    assert torch.equal(res, rg.regroup_unpack_plain(plan, tri))
    got = rg.regroup_intersect(tables, *rays)
    check_hits(wl.worklist_intersect(tables, *rays), got)
    # several chunks (16 tiles each, the least allowed) on 20 tiles
    many = [torch.cat([x] * 4)[: 20 * 1024] for x in rays]
    whole = rg.regroup_intersect(tables, *many)
    for a, b in zip(whole, rg.regroup_intersect(tables, *many, chunk_blocks=16)):
        assert torch.equal(a, b)
    cpu = rg.regroup_intersect(tables._replace(
        tab=tables.tab.cpu(), bbox=tables.bbox.cpu(), sbbox=tables.sbbox.cpu()),
        *(x.cpu() for x in rays))
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("sup", [1, 16, 64, 128])
def test_regroup_tritest_kernel_equals_plain(dev, sup):
    """The tri-test's warp walk bit-equal to its plain version on packed
    slots built by hand: 12 groups of 1024 slots over the soup's
    superclusters of `sup` clusters, group 3 all padding (tmax = -1),
    divergent rays from inside the soup with NaN origins and directions,
    +-inf tmax and -0.0 components, and rays at the quads of cluster 0,
    whose 64 quads cluster 1 repeats: where the two are in one super, the
    lower index wins every tie (no slot answers with cluster 1)."""
    g = np.random.default_rng(sup)
    pv = _soup_quads()
    pv[64:128] = pv[0:64]
    tables = wl.pack_tables(pv, np.arange(len(pv)) % 7, sup=sup, device=dev)
    n_super = tables.sbbox.shape[0]
    groups = 12
    grp_super = np.minimum(np.arange(groups) % 3, n_super - 1).astype(np.int32)
    n = groups * 1024
    o = g.random((n, 3))
    d = g.normal(size=(n, 3))
    # slots 0-1023 (group 0, super 0) aim at the quads of cluster 0
    quad = g.integers(0, 64, 1024)
    centre = pv[quad].mean(axis=1)
    nrm = np.cross(pv[quad, 1] - pv[quad, 0], pv[quad, 3] - pv[quad, 0])
    o[:1024] = centre + 0.01 * nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d[:1024] = centre - o[:1024]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4)
    tmax = np.where(g.random(n) < 0.1, np.inf, 3.0e38)
    tmax[::17] = g.uniform(0.01, 0.5, len(tmax[::17]))
    tmax[5::23] = -np.inf
    o[7::31, 1] = np.nan
    d[9::37, 2] = np.nan
    d[11::41, 0] = -0.0
    packed = np.concatenate([o, d, tmin[:, None], tmax[:, None]], axis=1)
    packed[3 * 1024:4 * 1024] = 0.0
    packed[3 * 1024:4 * 1024, 7] = -1.0
    packed = torch.tensor(packed, dtype=torch.float32, device=dev)
    grp = torch.from_numpy(grp_super).to(dev)
    got = rg.regroup_tritest(packed, tables, grp)
    want, work = rg.regroup_tritest_plain(packed, tables, grp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert work["passes"] > 0 and work["votes"] == work["warps"] - 32
    tri = got[:, 0]
    assert bool((tri[:1024] >= 0).float().mean() > 0.5)
    assert bool((tri[3 * 1024:4 * 1024] == -1).all())
    if sup > 1:
        assert not bool((tri // 128 == 1).any())


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("n_super", [1, 2, 188, 600])
def test_regroup_pack_unpack_kernels_equal_plain(dev, n_super, padding):
    """The pair walks of pack and unpack bit-equal to their plain versions
    at 1, 2, 188 (the heavy scene's) and 600 supers (more than one of
    unpack's 512-super passes), on hand-built plans (testing.regroup_bits:
    a pair with every lane set, pairs with only lane 1,023 or lane 0, an
    empty super from 3 supers on, most pairs empty; without padding every
    segment is whole groups), ray payloads of random bits (NaNs included),
    and unpack on the adversarial trires (ties across supers, misses at
    tmax, +-0, denormals, NaN, +-inf, negative t). Pack's output is
    allocated over stale values, so a slot it does not write shows."""
    bits = regroup_bits(n_super, padding=padding, seed=n_super)
    plan = rg.plan_from_bits(bits.to(dev))
    n_slots = int(plan.groups_s.sum()) * 1024
    g = torch.Generator().manual_seed(n_super)
    rays8 = torch.randint(-2**31, 2**31 - 1, (bits.shape[0] * 1024, 8),
                          generator=g, dtype=torch.int32).view(torch.float32).to(dev)
    stale = torch.full((n_slots, 8), 7.0, device=dev)
    del stale
    packed = rg.regroup_pack(plan, rays8, n_slots)
    want = rg.regroup_pack_plain(plan, rays8, n_slots)
    torch.cuda.synchronize()
    assert torch.equal(packed.view(torch.int32), want.view(torch.int32))
    trires = adversarial_trires(n_slots, seed=n_super).to(dev)
    res = rg.regroup_unpack(plan, trires)
    want = rg.regroup_unpack_plain(plan, trires)
    torch.cuda.synchronize()
    assert torch.equal(res, want)
    assert torch.equal(res, rg.unpack_by_keys(plan, trires))
    assert bool((res[:, 0] >= 0).any())


def test_heavy_path_render_on_card_matches_cpu(dev):
    """Sort + regroup (regroup="on", regroup_min_prims=0) on the card
    against the CPU, through the three regroup kernels."""
    scene = sphere_grid_scene(2, 16)
    params = Params(resolution=32, samples=2, batch=2, bounces=4, seed=1,
                    sort_rays=True, regroup="on", regroup_min_prims=0)
    r = Renderer(scene, params)
    st = make_trace_state(scene, params)
    rg.regroup_pack.launches = rg.regroup_tritest.launches = 0
    rg.regroup_unpack.launches = 0
    r.trace_samples(st)
    assert min(rg.regroup_pack.launches, rg.regroup_tritest.launches,
               rg.regroup_unpack.launches) > 0
    rc = Renderer(scene, params, device="cpu")
    stc = make_trace_state(scene, params, device="cpu")
    rc.trace_samples(stc)
    image_close(r.get_image(st), rc.get_image(stc))


def _room_rays(dev, n, seed):
    """n rays: half camera rays, half from random points in the room with
    zero direction components on some; 10% dead, a third short."""
    g = np.random.default_rng(seed)
    ro = g.uniform([-0.95, 0.02, -0.95], [0.95, 1.95, 0.95], (n, 3))
    ro[: n // 2] = [0.0, 1.0, 3.9]
    rd = g.normal(size=(n, 3))
    rd[: n // 2, 2] = -np.abs(rd[: n // 2, 2]) - 2.0
    rd[n // 2::7, 1] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(g.random(n) < 0.1, -1.0, 3.4e38)
    tmax[::3] = g.uniform(0.2, 3.0, len(tmax[::3]))
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in
            (ro, rd, np.full(n, 1e-4), tmax)]


def test_cluster_kernels_equal_plain(dev):
    """The sweep and streamed cluster kernels (82 clusters, 2 supers of 64)
    bit-equal to their plain versions at n = 5,000 rays, and within
    check_hits of the worklist intersector."""
    _, cfg = build_device_scene(sphere_grid_scene(3, 24), device="cpu")
    tables = ci.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance, dev)
    rays = _room_rays(dev, 5000, 3)
    for kernel, plain in (
            (ci.cluster_intersect_kernel, ci.cluster_intersect_plain),
            (ci.cluster_intersect_streamed_kernel,
             ci.cluster_intersect_streamed_plain)):
        got = kernel(tables, *rays)
        want, work = plain(tables, *rays)
        torch.cuda.synchronize()
        assert work["pairs"] > 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        check_hits(wl.worklist_intersect(tables, *rays), got)


def _edge_soup():
    """The soup's first 10,530 quads: 165 clusters (the sweep's steps of
    128 end in a tail of 37; 3 superclusters of 64, the last padded by 27),
    cluster 0's quads repeated as cluster 1 (the same mask word of the
    sweep's first step, the same supercluster) and cluster 2's as cluster
    70 (another word, another supercluster)."""
    pv = _soup_quads()[:10530].copy()
    pv[64:128] = pv[0:64]
    pv[70 * 64:71 * 64] = pv[128:192]
    return pv


@pytest.mark.parametrize("n", [1, 95, 3001])
def test_cluster_walks_equal_plain_at_edges(dev, n):
    """The sweep's and the streamed kernel's warp walks bit-equal to their
    plain versions on the first n of 3,001 rays (1, 95 and 3,001: a lone
    ray, part-filled warps, n not a multiple of 32 or 128) over
    _edge_soup(): rays 0-1023 aim at the quads of clusters 0 and 2, the
    rest start inside the soup in random directions (rays that want
    clusters in several mask words of a step and in the tail step); dead
    lanes (tmax = -1), tmax +inf and short, -0.0 direction components. The
    lower cluster wins every tie with its copy: no hit in clusters 1 or
    70."""
    pv = _edge_soup()
    tables = ci.pack_tables(pv, np.arange(len(pv)) % 7, dev)
    c = ci.n_clusters(tables)
    assert c == 165 and tables.sbbox.shape[0] == 3
    g = np.random.default_rng(8)
    m = 3001
    o = g.random((m, 3))
    d = g.normal(size=(m, 3))
    quad = g.integers(0, 64, 1024) + np.where(np.arange(1024) % 2 == 1, 128, 0)
    centre = pv[quad].mean(axis=1)
    nrm = np.cross(pv[quad, 1] - pv[quad, 0], pv[quad, 3] - pv[quad, 0])
    o[:1024] = centre + 0.01 * nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d[:1024] = centre - o[:1024]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[3::13, 0] = -0.0
    d[6::17, 2] = -0.0
    tmax = np.full(m, 3.0e38)
    tmax[2::7] = np.inf
    tmax[5::10] = -1.0
    tmax[9::19] = g.uniform(0.01, 0.5, len(tmax[9::19]))
    rays = [torch.tensor(x[:n], dtype=torch.float32, device=dev)
            for x in (o, d, np.full(m, 1e-4), tmax)]
    for kernel, plain in (
            (ci.cluster_intersect_kernel, ci.cluster_intersect_plain),
            (ci.cluster_intersect_streamed_kernel,
             ci.cluster_intersect_streamed_plain)):
        got = kernel(tables, *rays)
        want, work = plain(tables, *rays)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
        assert 0 < work["loads"] <= work["pairs"]
        cluster = got.prim[got.hit] // 64
        assert not bool(((cluster == 1) | (cluster == 70)).any())
    assert bool(got.hit[0])
    if n == m:
        inv = wl._inverse_dir(rays[1])
        wants = torch.stack([wl._cluster_cull(rays[0], inv, rays[2], rays[3],
                                              tables.bbox[k:k + 1])
                             for k in range(c)], dim=1)
        assert bool((wants[:, :32].any(1) & wants[:, 96:128].any(1)).any())
        assert bool(wants[:, 128:].any())
        assert float(got.hit[:1024].float().mean()) > 0.5


@pytest.mark.parametrize("group", [32, 256, 1024])
def test_candidate_cull_kernel_equals_plain(dev, group):
    """The candidate cull's keys bit-equal to its plain version at n =
    5,000 rays (a ragged last group) over the work items of a reduced
    instanced scene, with dead lanes and rays from inside the room; and
    the precull's lists on the card equal those of the plain keys."""
    _, cfg = build_device_scene(instanced_scene(3, (8, 6)), instancing=True,
                                hybrid_budget=0, device="cpu")
    tables = ii.upload(cfg.inst_tables, dev)
    rays = _room_rays(dev, 5000, 6)
    got = ii.candidate_keys_kernel(*rays, tables.wi_bbox, group)
    want = ii.candidate_keys_plain(*rays, tables.wi_bbox, group)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (-(-5000 // group), len(tables.wi_sup))
    assert torch.equal(got, want)
    finite = torch.isfinite(want)
    assert bool(finite.any()) and not bool(finite.all())  # padding, dead rays
    order, tlow, cnt = ii.precull(*rays, tables.wi_bbox, group)
    assert torch.equal(cnt, finite.sum(dim=1, dtype=torch.int32))
    assert torch.equal(tlow, want.gather(1, order.long()))
    with pytest.raises(ValueError):
        ii.candidate_keys_kernel(*rays, tables.wi_bbox, 48)


@pytest.mark.parametrize("group", [32, 128, 256])
@pytest.mark.parametrize("hybrid", [False, True])
def test_instanced_kernel_equals_plain(dev, hybrid, group):
    """The work-item kernel bit-equal to its plain version at n = 5,000
    rays on a reduced instanced scene (pure) or on the work items a hybrid
    build leaves, with candidate lists per 32, 128 and 256 rays; the whole
    intersector within check_vs_flat of the dense reference over the same
    scene flattened."""
    scene = hybrid_scene(4, 4, 3, 12) if hybrid else instanced_scene(3, (8, 6))
    d, cfg = build_device_scene(scene, instancing=True,
                                hybrid_budget=300 if hybrid else 0,
                                device="cpu")
    tables = ii.upload(cfg.inst_tables, dev)
    rays = _room_rays(dev, 5000, 4)
    lists = ii.precull(*rays, tables.wi_bbox, group)
    got = ii.instanced_intersect_kernel(tables, *rays, *lists, group=group)
    want, work = ii.instanced_intersect_plain(tables, *rays, *lists,
                                              group=group)
    torch.cuda.synchronize()
    assert work["pairs"] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if not hybrid:
        df, cf = build_device_scene(scene, instancing=False, device="cpu")
        ref = wl.make_worklist_intersect(cf.host_prim_verts,
                                         cf.host_prim_instance, dev)(*rays)
        check_vs_flat(ref, ii.instanced_intersect(tables, *rays))


@pytest.mark.parametrize("hybrid", [False, True])
def test_instanced_render_on_card_matches_cpu(dev, hybrid):
    """The instanced path (pure, or a hybrid whose soup takes the worklist
    kernel) on the card against the CPU, through the work-item kernel."""
    scene = hybrid_scene(4, 4, 3, 12) if hybrid else instanced_scene(3, (8, 6))
    budget = 300 if hybrid else 0
    ii.instanced_intersect_kernel.launches = 0
    wl.worklist_intersect_kernel.launches = 0
    got = render_instanced(scene, 32, 2, 4, budget, dev, seed=1)
    assert ii.instanced_intersect_kernel.launches > 0
    assert (wl.worklist_intersect_kernel.launches > 0) == hybrid
    image_close(got, render_instanced(scene, 32, 2, 4, budget, "cpu", seed=1))
