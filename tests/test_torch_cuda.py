"""The port's CUDA kernels against their plain PyTorch versions on edge
cases, on the card. Marked `cuda`: they skip where no CUDA device is
available. Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU machine
need not have; this file imports only the port.)"""

import functools
import time
from unittest import mock

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops import row_gather as rgat
from julia_raytracer_tpu_torch.ops.diff_hit import (
    make_diff_intersect, make_diff_intersect_instanced,
)
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.render import diff as tdiff
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, camera_arrays, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    adversarial_rays, adversarial_trires, check_hits, check_vs_flat,
    cornell_scene, cull_boxes, cull_rays, dense_soup, grads_close,
    hairball_scene, hybrid_scene, image_close, instanced_scene,
    lit_panels_scene, many_lights_scene, param_grads, regroup_bits,
    render_instanced, same_lists, sphere_grid_scene, sphereflake_scene,
    vertex_grads,
)
from julia_raytracer_tpu_torch.utils import timing

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


def _lists_on_card(dev, rays, cl, group):
    """The cull kernel's lists and counters with no host read, against
    the plain lists on the card and cluster_pass_plain's counts."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        *got, counts = ii.candidate_lists_kernel(*rays, cl, group)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ii.candidate_lists_plain(*rays, cl.boxes, group)
    torch.cuda.synchronize()
    ng, items = -(-rays[0].shape[0] // group), cl.slot_item.shape[0]
    assert got[0].shape == got[1].shape == (ng, items)
    assert same_lists(got, want)
    _, plain = ii.cluster_pass_plain(*rays, cl, group)
    for k in ("tested", "cluster_tests", "item_tests"):
        assert int(counts[k]) == int(plain[k]), k
    assert int(counts["spills"]) == int((want[2] > ii.LIST_CAP).sum())
    return got, counts


@pytest.mark.parametrize("group", [32, 256, 1024])
def test_candidate_cull_kernel_equals_plain(dev, group):
    """The cull kernel's lists (order[:, :cnt], tlow[:, :cnt], cnt) bit-equal
    to the plain lists (the plain keys, a stable argsort) at n = 5,000
    rays (a ragged last group) over the work items of a reduced instanced
    scene, with dead lanes and rays from inside the room, and over 1,500
    random boxes (47 clusters) against testing.cull_rays (NaN and
    infinite 1 / d); its counters equal cluster_pass_plain's; no host
    read."""
    _, cfg = build_device_scene(instanced_scene(3, (8, 6)), instancing=True,
                                hybrid_budget=0, device="cpu")
    tables = ii.upload(cfg.inst_tables, dev)
    rays = _room_rays(dev, 5000, 6)
    (order, tlow, cnt), counts = _lists_on_card(dev, rays, tables.clusters,
                                                group)
    assert 0 < int(cnt.sum()) < cnt.numel() * len(tables.wi_sup)
    assert int(counts["spills"]) == 0
    cl = ii.item_clusters(cull_boxes(1500, seed=group).to(dev))
    lo, hi = cl.root[:3].tolist(), cl.root[3:].tolist()
    (_, _, cnt), counts = _lists_on_card(
        dev, cull_rays(lo, hi, 5000, seed=group, device=dev), cl, group)
    assert int(cnt.sum()) > 0 and int(counts["tested"]) > 0
    with pytest.raises(ValueError):
        ii.candidate_lists_kernel(*rays, tables.clusters, 48)


@pytest.mark.parametrize("group", [256, 1024])
@pytest.mark.parametrize("case", ["every_item", "mixed"])
def test_candidate_cull_kernel_spills(dev, case, group):
    """Groups past the shared list (LIST_CAP candidates) sort in their rows
    of order and tlow: every one of 3,000 boxes about the origin entered
    by every ray from it (cnt = every item, keys all +0: order by item);
    or 2,500 boxes about (5, 5, 5) entered by the groups from there (some
    with keys all +0 at a short tmax) beside 2,500 small random boxes that
    coherent groups enter a few of. Bit-equal to the plain lists, the
    spills counted."""
    g = np.random.default_rng(group)
    n = 8 * group + 77
    if case == "every_item":
        half = g.uniform(0.5, 1.0, (3000, 3))
        boxes = np.concatenate([-half, half], axis=1)
        ro = g.uniform(-0.1, 0.1, (n, 3))
        rd = g.normal(size=(n, 3))
        tmax = np.full(n, 3.4e38)
    else:
        c = np.concatenate([g.uniform(4.9, 5.1, (2500, 3)),
                            g.uniform(-1, 1, (2500, 3))])
        h = np.concatenate([g.uniform(0.3, 0.6, (2500, 3)),
                            g.uniform(0.001, 0.05, (2500, 3))])
        boxes = np.concatenate([c - h, c + h], axis=1)
        ro = np.repeat(g.uniform(-1, 1, (-(-n // 32), 3)), 32, axis=0)[:n]
        rd = np.repeat(g.normal(size=(-(-n // 32), 3)), 32, axis=0)[:n]
        rd += g.normal(size=(n, 3)) * 0.01
        spill = (np.arange(n) // group) % 3 == 0
        ro[spill] = 5.0 + g.normal(size=(int(spill.sum()), 3)) * 0.01
        rd[spill] = g.normal(size=(int(spill.sum()), 3))
        tmax = np.where((np.arange(n) // group) % 6 == 3, 1e-3, 3.4e38)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays = [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (ro, rd, np.full(n, 1e-4), tmax)]
    cl = ii.item_clusters(torch.tensor(boxes, dtype=torch.float32, device=dev))
    (_, _, cnt), counts = _lists_on_card(dev, rays, cl, group)
    assert int(counts["spills"]) > 0
    if case == "every_item":
        assert bool((cnt == 3000).all())
    else:
        assert int(cnt.min()) < ii.LIST_CAP < int(cnt.max())


def test_candidate_cull_flake_camera_body(dev):
    """A full-size 1,048,576-lane camera body of the sphereflake cell (the
    first 1,048,576 pixels of 1280 x 1280, 22,143 work items, 692
    clusters) through the cull kernel: lists bit-equal to the plain lists
    on the card, counters equal to cluster_pass_plain's."""
    scene = sphereflake_scene()
    _, cfg = build_device_scene(scene, device="cpu")
    cl = ii.upload(cfg.inst_tables, dev).clusters
    res, n = 1280, 1 << 20
    pix = torch.arange(n, device=dev)
    ij = torch.stack([pix % res, pix // res], dim=-1)
    half = torch.full((n, 2), 0.5, device=dev)
    ro, rd = sample_camera(camera_arrays(scene.cameras[0], dev), ij,
                           (res, res), half, half, False)
    rays = (ro.contiguous(), rd.contiguous(), torch.full((n,), 1e-4, device=dev),
            torch.full((n,), 3.4e38, device=dev))
    (_, _, cnt), counts = _lists_on_card(dev, rays, cl, ii.GROUP_RAYS)
    assert cl.cluster_boxes.shape[0] == 692 and int(cnt.sum()) > 0
    assert int(counts["tested"]) < cnt.numel() * 22_143


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


def test_instanced_spans_time_by_events_on_card(dev, monkeypatch):
    """The sphereflake at size factor 2 through the full cell's route on
    the card: `precull` and `inst_walk` hold their clock (a 0-d int64
    tensor of stamps) and the candidate count as tensors on the card
    until units() reads them, then carry device_ns; a frame with plain spans in their place makes the same
    host syncs and the same image."""
    from julia_raytracer_tpu_torch.render import scene_device

    monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
    scene = sphereflake_scene(2, 4)
    params = Params(resolution=256, samples=2, batch=1, bounces=8,
                    hybrid_budget=8)

    def frame():
        r = Renderer(scene, params, device=dev)
        st = make_trace_state(scene, params, device=dev)
        syncs = tint.trace_wavefront.host_syncs
        r.trace_samples(st)
        torch.cuda.synchronize()
        return r.get_image(st), tint.trace_wavefront.host_syncs - syncs

    timing.reset()
    image, syncs = frame()
    raw = timing._state.units[-1]["table"]
    pending = [(k, v) for path, row in raw.items()
               if path.endswith("/precull") for k, v in row[4]]
    clocks = [v for k, v in pending if k == "device_ns"]
    assert clocks and all(v.is_cuda and v.dtype == torch.int64
                          and v.dim() == 0 for v in clocks)
    assert any(k == "candidates" and v.is_cuda for k, v in pending)
    table = timing.units()[-1]["table"]
    rows = [row for path, row in table.items()
            if path.endswith(("/precull", "/inst_walk"))]
    assert len(rows) >= 4 and all(row["device_ns"] > 0 for row in rows)
    assert sum(row.get("candidates", 0) for row in rows) > 0

    class Plain(timing.span):
        __slots__ = ()

        def add(self, **counts):
            pass

    monkeypatch.setattr(timing, "device_span",
                        lambda name, device, **counts: Plain(name))
    plain_image, plain_syncs = frame()
    assert plain_syncs == syncs
    np.testing.assert_array_equal(image, plain_image)


@pytest.mark.parametrize("scene", ["cornell", "spheres"])
def test_diff_hit_forward_equals_the_kernel(dev, scene):
    """The differentiable hit's forward values (rays and corners requiring
    grad) are the kernel's own, bit for bit: the dense kernel on the
    Cornell box, the worklist kernel on the sphere grid."""
    make = cornell_scene if scene == "cornell" else lambda: sphere_grid_scene(2, 16)
    r = Renderer(make(), Params(resolution=64, bounces=4), device=dev)
    g = np.random.default_rng(5)
    n = 4096
    ro = torch.tensor(np.tile([0.0, 1.0, 3.9], (n, 1)), dtype=torch.float32,
                      device=dev)
    rd = torch.tensor(g.normal(size=(n, 3)) * [0.1, 0.1, 0.02]
                      - [0.0, 0.1, 1.0], dtype=torch.float32, device=dev)
    rd = (rd / rd.norm(dim=1, keepdim=True)).requires_grad_()
    tmin = torch.full((n,), 1e-4, device=dev)
    tmax = torch.full((n,), 3.4e38, device=dev)
    pv = r.dscene.prim_verts.clone().requires_grad_()
    got = make_diff_intersect(r.intersect, pv)(ro, rd, tmin, tmax)
    want = r.intersect(ro, rd.detach(), tmin, tmax)
    assert got.u.requires_grad and float(want.hit.float().mean()) > 0.5
    assert _same_bits(tuple(x.detach() for x in got), want)


def test_dense_kernel_runs_in_the_backward_recompute(dev):
    """The fixed-trip loop launches the dense kernel once for the camera
    rays and once a body, and the backward pass launches it again in each
    body's recompute."""
    r = Renderer(cornell_scene(), Params(resolution=32, bounces=4), device=dev)
    opts = tdiff.diff_options(r.options, r.config)
    color = r.dscene.materials.color.clone().requires_grad_()
    d = r.dscene._replace(materials=r.dscene.materials._replace(color=color))
    di.dense_intersect.launches = 0
    rad = tdiff.render_radiance(d, r.config, opts, r.cam_arrays, 32, 32,
                                torch.arange(1024, dtype=torch.int32,
                                             device=dev), 0,
                                intersector=r.intersect)
    assert di.dense_intersect.launches == 1 + opts.fixed_iterations
    rad.sum().backward()
    assert di.dense_intersect.launches == 1 + 2 * opts.fixed_iterations
    assert torch.isfinite(color.grad).all() and color.grad.abs().sum() > 0


def test_diff_grads_on_card_match_cpu(dev):
    """Colour and emission gradients of the pixel loss on the card against
    the CPU's, within testing.GRAD_TOL (the tolerance of chip_smoke.py's
    phase diff)."""
    scene = cornell_scene()
    card = param_grads(scene, 32, dev, bounces=4)
    cpu = param_grads(scene, 32, "cpu", bounces=4)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-3)
    for got, want in zip(card[1:], cpu[1:]):
        grads_close(got, want)


def _instanced_case(hybrid):
    """A reduced instanced scene (pure) or hybrid (a 262-quad soup through
    the worklist kernel, 3 big spheres as work items) and its budget."""
    if hybrid:
        return hybrid_scene(4, 4, 3, 12), 300
    return instanced_scene(3, (8, 6)), 0


@pytest.mark.parametrize("hybrid", [False, True])
def test_diff_hit_instanced_forward_equals_the_kernels(dev, hybrid):
    """The instanced re-test's forward values (rays and shape-space
    corners requiring grad) are the cull's and the work-item kernel's,
    bit for bit; a hybrid's wrapped and composed branches the hybrid's
    (the worklist kernel for the soup)."""
    scene, budget = _instanced_case(hybrid)
    d, cfg = build_device_scene(scene, instancing=True, hybrid_budget=budget,
                                device=dev)
    isect = tint.build_intersector(d, cfg)
    ro, rd, tmin, tmax = _room_rays(dev, 5000, 6)
    rd = rd.clone().requires_grad_()
    pv = d.prim_verts.clone().requires_grad_()
    if hybrid:
        wrapped = isect.differentiable(d._replace(prim_verts=pv))
    else:
        rows = torch.as_tensor(cfg.inst_tables.inst_rows, device=dev)
        wrapped = make_diff_intersect_instanced(isect, pv, rows)
    ii.instanced_intersect_kernel.launches = 0
    ii.candidate_lists_kernel.launches = 0
    got = wrapped(ro, rd, tmin, tmax)
    assert ii.instanced_intersect_kernel.launches == 1
    assert ii.candidate_lists_kernel.launches == 1
    want = isect(ro, rd.detach(), tmin, tmax)
    assert got.u.requires_grad and int(want.hit.sum()) > 500
    assert _same_bits(tuple(x.detach() for x in got), want)


@pytest.mark.parametrize("hybrid", [False, True])
def test_instanced_diff_grads_on_card_match_cpu(dev, hybrid):
    """Colour, emission and shape-space vertex gradients on the reduced
    instanced scene (pure and hybrid) on the card against the CPU's,
    within testing.GRAD_TOL, with the work-item kernel and the cull (and
    the soup's worklist kernel) launched."""
    scene, budget = _instanced_case(hybrid)
    ii.instanced_intersect_kernel.launches = 0
    ii.candidate_lists_kernel.launches = 0
    wl.worklist_intersect_kernel.launches = 0
    card = param_grads(scene, 32, dev, bounces=4, hybrid_budget=budget)
    card_v = vertex_grads(scene, 32, dev, budget, bounces=4)
    assert ii.instanced_intersect_kernel.launches > 0
    assert ii.candidate_lists_kernel.launches > 0
    assert (wl.worklist_intersect_kernel.launches > 0) == hybrid
    cpu = param_grads(scene, 32, "cpu", bounces=4, hybrid_budget=budget)
    cpu_v = vertex_grads(scene, 32, "cpu", budget, bounces=4)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-3)
    np.testing.assert_allclose(card_v[0], cpu_v[0], rtol=1e-3)
    for got, want in zip(card[1:] + card_v[1:], cpu[1:] + cpu_v[1:]):
        grads_close(got, want)


def test_row_gather_backward_on_card(dev):
    """The material gathers' backward on the card (the one-hot product)
    at 262,144 lanes onto 7 rows: bit-equal across two calls, and within
    float32 rounding of index_add_ in float64."""
    g = np.random.default_rng(3)
    n, rows = 262_144, 7
    idx = torch.as_tensor(g.integers(0, rows, n), device=dev)
    table = torch.as_tensor(g.uniform(0, 1, (rows, 3)), dtype=torch.float32,
                            device=dev)
    grad = torch.as_tensor(g.normal(size=(n, 3)), dtype=torch.float32,
                           device=dev)
    sums = []
    for _ in range(2):
        leaf = table.clone().requires_grad_()
        (out,) = rgat.gather_rows(idx, leaf)
        assert torch.equal(out.detach(), table[idx])
        out.backward(grad)
        sums.append(leaf.grad)
    assert torch.equal(sums[0], sums[1])
    want = torch.zeros((rows, 3), dtype=torch.float64, device=dev).index_add_(
        0, idx, grad.double())
    np.testing.assert_allclose(sums[0].cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-4)


def test_hairball_render_on_card_matches_cpu(dev):
    """Lines and points (render/integrator.py curve_wrap's sweep, on the
    card) around the dense kernel, against the CPU."""
    scene = hairball_scene(200, 3, 24)
    params = Params(resolution=32, samples=2, batch=2, bounces=4, seed=1)
    images = []
    di.dense_intersect.launches = 0
    for device in (dev, "cpu"):
        r = Renderer(scene, params, device=device)
        st = make_trace_state(scene, params, device=device)
        r.trace_samples(st)
        images.append(r.get_image(st))
    assert di.dense_intersect.launches > 0
    assert r.config.n_lines == 600 and r.config.n_points == 24
    image_close(*images)


def test_many_lights_march_on_card_matches_cpu(dev):
    """The truncated-march light pdf (4,160 emissive quads) through the
    worklist kernel: one launch a sample for the camera rays and
    1 + steps a loop body; the image against the CPU's."""
    scene = many_lights_scene((64, 65))
    params = Params(resolution=32, samples=1, batch=1, bounces=3, seed=1)
    r = Renderer(scene, params, device=dev)
    steps = r.options.light_pdf_extra_steps
    assert steps == 4
    st = make_trace_state(scene, params, device=dev)
    wl.worklist_intersect_kernel.launches = 0
    t0 = time.perf_counter_ns()
    r.trace_samples(st)
    bodies = sum(row["n"] for u in timing.units() if u["start_ns"] >= t0
                 for path, row in u["table"].items() if path.endswith("/body"))
    assert wl.worklist_intersect_kernel.launches == 1 + bodies * (1 + steps)
    rc = Renderer(scene, params, device="cpu")
    stc = make_trace_state(scene, params, device="cpu")
    rc.trace_samples(stc)
    image_close(r.get_image(st), rc.get_image(stc))


def _kernel_reports(fn):
    from julia_raytracer_tpu_torch.utils.roofline import count_cost

    _, counter = count_cost(fn)
    return counter.kernels


def test_kernel_cost_reports_on_card_equal_cpu(dev):
    """Each dispatcher reports the same kernel_flops cost on the card (the
    kernel) as on the CPU (its plain version) for the same call: the
    counts come from the call's inputs and its bit-equal outputs."""
    g = np.random.default_rng(4)

    def rays(n, lo, hi):
        o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
        d = g.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.where(g.random(n) < 0.1, -1.0, 3.4e38).astype(np.float32)
        return [torch.from_numpy(x) for x in
                (o, d, np.full(n, 1e-4, np.float32), tmax)]

    room = rays(3000, [-0.9, 0.1, -0.9], [0.9, 1.9, 0.9])
    _, cfg = build_device_scene(sphere_grid_scene(3, 16), device="cpu")
    _, cor = build_device_scene(cornell_scene(), device="cpu")
    _, icfg = build_device_scene(instanced_scene(3, (8, 6)), instancing=True,
                                 hybrid_budget=0, device="cpu")
    lo, hi = icfg.world_bounds
    irays = rays(3000, lo, hi)
    vals = torch.from_numpy(g.integers(-9, 9, (5, 4096)).astype(np.int32))
    alive = torch.from_numpy(g.random(4096) < 0.4)

    def calls(device):
        put = [x.to(device) for x in room]
        iput = [x.to(device) for x in irays]
        dense = di.make_dense_table(cor.host_prim_verts, cor.host_prim_instance,
                                    device)
        tables = wl.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance,
                                device=device)
        ctab = ci.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance,
                              device)
        itab = ii.upload(icfg.inst_tables, device)
        v, a = vals.to(device), alive.to(device)
        return [
            lambda: di.dense_intersect(dense, *put),
            lambda: lc.expand_planes(lc.compact_planes(v, a, 2048), a, v),
            lambda: wl.worklist_intersect(tables, *put),
            lambda: rg.regroup_intersect(tables, *put, livegate=0.0),
            lambda: ci.cluster_intersect(ctab, *put),
            lambda: ci.cluster_intersect_streamed(ctab, *put),
            lambda: ii.instanced_intersect(itab, *iput),
        ]

    for on_card, on_cpu in zip(calls(dev), calls("cpu"), strict=True):
        card, cpu = _kernel_reports(on_card), _kernel_reports(on_cpu)
        assert card and card == cpu


def _cornell_frames(r, st, frames):
    """`frames` frames of `r`: the state's image, AOVs and hits, and per
    frame the dense kernel's launches and the loop tests."""
    counts = []
    for _ in range(frames):
        di.dense_intersect.launches = tint.trace_wavefront.host_syncs = 0
        r.trace_samples(st)
        torch.cuda.synchronize()
        body = timing.units()[-1]["table"]["frame/chunk/wavefront/body"]
        counts.append((di.dense_intersect.launches,
                       tint.trace_wavefront.host_syncs, body["n"],
                       body["graphed"]))
    return [x.clone() for x in (st.image, st.albedo, st.normal, st.hits)], counts


@pytest.mark.parametrize("sort", [False, True])
def test_replayed_frames_equal_eager_on_card(dev, sort):
    """The Cornell box at 1280², 8 bounces, path sampler: 2 chunks of
    1,048,576 lanes with compaction (4 widths unsorted, 6 sorted). Frames
    whose bodies replay CUDA graphs equal eager frames bit for bit over 3
    frames (image, albedo, normal, hits), with the same dense launches,
    loop tests and bodies a frame; the first frame's first chunk sights
    every width, its second captures them, and the third frame only
    replays."""
    scene = cornell_scene()
    params = Params(resolution=1280, samples=1 << 20, batch=1, bounces=8,
                    seed=5, sort_rays=sort)
    runs = []
    for graphed in (True, False):
        r = Renderer(scene, params, device=dev)
        if not graphed:
            r.body_graphs = None
        st = make_trace_state(scene, params, device=dev)
        runs.append(_cornell_frames(r, st, 3))
        if graphed:
            graphs = r.body_graphs
            assert graphs.captures == len(graphs.graphs) >= 4
            assert not graphs.failed
    (got, got_counts), (want, want_counts) = runs
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert [c[:3] for c in got_counts] == [c[:3] for c in want_counts]
    assert want_counts[0][0] > 0 and all(c[3] == 0 for c in want_counts)
    assert got_counts[2][3] == got_counts[2][2]  # every body a replay


def _flake_frames(dev, graphed, frames=3):
    """`frames` frames of the sphereflake at size factor 2 through the full
    cell's route (a 4-quad soup through the dense kernel, 91 work items)
    at 1280², 8 bounces, from graphs or eager -> (image, AOVs and hits;
    the frames' precull rows; the body rows; the Renderer)."""
    from julia_raytracer_tpu_torch.render import scene_device

    real = scene_device._should_instance
    scene_device._should_instance = lambda s: True
    try:
        scene = sphereflake_scene(2, 4)
        params = Params(resolution=1280, samples=1 << 20, batch=1,
                        bounces=8, seed=5, hybrid_budget=8)
        r = Renderer(scene, params, device=dev)
    finally:
        scene_device._should_instance = real
    assert isinstance(r.intersect.tables[0], di.DenseTable)
    if not graphed:
        r.body_graphs = None
    st = make_trace_state(scene, params, device=dev)
    t0 = timing._now()
    for _ in range(frames):
        r.trace_samples(st)
    torch.cuda.synchronize()
    tables = [u["table"] for u in timing.units() if u["start_ns"] >= t0]

    def rows(name):
        return [row for t in tables for path, row in t.items()
                if path.endswith("/" + name)]

    return ([x.clone() for x in (st.image, st.albedo, st.normal, st.hits)],
            rows("precull"), rows("body"), r)


def test_replayed_flake_frames_equal_eager_on_card(dev):
    """The instanced hybrid over a dense-kernel soup replays its bodies
    from CUDA graphs: over 3 frames the graphed frames equal eager ones
    bit for bit, widths capture and none fails, and the precull rows,
    replays included, count what the eager trace counts (n, candidates,
    tested), each with a positive device_ns."""
    got, got_pre, got_body, r = _flake_frames(dev, True)
    want, want_pre, want_body, _ = _flake_frames(dev, False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    graphs = r.body_graphs
    assert r.intersect.graph_safe
    assert graphs.captures >= 1 and not graphs.failed
    assert sum(row["graphed"] for row in got_body) > 0
    assert sum(row["graphed"] for row in want_body) == 0
    for key in ("n", "candidates", "tested"):
        assert (sum(row[key] for row in got_pre)
                == sum(row[key] for row in want_pre)), key
    assert all(row["device_ns"] > 0 for row in got_pre + want_pre)


def test_two_renderers_render_in_turn(dev):
    """Two Renderers on one scene, each with its own graphs and buffers,
    rendering frames in turn: each equals a Renderer that renders alone."""
    scene = cornell_scene()
    params = Params(resolution=256, samples=1 << 20, batch=1, bounces=8,
                    seed=2)
    pair = [Renderer(scene, params, device=dev) for _ in range(2)]
    states = [make_trace_state(scene, params, device=dev) for _ in range(2)]
    states[1].samples = 7  # another sample sequence
    for _ in range(3):
        for r, st in zip(pair, states):
            r.trace_samples(st)
    bufs = [{b for g in r.body_graphs.graphs.values() for b in g.buffers}
            for r in pair]
    assert bufs[0] and bufs[1] and not bufs[0] & bufs[1]
    for r, st in zip(pair, states):
        alone = Renderer(scene, params, device=dev)
        alone.body_graphs = None
        st_a = make_trace_state(scene, params, device=dev)
        st_a.samples = st.samples - 3
        for _ in range(3):
            alone.trace_samples(st_a)
        for a, b in zip((st.image, st.albedo, st.normal, st.hits),
                        (st_a.image, st_a.albedo, st_a.normal, st_a.hits)):
            assert torch.equal(a, b)


def test_sample_kernel_cost_same_after_capture_on_card(dev):
    """sample_kernel_cost runs eagerly under its TorchDispatchMode: the
    same counts before and after the graphs are captured, and no replay
    inside it. The kernels' flops are left out: the dense kernel's count
    its pre-test's passes over every lane, and the compaction kernel
    leaves the slack lanes' bits unspecified, so they differ between any
    two calls."""
    scene = cornell_scene()
    params = Params(resolution=256, samples=1 << 20, batch=1, bounces=8,
                    seed=2)
    r = Renderer(scene, params, device=dev)
    st = make_trace_state(scene, params, device=dev)
    before = r.sample_kernel_cost(st)
    work = make_trace_state(scene, params, device=dev)
    for _ in range(2):
        r.trace_samples(work)
    assert r.body_graphs.captures > 0
    replays = r.body_graphs.replays
    after = r.sample_kernel_cost(st)
    assert r.body_graphs.replays == replays
    assert before["ops"] == after["ops"]

    def calls_and_bytes(cost):
        return {k: (v[0], v[2]) for k, v in cost["kernels"].items()}

    assert calls_and_bytes(before) == calls_and_bytes(after)


def test_worklist_scene_makes_no_capture(dev):
    """The sphere grid (1,030 quads) takes the worklist kernel, which
    reads the host: its bodies stay eager."""
    scene = sphere_grid_scene(2, 16)
    params = Params(resolution=64, samples=1 << 20, batch=1, bounces=4,
                    seed=1)
    r = Renderer(scene, params, device=dev)
    st = make_trace_state(scene, params, device=dev)
    for _ in range(3):
        r.trace_samples(st)
    graphs = r.body_graphs
    assert not r.intersect.graph_safe
    assert graphs.captures == graphs.replays == 0 and not graphs.seen


def test_refused_capture_leaves_the_width_eager_on_card(dev):
    """A body that copies from host memory cannot be captured: its width
    stays eager, the card works on, and another width still captures."""
    from typing import NamedTuple

    from julia_raytracer_tpu_torch.render.body_graphs import BodyGraphs

    class S(NamedTuple):
        alive: torch.Tensor
        x: torch.Tensor

    def host_copy(s):
        return S(s.alive, s.x + torch.tensor([1.0, 2.0, 3.0], device=dev))

    def plain(s):
        return S(s.alive, s.x * 2.0 + 1.0)

    graphs = BodyGraphs()
    s = S(torch.ones(1024, dtype=torch.bool, device=dev),
          torch.zeros((1024, 3), device=dev))
    for _ in range(3):
        s, graphed = graphs.run(host_copy, s)
        assert not graphed
    assert graphs.failed == {1024}
    assert torch.equal(s.x[0].cpu(), torch.tensor([3.0, 6.0, 9.0]))
    t = S(torch.ones(2048, dtype=torch.bool, device=dev),
          torch.zeros((2048, 3), device=dev))
    flags = []
    for _ in range(4):
        t, graphed = graphs.run(plain, t)
        flags.append(graphed)
    assert flags == [False, True, True, True]
    assert torch.equal(t.x, torch.full((2048, 3), 15.0, device=dev))


def _hairball_rays(g, n, dev):
    """Rays at the hairball from all round it, n not a multiple of the
    warp: a tenth dead (tmax -1), a few with NaN or zero directions."""
    ro = g.uniform(-1.5, 1.5, (n, 3)) + [0.0, 1.0, 0.0]
    rd = g.normal(size=(n, 3)) - 0.5 * (ro - [0.0, 1.0, 0.0])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:7] = np.nan
    rd[7:11] = 0.0
    tmax = np.where(g.random(n) < 0.1, -1.0, 3.4e38)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (ro, rd, np.full(n, 1e-4), tmax))


@pytest.mark.parametrize("group", [32, 256])
def test_curve_walk_kernel_equals_plain(dev, group):
    """The hairball's 4,352 lines and points (testing.hairball_scene)
    against 5,001 rays: the walk kernel equals curve_walk_plain on the
    same lists bit for bit (closest line and point, and the pairs
    tested), and the route's merged hits equal the plain sweep's."""
    from julia_raytracer_tpu_torch.ops import curve_intersect as cw

    scene = hairball_scene(1024, 4, 256)
    r = Renderer(scene, Params(resolution=64, samples=1, batch=1),
                 device=dev)
    tables = r.intersect.curves
    assert tables is not None and r.intersect.graph_safe
    rays = _hairball_rays(np.random.default_rng(group), 5001, dev)
    qh = di.dense_intersect(r.intersect.tables, *rays)
    bt = torch.where(qh.hit, qh.t, rays[3])
    lists = ii.precull(*rays[:3], bt, tables.clusters, group)
    got, tested = cw.curve_intersect_kernel(tables, *rays[:3], bt, *lists,
                                            group)
    want, want_tested = cw.curve_walk_plain(tables, *rays[:3], bt, *lists,
                                            group)
    assert _same_bits(got, want) and int(tested) == int(want_tested) > 0
    assert (got.line >= 0).sum() > 100 and (got.point >= 0).sum() > 10
    hit = tint.merge_curves(r.dscene, r.config, qh, *rays, tables)
    sweep = tint.merge_curves(r.dscene, r.config, qh, *rays)
    assert _same_bits(hit, sweep)


def test_replayed_tree_frames_equal_eager_on_card(dev):
    """The SPD tree (benchmark/scenes/spd_tree.py, 4,095 lines and 4,095
    points over 4 quads) at 256², 8 bounces: 3 frames from CUDA graphs
    equal 3 eager ones bit for bit, the third frame's bodies are all
    graphed, and the curve_walk rows count what eager frames count (n,
    rays, candidates, tested), each with a positive device_ns."""
    from benchmark.modes.render_curves import to_program_scene
    from benchmark.scenes import spd_tree

    scene = to_program_scene(spd_tree.build())
    params = Params(resolution=256, samples=1 << 20, batch=1, bounces=8,
                    seed=6)

    def frames(graphed):
        r = Renderer(scene, params, device=dev)
        assert r.intersect.curves is not None and r.intersect.graph_safe
        if not graphed:
            r.body_graphs = None
        st = make_trace_state(scene, params, device=dev)
        t0 = timing._now()
        for _ in range(3):
            r.trace_samples(st)
        torch.cuda.synchronize()
        units = [u["table"] for u in timing.units() if u["start_ns"] >= t0]
        walk = [row for t in units for path, row in t.items()
                if path.endswith("/curve_walk")]
        last = [row for path, row in units[-1].items()
                if path.endswith("/body")]
        return ((st.image, st.albedo, st.normal, st.hits), walk, last)

    got, got_walk, got_last = frames(True)
    want, want_walk, _ = frames(False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert sum(r["graphed"] for r in got_last) == sum(r["n"] for r in got_last)
    for key in ("n", "rays", "candidates", "tested"):
        assert (sum(r[key] for r in got_walk)
                == sum(r[key] for r in want_walk)), key
    assert all(r["device_ns"] > 0 for r in got_walk + want_walk)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _slab_sum(x):
    """ATen's float sum over the last axis of x [n, k] (1 <= k <= 16) on
    the card as csrc/shade_path.cu slab_sum adds it: slots (x_t + x_t+W) +
    0 for W = last_pow2(k), then a tree over halving offsets."""
    k = x.shape[1]
    w = 1 << (k.bit_length() - 1)
    z = torch.zeros_like(x[:, 0])
    v = [(x[:, t] + x[:, t + w] if t + w < k else x[:, t]) + z
         for t in range(w)]
    o = w // 2
    while o:
        v = [v[t] + v[t + o] for t in range(o)]
        o //= 2
    return v[0]


@pytest.mark.parametrize("k", range(1, 17))
def test_card_sum_order_is_the_shading_kernels(dev, k):
    """ATen's sum over a contiguous last axis of k floats on the card adds
    in the order csrc/shade_path.cu repeats (the light pdf's slabs, k up
    to 16; every dot product, k = 3, as ((x0 + x2) + x1) + 0), on values
    of mixed scales and signs where the order shows, -0.0 included."""
    g = torch.Generator().manual_seed(k)
    n = 200_000
    x = (torch.randn(n, k, generator=g)
         * 10.0 ** torch.randint(-6, 7, (n, k), generator=g)).to(dev)
    x[::5] = torch.where(torch.rand(n // 5 + (n % 5 > 0), k, generator=g)
                         .to(dev) < 0.3, -0.0, x[::5])
    assert torch.equal(_bits(x.sum(-1)), _bits(_slab_sum(x)))
    if k == 3:
        want = ((x[:, 0] + x[:, 2]) + x[:, 1]) + 0.0
        assert torch.equal(_bits(x.sum(-1)), _bits(want))


def _shade_checked(dev, scene, params, frames=1):
    """`frames` frames of `scene` with eager bodies on the card, each
    body's shading by the kernel held to its plain version (the eager
    bounce's) on the same state: {field: lanes that differ in any bit} and
    the widths seen."""
    from julia_raytracer_tpu_torch.ops import shade_path as sp

    r = Renderer(scene, params, device=dev)
    r.body_graphs = None
    st = make_trace_state(scene, params, device=dev)
    real = sp.shade_path
    differ, widths = {f: 0 for f in sp.ShadeOut._fields}, []

    def checking(tables, s, plain):
        got = real(tables, s, plain)
        want = plain(s)
        n = s.alive.shape[0]
        widths.append(n)
        for f, a, b in zip(sp.ShadeOut._fields, got, want, strict=True):
            differ[f] += int((_bits(a) != _bits(b)).reshape(n, -1)
                             .any(1).sum())
        return got

    checking.launches = 0
    with mock.patch.object(sp, "shade_path", checking):
        for _ in range(frames):
            r.trace_samples(st)
    torch.cuda.synchronize()
    return differ, widths


def _shade_scene(name):
    """(scene, extra Params) of the shading tests: the three render cells'
    scenes (the flake at size factor 2, forced through its cell's route)
    and lit_panels_scene."""
    if name == "cornell":
        return cornell_scene(), {}
    if name == "tree":
        from benchmark.modes.render_curves import to_program_scene
        from benchmark.scenes import spd_tree

        return to_program_scene(spd_tree.build()), {}
    if name == "flake":
        return sphereflake_scene(2, 4), dict(hybrid_budget=8)
    return lit_panels_scene(), {}


@pytest.mark.parametrize("name", ["cornell", "flake", "tree", "lit_panels"])
def test_shade_kernel_equals_plain_on_every_lane(dev, name):
    """A 1280² frame, 8 bounces, bodies at 1,048,576 lanes and at the
    narrower widths after compaction (262,144 where the live lanes pass
    through it; the tree's background rays die at once, so its survivors
    fit 65,536): on every body the kernel's next ray, tmin, tmax,
    radiance, weight, RNG state, bounce, alive, hit flag and AOVs equal
    the eager shading's bit for bit on every lane, the dead lanes
    included."""
    from julia_raytracer_tpu_torch.render import scene_device

    scene, extra = _shade_scene(name)
    params = Params(resolution=1280, samples=1 << 20, batch=1, bounces=8,
                    seed=13, **extra)
    with mock.patch.object(scene_device, "_should_instance",
                           lambda s: name == "flake"):
        differ, widths = _shade_checked(dev, scene, params)
    want = {1 << 20, 1 << 16} if name == "tree" else {1 << 20, 1 << 18}
    assert want <= set(widths)
    assert differ == {f: 0 for f in differ}


def _shade_frames(dev, scene, params, graphed, fused, frames=2):
    with mock.patch.object(tint, "SHADE_PATH_DEVICES",
                           ("cuda",) if fused else ()):
        r = Renderer(scene, params, device=dev)
        if not graphed:
            r.body_graphs = None
        st = make_trace_state(scene, params, device=dev)
        t0 = timing._now()
        for _ in range(frames):
            r.trace_samples(st)
        torch.cuda.synchronize()
    rows = [row for u in timing.units() if u["start_ns"] >= t0
            for path, row in u["table"].items() if path.endswith("/body")]
    return [x.clone() for x in (st.image, st.albedo, st.normal, st.hits)], rows


@pytest.mark.parametrize("name", ["cornell", "tree"])
def test_shaded_graphed_frames_equal_eager_frames_on_card(dev, name):
    """Two 1280² frames replayed from CUDA graphs on the kernel's route
    equal two eager frames of the eager bounce bit for bit (image, AOVs,
    hits); every body of the first is `shaded`, none of the second."""
    scene, extra = _shade_scene(name)
    params = Params(resolution=1280, samples=1 << 20, batch=1, bounces=8,
                    seed=17, **extra)
    got, got_rows = _shade_frames(dev, scene, params, True, True)
    want, want_rows = _shade_frames(dev, scene, params, False, False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    bodies = sum(r["n"] for r in got_rows)
    assert bodies == sum(r["n"] for r in want_rows) > 0
    assert sum(r["shaded"] for r in got_rows) == bodies
    assert sum(r["graphed"] for r in got_rows) > 0
    assert sum(r["shaded"] for r in want_rows) == 0


def test_uncovered_scene_is_not_shaded_on_card(dev):
    """The Cornell box with its tall box refractive (a delta lobe, a
    volume) stays on the eager bounce: no body `shaded`, no kernel launch,
    and its frames equal those of a trace with the route switched off."""
    from julia_raytracer_tpu_torch.ops import shade_path as sp
    from julia_raytracer_tpu_torch.scene.types import (
        MaterialData, MaterialType,
    )

    scene = cornell_scene()
    scene.materials.append(MaterialData(
        type=MaterialType.REFRACTIVE, color=np.full(3, 0.9, np.float32),
        ior=1.5))
    scene.instances[4].material = len(scene.materials) - 1
    params = Params(resolution=256, samples=1 << 20, batch=1, bounces=8,
                    seed=19)
    sp.shade_path.launches = 0
    got, rows = _shade_frames(dev, scene, params, True, True)
    want, _ = _shade_frames(dev, scene, params, True, False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert sum(r["n"] for r in rows) > 0
    assert sum(r["shaded"] for r in rows) == 0
    assert sp.shade_path.launches == 0


def test_shade_kernel_rejects_bad_state_on_card(dev):
    """A state of another dtype, shape or layout raises before a launch."""
    from julia_raytracer_tpu_torch.ops import shade_path as sp

    scene = cornell_scene()
    params = Params(resolution=64, samples=1 << 20, batch=1, bounces=8)
    r = Renderer(scene, params, device=dev)
    r.body_graphs = None
    kept = []
    real = tint.eager_bounce

    def keeping(b, s, query):
        kept.append((b, s))
        return real(b, s, query)

    with mock.patch.object(tint, "SHADE_PATH_DEVICES", ()), \
            mock.patch.object(tint, "eager_bounce", keeping):
        r.trace_samples(make_trace_state(scene, params, device=dev))
    b, s = kept[0]
    tables = sp.make_tables(b.dscene, b.config, b.options)
    plain = functools.partial(tint.shade_plain, b)
    out = sp.shade_path(tables, s, plain)
    assert all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(out, plain(s), strict=True))
    for bad in (s._replace(weight=s.weight.double()),
                s._replace(isec_prim=s.isec_prim.long()),
                s._replace(rd=s.rd[:-1]),
                s._replace(hit_normal=s.hit_normal.t().contiguous().t())):
        with pytest.raises(ValueError, match="shade_path"):
            sp.shade_path(tables, bad, plain)


def test_veach_route_and_spans_on_card(dev):
    """Veach's MIS scene (benchmark/scenes/veach_mis.py, 30,720 emissive
    quads) on the card routes as the manylights-path8 cell measures it:
    the worklist, no sort, 8 extra march steps. A 128 x 128 frame's bodies
    run eagerly and file a `light_march` span each (steps the budget,
    marching at most lanes x steps, truncated at most lanes, stamped on
    the card) and a `worklist` span for every call: the camera rays', and
    each body's hit and march steps."""
    from benchmark.modes import render_lights
    from benchmark.modes.common import to_program_scene
    from benchmark.scenes import veach_mis

    scene = to_program_scene(veach_mis.build())
    traffic = {"resolution": 128, "batch": 1, "bounces": 8,
               "sampler": "path", "clamp": 10.0}
    params = render_lights.params(traffic, 2 ** 31 + 5)
    r = Renderer(scene, params, device=dev)
    render_lights.check_route(r)
    assert r.config.light_counts.total_inst_elems == 30720
    state = make_trace_state(scene, params, device=dev)
    timing.reset()
    r.trace_samples(state)
    torch.cuda.synchronize()
    table = timing.units()[-1]["table"]

    def rows(name):
        return [row for path, row in table.items()
                if path.endswith("/" + name)]

    bodies = sum(row["n"] for row in rows("body"))
    assert bodies > 0 and sum(row["graphed"] for row in rows("body")) == 0
    march = rows("light_march")
    assert sum(row["n"] for row in march) == bodies
    for row in march:
        assert row["steps"] == 8 * row["n"] and row["device_ns"] > 0
        assert 0 < row["marching"] <= row["lanes"] * 8
        assert 0 <= row["truncated"] <= row["lanes"]
        assert 0 < row["emitter_hits"] <= row["marching"]
    chunks = sum(row["n"] for row in rows("chunk"))
    assert sum(row["n"] for row in rows("worklist")) == chunks + 9 * bodies
    assert all(row["device_ns"] > 0 for row in rows("worklist"))
