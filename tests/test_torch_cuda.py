"""The port's CUDA kernels against their plain PyTorch versions on edge
cases, on the card. Marked `cuda`: they skip where no CUDA device is
available. Run them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU machine
need not have; this file imports only the port.)"""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    check_hits, cornell_scene, image_close, sphere_grid_scene,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("q", [0, 1, 37, di.MAX_PRIMS])
def test_dense_intersect_kernel_equals_plain(dev, q):
    g = np.random.default_rng(q)
    base = g.uniform(-1, 1, (q, 3)).astype(np.float32)
    e1 = g.uniform(-0.5, 0.5, (q, 3)).astype(np.float32)
    e2 = g.uniform(-0.5, 0.5, (q, 3)).astype(np.float32)
    verts = np.stack([base, base + e1, base + e1 + e2, base + e2], axis=1)
    verts[::2, 3] = verts[::2, 2]  # degenerate quads
    table = torch.from_numpy(
        di.build_prim_table(verts, g.integers(0, 50, q))).to(dev)
    n = 5000  # not a multiple of the block size
    ro = g.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = (g.normal(size=(n, 3)) - 0.3 * ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(g.random(n) < 0.1, -1.0, 1e30).astype(np.float32)
    args = [torch.from_numpy(x).to(dev) for x in
            (ro, rd, np.full(n, 1e-4, np.float32), tmax)]
    got = di.dense_intersect(table, *args)
    want = di.dense_intersect_plain(table, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    table = torch.zeros((4, di.STRIDE), device=dev)
    with pytest.raises(ValueError):  # strided rays
        ro = torch.zeros((8, 6), device=dev)[:, :3]
        di.dense_intersect(table, ro, ro, torch.zeros(8, device=dev),
                           torch.zeros(8, device=dev))


@pytest.mark.parametrize("sup", [2, 8, wl.WL_SUPER])
def test_worklist_kernel_equals_plain(dev, sup):
    """Sphere grid (1,030 quads) at n = 5,000 rays (not a multiple of
    1024): camera rays, rays from inside the room with zero direction
    components, finite and dead (tmax = -1) lanes. Bit-equal expected."""
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
    order, cnt = wl.precull(*args, tables.sbbox)
    got = wl.worklist_intersect_kernel(tables, *args, order, cnt)
    want, work = wl.worklist_intersect_plain(tables, *args, order, cnt)
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


def _soup_tables(dev):
    """12,000 small quads in the unit cube (2 superclusters), 7 instances."""
    g = np.random.default_rng(11)
    centers = g.random((12000, 3))
    centers = centers[np.argsort((centers * 64).astype(np.int64)
                                 @ np.array([4096, 64, 1]))]
    e1 = g.normal(size=(12000, 3)) * 0.02
    e2 = g.normal(size=(12000, 3)) * 0.02
    pv = np.stack([centers, centers + e1, centers + e1 + e2, centers + e2],
                  axis=1).astype(np.float32)
    return wl.pack_tables(pv, np.arange(12000) % 7, device=dev)


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
