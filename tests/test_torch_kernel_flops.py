"""utils/kernel_flops.py: the numpy copies of the JAX package's dispatch
counts, and the kernel wrappers' cost reports on the CPU.

  - `_slab`, `regroup_dispatch_stats` and `worklist_dispatch_stats` equal
    the JAX functions exactly, dict for dict, on seeded soups and rays;
  - kernel_select.count_passes' regroup passes equal
    regroup_dispatch_stats' `passes` (the same rows of 128 packed rays
    against their super's clusters);
  - each kernel row's dispatcher, run on the CPU under
    roofline.count_cost, reports one call of its kernel with the cost of
    its kernel_flops function, and no ATen op of its plain version: the
    counts it reports are those of its plain version's work where the two
    count the same thing (the tri-test's passes and clusters, the pair
    walks' plan), and at most the plain walk's where the report counts
    what the call needs (rows 4-7: a cull against the closest hit, not
    the running best). The cost is computed from the call's inputs and
    outputs, which the kernel and its plain version give bit for bit
    (tests/test_torch_cuda.py on the card), so the CPU and the card report
    the same.

Tolerance: none; all counts are integers."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu.utils import kernel_flops as jkf
from julia_raytracer_tpu_torch.ops import (
    cluster_intersect as ci, cluster_tables as ct, dense_intersect as di,
    instanced_intersect as ii, lane_compact as lc, regroup_intersect as rg,
    worklist_intersect as wl,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, instanced_scene, sphere_grid_scene,
)
from julia_raytracer_tpu_torch.utils import kernel_flops as kf
from julia_raytracer_tpu_torch.utils import kernel_select as ks
from julia_raytracer_tpu_torch.utils.roofline import count_cost


def _soup(n_prims, seed):
    rng = np.random.default_rng(seed)
    centers = rng.random((n_prims, 3))
    order = np.argsort((centers * 16).astype(np.int64) @ [256, 16, 1])
    centers = centers[order]
    e1 = rng.normal(size=(n_prims, 3)) * 0.03
    e2 = rng.normal(size=(n_prims, 3)) * 0.03
    return np.stack([centers, centers + e1, centers + e1 + e2, centers + e2],
                    axis=1).astype(np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.random((n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 3e38, np.float32)
    tmax[::9] = -1.0  # dead lanes
    return o, d, tmin, tmax


@pytest.mark.parametrize("n_prims,n_rays,seed", [(9000, 2048, 1),
                                                  (20000, 3000, 2)])
def test_stats_equal_jax(n_prims, n_rays, seed):
    _, _, bbox, c = ct.build_cluster_tables(_soup(n_prims, seed))
    cb = bbox[:c, :6]
    rays = _rays(n_rays, seed + 10)
    np.testing.assert_array_equal(kf._slab(*rays, cb), jkf._slab(*rays, cb))
    for name in ("regroup_dispatch_stats", "worklist_dispatch_stats"):
        assert getattr(kf, name)(*rays, cb) == getattr(jkf, name)(*rays, cb)
    st = kf.regroup_dispatch_stats(*rays, cb)
    assert set(kf.regroup_dispatch_flops(st)) == set(
        jkf.regroup_dispatch_flops(st))
    wst = kf.worklist_dispatch_stats(*rays, cb)
    assert set(kf.worklist_dispatch_flops(wst)) == set(
        jkf.worklist_dispatch_flops(wst))


def test_count_passes_equal_regroup_stats():
    _, _, bbox, c = ct.build_cluster_tables(_soup(20000, 4))
    rays = _rays(4096, 7)
    got = ks.count_passes(*rays, bbox[:c, :6])
    st = kf.regroup_dispatch_stats(*rays, bbox[:c, :6])
    assert got["passes_rg"] == st["passes"]
    assert got["n_super"] == st["n_super"]


def _one_kernel(fn, name):
    """fn() under count_cost: its one kernel report, no ATen op of the
    plain version counted."""
    out, counter = count_cost(fn)
    assert list(counter.kernels) == [name]
    calls, ops, nbytes = counter.kernels[name]
    assert calls == 1
    return out, dict(ops=ops, bytes=nbytes), counter


def _torch_rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 3.4e38, np.float32)
    tmax[::7] = -1.0
    return [torch.from_numpy(x) for x in
            (o, d, np.full(n, 1e-4, np.float32), tmax)]


@pytest.fixture(scope="module")
def grid():
    _, cfg = build_device_scene(sphere_grid_scene(2, 8), device="cpu")
    rays = _torch_rays(600, 3, [-0.9, 0.1, -0.9], [0.9, 1.9, 0.9])
    return cfg, rays


def test_dense_reports_its_model():
    _, cfg = build_device_scene(cornell_scene(), device="cpu")
    table = di.make_dense_table(cfg.host_prim_verts, cfg.host_prim_instance,
                                "cpu")
    rays = _torch_rays(500, 1, [-0.9, 0.1, -0.9], [0.9, 1.9, 0.9])
    _, cost, counter = _one_kernel(lambda: di.dense_intersect(table, *rays),
                                   "dense_intersect")
    assert not counter.ops
    tests, reach = di.pretest_counts(table, rays[0], rays[1])
    q = cfg.n_prims
    assert q <= tests <= 2 * q * 500 and 0 < reach <= tests
    assert cost == kf.dense_intersect_cost(
        500, table.quads.nbytes + table.prims.numel() * 4, tests, reach)


def test_lane_kernels_report_their_models():
    g = torch.Generator().manual_seed(0)
    vals = torch.randint(-100, 100, (5, 4096), dtype=torch.int32, generator=g)
    alive = torch.rand(4096, generator=g) < 0.3
    narrow, cost, counter = _one_kernel(
        lambda: lc.compact_planes(vals, alive, 2048), "lane_compact")
    assert not counter.ops and cost == kf.lane_compact_cost(5, 4096, 2048)
    _, cost, counter = _one_kernel(
        lambda: lc.expand_planes(narrow, alive, vals), "lane_expand")
    assert not counter.ops and cost == kf.lane_expand_cost(5, 2048, 4096)


def test_worklist_reports_needed_pairs(grid):
    cfg, rays = grid
    tables = wl.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance)
    hit, cost, _ = _one_kernel(lambda: wl.worklist_intersect(tables, *rays),
                               "worklist_intersect")
    order, cnt = wl.precull(*rays, tables.sbbox)
    _, work = wl.worklist_intersect_plain(tables, *rays, order, cnt)
    pairs, clusters = wl.needed_pairs(tables, rays[0], rays[1], rays[2],
                                      hit.t, order, cnt)
    assert 0 < pairs <= work["pairs"] and clusters > 0
    # against tmax instead of the closest hit: more pairs, as the walk
    assert wl.needed_pairs(tables, rays[0], rays[1], rays[2], rays[3], order,
                           cnt)[0] >= work["pairs"]
    assert cost == wl.call_cost(tables, rays[0], rays[1], rays[2], hit.t,
                                order, cnt)
    assert cost["ops"] == pairs * kf.TRIS * kf.OPS_PER_TRI_TEST


@pytest.mark.parametrize("name", ["cluster_intersect",
                                  "cluster_intersect_streamed"])
def test_cluster_sweeps_report_needed_pairs(grid, name):
    cfg, rays = grid
    tables = ci.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance, "cpu")
    hit, cost, _ = _one_kernel(lambda: getattr(ci, name)(tables, *rays), name)
    plain = getattr(ci, name + "_plain")
    _, work = plain(tables, *rays)
    assert 0 < cost["ops"] <= work["pairs"] * kf.TRIS * kf.OPS_PER_TRI_TEST


def test_regroup_kernels_report_their_models(grid):
    cfg, rays = grid
    tables = wl.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance)
    rays8 = torch.cat([rays[0], rays[1], rays[2][:, None], rays[3][:, None]],
                      dim=1)
    rays8 = torch.cat([rays8, torch.zeros((1024 - 600, 8))])
    rays8[600:, 7] = -1.0
    plan = rg.count_stage(rays8, tables.sbbox)
    n_groups = int(plan.groups_s.sum())
    grp_super = torch.repeat_interleave(
        torch.arange(len(plan.groups_s), dtype=torch.int32),
        plan.groups_s.long())
    plan_bytes = kf.regroup_plan_bytes(plan.cnt_ts.numel(),
                                       int((plan.cnt_ts > 0).sum()))
    packed, cost, counter = _one_kernel(
        lambda: rg.regroup_pack(plan, rays8, n_groups * rg.TILE),
        "regroup_pack")
    assert not counter.ops
    assert cost == kf.regroup_pack_cost(
        plan_bytes, plan.bits.shape[1], int(plan.bits.any(dim=1).sum()),
        packed.numel())
    tri, cost, counter = _one_kernel(
        lambda: rg.regroup_tritest(packed, tables, grp_super),
        "regroup_tritest")
    assert not counter.ops
    _, work = rg.regroup_tritest_plain(packed, tables, grp_super)
    assert cost == kf.regroup_tritest_cost(
        packed.numel(), work["clusters"], torch.unique(grp_super).numel(),
        tables.sup, n_groups, tri.numel(), work["passes"])
    res, cost, counter = _one_kernel(lambda: rg.regroup_unpack(plan, tri),
                                     "regroup_unpack")
    assert not counter.ops
    assert cost == kf.regroup_unpack_cost(plan_bytes, int(plan.cnt_s.sum()),
                                          res.numel())


def test_instanced_and_cull_report_their_models():
    _, cfg = build_device_scene(instanced_scene(3, (8, 6)), instancing=True,
                                hybrid_budget=0, device="cpu")
    tables = ii.upload(cfg.inst_tables, "cpu")
    lo, hi = cfg.world_bounds
    rays = _torch_rays(700, 5, lo, hi)
    hit, counter = count_cost(lambda: ii.instanced_intersect(tables, *rays))
    assert set(counter.kernels) == {"candidate_cull", "instanced_intersect"}
    order, tlow, cnt = ii.precull(*rays, tables.wi_bbox)
    items = tables.wi_bbox.shape[0]
    _, tests = ii.cluster_pass_plain(*rays, tables.clusters)
    assert 0 < tests["item_tests"] <= 700 * items
    assert counter.kernels["candidate_cull"][1:] == list(
        kf.candidate_cull_cost(700, cnt.shape[0], ii.GROUP_RAYS, items,
                               tables.clusters.cluster_boxes.shape[0],
                               int(tests["cluster_tests"]),
                               int(tests["item_tests"]),
                               int(cnt.sum())).values())
    _, work = ii.instanced_intersect_plain(tables, *rays, order, tlow, cnt)
    need = ii.needed_work(tables, rays[0], rays[1], rays[2], hit.t, order, cnt)
    assert 0 < need["pairs"] <= work["pairs"]
    for k in ("clusters", "supers", "instances"):
        assert 0 < need[k] <= work[k]
    assert counter.kernels["instanced_intersect"][1:] == list(
        ii.call_cost(tables, rays[0], rays[1], rays[2], hit.t, order,
                     cnt).values())


def test_curve_walk_reports_its_model():
    """The culled curve route on the CPU (curve_intersect: the cull, then
    curve_walk_plain) reports one cull and one walk, the walk at
    curve_walk_cost's floor: the rays, their hits, the element table once
    and one line and one point test a ray."""
    from julia_raytracer_tpu_torch.ops import curve_intersect as cw
    from julia_raytracer_tpu_torch.testing import hairball_scene

    d, _ = build_device_scene(hairball_scene(200, 2, 40), device="cpu")
    tables = cw.upload(d.line_verts, d.line_radius, d.point_pos,
                       d.point_radius, "cpu")
    rays = _rays(600, 7)
    rays = (torch.from_numpy(rays[0]) * 2.0 - 1.0 + torch.tensor(
        [0.0, 1.0, 0.0]),) + tuple(torch.from_numpy(x) for x in rays[1:])
    best, counter = count_cost(lambda: cw.curve_intersect(tables, *rays))
    assert set(counter.kernels) == {"candidate_cull", "curve_intersect"}
    assert (best.line >= 0).any()
    assert counter.kernels["curve_intersect"][1:] == list(
        kf.curve_walk_cost(600, 440).values())
    assert kf.curve_walk_cost(1, 0) == dict(ops=100.0, bytes=56.0)
