"""The cluster intersectors without a work list (ops/cluster_intersect.py)
against the JAX package's make_cluster_intersect and
make_cluster_intersect_hbm in interpret mode, on the CPU.

Scene: sphere_grid_scene(3, 24), 5,190 quads in BVH order: 82 clusters,
two superclusters of 64 for the streamed version. 2,048 rays: camera rays
and rays from inside the room, with dead (tmax = -1) and short lanes.
Tolerances: check() of tests/test_pallas_kernels.py (testing.check_hits):
hit masks equal, > 99.9% of prim ids equal, t within rtol 1e-4, u, v and
positions within 5e-3, normals within 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.pallas_cluster import (
    make_cluster_intersect as jax_make_cluster_intersect,
    make_cluster_intersect_hbm as jax_make_cluster_intersect_hbm,
)
from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.traversal import intersect_bruteforce
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import check_hits, sphere_grid_scene

N_RAYS = 2048


@pytest.fixture(scope="module")
def setup():
    _, cfg = build_device_scene(sphere_grid_scene(3, 24), device="cpu")
    verts, inst = cfg.host_prim_verts, cfg.host_prim_instance
    g = np.random.default_rng(4)
    half = N_RAYS // 2
    ro = g.uniform([-0.95, 0.02, -0.95], [0.95, 1.95, 0.95], (N_RAYS, 3))
    ro[:half] = [0.0, 1.0, 3.9]
    rd = g.normal(size=(N_RAYS, 3))
    rd[:half, 2] = -np.abs(rd[:half, 2]) - 2.0
    # zero direction components, on rays from random points (a camera ray
    # in the plane x = 0 would graze the spheres' seams edge-on)
    rd[half::11, 0] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 3.4e38)
    tmax[::9] = -1.0
    tmax[1::7] = g.uniform(0.2, 3.0, len(tmax[1::7]))
    rays = [x.astype(np.float32) for x in (ro, rd, np.full(N_RAYS, 1e-4), tmax)]
    return verts, inst, rays


@pytest.mark.parametrize("streamed", [False, True])
def test_plain_matches_jax_interpret(setup, streamed):
    verts, inst, rays = setup
    make_jax = (jax_make_cluster_intersect_hbm if streamed
                else jax_make_cluster_intersect)
    make = ci.make_cluster_intersect_hbm if streamed else ci.make_cluster_intersect
    want = make_jax(verts, inst, interpret=True)(*(jnp.asarray(x) for x in rays))
    intersect = make(verts, inst, "cpu")
    assert intersect.tables.sbbox.shape[0] == 2  # 82 clusters, 2 supers of 64
    got = intersect(*(torch.from_numpy(x) for x in rays))
    check_hits(want, got)
    hit = np.asarray(want.hit)
    assert 0.3 < hit.mean() < 1.0


def test_plain_versions_agree_with_worklist_and_brute_force(setup):
    """Both plain versions, the worklist intersector and the dense
    reference give the same closest hits; the streamed version's
    supercluster cull only skips work, so its hits equal the sweep's bit
    for bit and it tests no more (ray, cluster) pairs."""
    verts, inst, rays = setup
    tr = [torch.from_numpy(x) for x in rays]
    tables = ci.pack_tables(verts, inst, "cpu")
    sweep, w_sweep = ci.cluster_intersect_plain(tables, *tr)
    streamed, w_streamed = ci.cluster_intersect_streamed_plain(tables, *tr)
    for a, b in zip(sweep, streamed):
        assert torch.equal(a, b)
    assert 0 < w_streamed["pairs"] == w_sweep["pairs"]
    check_hits(wl.make_worklist_intersect(verts, inst, "cpu")(*tr), sweep)
    check_hits(intersect_bruteforce(torch.from_numpy(verts), *tr,
                                    prim_instance=torch.from_numpy(inst)), sweep)


def test_kernel_wrappers_refuse_cpu_tensors(setup):
    verts, inst, rays = setup
    tables = ci.pack_tables(verts, inst, "cpu")
    tr = [torch.from_numpy(x) for x in rays]
    for kernel in (ci.cluster_intersect_kernel,
                   ci.cluster_intersect_streamed_kernel):
        with pytest.raises(ValueError):
            kernel(tables, *tr)


def _enters_numpy(ro, rd, tmin, tmax, boxes):
    """[n, m] bool: ray i enters box j within [tmin, tmax], the slab test
    of the kernels repeated in float32 numpy."""
    inv = np.float32(1.0) / np.where(rd == 0.0, np.float32(wl.TINY_DIR), rd)
    with np.errstate(over="ignore"):  # 1e30 x the padding boxes' 3e38
        t0 = (boxes[None, :, 0:3] - ro[:, None]) * inv[:, None]
        t1 = (boxes[None, :, 3:6] - ro[:, None]) * inv[:, None]
    enter = np.maximum(np.minimum(t0, t1).max(axis=2), tmin[:, None])
    exit_ = np.minimum(np.maximum(t0, t1).min(axis=2), tmax[:, None])
    return enter <= exit_ * np.float32(wl.SLACK)


def _warp_loads(want):
    """(warp of 32 consecutive rays, cluster) pairs with a wanting ray."""
    n, c = want.shape
    return int(want.reshape(n // wl.WARP, wl.WARP, c).any(axis=1).sum())


def test_plain_loads_match_numpy_count(setup):
    """Both plain versions' `loads` (the kernels' table loads: the (warp,
    cluster) pairs in which some ray wants the cluster) and `pairs`, and
    the streamed version's `steps` (the (warp, supercluster) pairs in which
    some ray enters the supercluster), against a direct numpy count of the
    cull on the 2,048 rays; the streamed version's rays want a cluster only
    inside a supercluster they enter."""
    verts, inst, rays = setup
    tables = ci.pack_tables(verts, inst, "cpu")
    boxes = tables.bbox.numpy()
    want = _enters_numpy(*rays, boxes)
    in_super = _enters_numpy(*rays, tables.sbbox.numpy())
    want_streamed = want & np.repeat(in_super, ci.SUPER, axis=1)
    c = ci.n_clusters(tables)
    tr = [torch.from_numpy(x) for x in rays]
    _, w_sweep = ci.cluster_intersect_plain(tables, *tr)
    _, w_streamed = ci.cluster_intersect_streamed_plain(tables, *tr)
    assert w_sweep["pairs"] == int(want[:, :c].sum())
    assert w_sweep["loads"] == _warp_loads(want[:, :c])
    assert w_streamed["pairs"] == int(want_streamed.sum())
    assert w_streamed["loads"] == _warp_loads(want_streamed)
    assert w_streamed["steps"] == _warp_loads(in_super)
    assert w_sweep["pairs"] / wl.WARP < w_sweep["loads"] < w_sweep["pairs"]
