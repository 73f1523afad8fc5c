"""ops/native.py: the port's C++/OpenMP host builders
(csrc/host/cluster_tables.cpp) against the port's numpy paths and the JAX
package's tables.

  - the cluster tables on the soup of tests/test_pallas_kernels.py
    (500 quads: degenerate prims, the instance-id row, a padded last
    cluster), native against the numpy path (JRT_NO_NATIVE=1) and against
    JAX build_cluster_tables: within rtol = atol = 2e-6 (the JAX test's
    tolerance: double math per prim, float32 stores, numpy's vectorised
    reductions in another order), boxes exact;
  - the hybrid build's world expansion (scene/instanced.py
    build_world_flat on testing.hybrid_scene(4, 4, 3, 12)), native
    against the numpy einsum: each product x_j R_ji summed in float32 in
    another order, so within 4 float32 ulps of the largest coordinate
    (WORLD_RTOL); the instance and remap arrays exact.

Skipped only when no g++ is on the PATH (the numpy paths then run)."""

import shutil

import numpy as np
import pytest

from julia_raytracer_tpu.ops.pallas_cluster import (
    build_cluster_tables as jax_build_cluster_tables,
)
from julia_raytracer_tpu_torch.ops import cluster_tables as ct, native
from julia_raytracer_tpu_torch.scene.flatten import flatten_scene
from julia_raytracer_tpu_torch.scene.instanced import (
    build_world_flat, select_flatten_shapes,
)
from julia_raytracer_tpu_torch.testing import hybrid_scene

TABLE_TOL = 2e-6
WORLD_RTOL = 4 * float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: the numpy paths run")


def _soup():
    """tests/test_pallas_kernels.py's soup."""
    rng = np.random.default_rng(5)
    q = 500  # 8 clusters, last partially padded
    pv = rng.normal(size=(q, 4, 3)).astype(np.float32)
    pv[7] = 0.0  # fully degenerate prim
    pv[11, 1] = pv[11, 0]  # one degenerate triangle of the pair
    inst = rng.integers(0, 9, q).astype(np.int32)
    return pv, inst


def _close(got, want):
    assert got[3] == want[3]
    np.testing.assert_allclose(got[0], want[0], rtol=TABLE_TOL, atol=TABLE_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=TABLE_TOL, atol=TABLE_TOL)
    np.testing.assert_array_equal(got[2], want[2])


def test_native_tables_match_numpy_and_jax(monkeypatch):
    pv, inst = _soup()
    assert native.lib() is not None
    assert native.threads() >= 1
    got = ct.build_cluster_tables(pv, inst)
    monkeypatch.setenv("JRT_NO_NATIVE", "1")
    assert native.lib() is None
    _close(got, ct.build_cluster_tables(pv, inst))
    _close(got, jax_build_cluster_tables(pv, inst))


def test_native_tables_without_instances(monkeypatch):
    pv, _ = _soup()
    got = ct.build_cluster_tables(pv[:64])  # one full cluster
    assert not got[1][:, 3].any()
    monkeypatch.setenv("JRT_NO_NATIVE", "1")
    _close(got, ct.build_cluster_tables(pv[:64]))


def test_world_expansion_native_vs_numpy(monkeypatch):
    flat = flatten_scene(hybrid_scene(4, 4, 3, 12), expand_prims=False)
    mask = select_flatten_shapes(flat, 300)
    assert mask.any()
    pv, inst, remap = build_world_flat(flat, mask)
    monkeypatch.setenv("JRT_NO_NATIVE", "1")
    pv_np, inst_np, remap_np = build_world_flat(flat, mask)
    assert len(pv) == len(pv_np) > 0
    np.testing.assert_array_equal(inst, inst_np)
    np.testing.assert_array_equal(remap, remap_np)
    scale = float(np.abs(pv_np).max())
    np.testing.assert_allclose(pv, pv_np, rtol=0, atol=WORLD_RTOL * scale)


def test_native_rejects_bad_buffers():
    pv, _ = _soup()
    tfm = np.empty((8, 12, 128), np.float32)
    nrm = np.zeros((8, 4, 128), np.float32)
    bbox = np.empty((8, 8), np.float32)
    with pytest.raises(ValueError):
        native.build_cluster_tables_native(pv.astype(np.float64), 500, 8, tfm,
                                           nrm, bbox)
    with pytest.raises(ValueError):
        native.build_cluster_tables_native(pv, 500, 7, tfm[:7], nrm[:7],
                                           bbox[:7])
