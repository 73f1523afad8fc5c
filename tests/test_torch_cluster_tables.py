"""The port's cluster tables (ops/cluster_tables.py, numpy) against the
JAX package's build_cluster_tables and _wl_super_bbox, and the packed
worklist tables' never-hit padding.

Tolerance: transforms and normals within rtol = atol = 2e-6, boxes
exact. The JAX side may take its C++ builder, whose float64 math is the
same but whose last float32 bit can differ (the tolerance of
tests/test_pallas_kernels.py::test_native_cluster_tables_match_numpy)."""

import numpy as np
import pytest

from julia_raytracer_tpu.ops import pallas_cluster as jpc
from julia_raytracer_tpu_torch.ops import cluster_tables as ct
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import sphere_grid_scene


def _soup():
    g = np.random.default_rng(5)
    q = 500  # 8 clusters, the last partly padding
    pv = g.normal(size=(q, 4, 3)).astype(np.float32)
    pv[7] = 0.0  # collapsed quad: both triangles degenerate
    pv[11, 3] = pv[11, 2]  # p3 == p4: second triangle degenerate
    pv[40, 1] = pv[40, 0]  # p1 == p2: first triangle degenerate
    return pv, g.integers(0, 9, q).astype(np.int32)


def _spheres():
    _, cfg = build_device_scene(sphere_grid_scene(2, 16), device="cpu")
    return cfg.host_prim_verts, cfg.host_prim_instance


@pytest.fixture(scope="module", params=["soup", "spheres"])
def prims(request):
    return _soup() if request.param == "soup" else _spheres()


def test_cluster_tables_match_jax(prims):
    pv, inst = prims
    t1, n1, b1, c1 = ct.build_cluster_tables(pv, inst)
    t2, n2, b2, c2 = jpc.build_cluster_tables(pv, inst)
    assert c1 == c2 == -(-len(pv) // ct.PRIMS_PER_CLUSTER)
    assert t1.dtype == n1.dtype == b1.dtype == np.float32
    np.testing.assert_allclose(t1, t2, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(n1, n2, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(n1[:, 3], n2[:, 3])  # instance ids
    np.testing.assert_array_equal(b1, b2)
    for sup in (2, 8, ct.WL_SUPER):
        np.testing.assert_array_equal(ct._wl_super_bbox(b1, sup),
                                      jpc._wl_super_bbox(b2, sup))


def test_degenerate_triangles_never_hit():
    pv, inst = _soup()
    tfm, _, _, _ = ct.build_cluster_tables(pv, inst)
    never = np.zeros(12, np.float32)
    never[11] = 1.0
    rows = tfm.transpose(0, 2, 1).reshape(-1, 12)  # [triangle, 12]
    for tri in (2 * 7, 2 * 7 + 1, 2 * 11 + 1, 2 * 40):
        np.testing.assert_array_equal(rows[tri], never)
    for tri in (2 * 11, 2 * 40 + 1):
        assert rows[tri, 6:9].any()  # the other triangle of the pair is real
    # padding prims past q = 500 in the last cluster
    np.testing.assert_array_equal(rows[2 * 500:], np.tile(never, (12 * 2, 1)))


@pytest.mark.parametrize("sup", [3, 16])
def test_packed_tables_padding_is_exact(sup):
    pv, inst = _soup()  # 8 clusters: 1 (sup 3) or 8 (sup 16) padding clusters
    tables = wl.pack_tables(pv, inst, sup=sup)
    c = -(-len(pv) // ct.PRIMS_PER_CLUSTER)
    s = -(-c // sup)
    assert tables.tab.shape == (s * sup, wl.ROWS, ct.TRIS)
    assert tables.sbbox.shape == (s, 8)
    tfm, nrm, bbox, _ = ct.build_cluster_tables(pv, inst)
    np.testing.assert_array_equal(tables.tab[:c, :12].numpy(), tfm)
    np.testing.assert_array_equal(tables.tab[:c, 12:].numpy(), nrm)
    np.testing.assert_array_equal(tables.bbox[:c].numpy(), bbox)
    pad = tables.tab[c:].numpy()
    assert (pad[:, 11] == 1.0).all() and not pad[:, :11].any()
    assert not pad[:, 12:].any()
    assert (tables.bbox[c:, :6] == np.float32(3e38)).all()


def test_pack_tables_rejects_bad_sup():
    pv, inst = _soup()
    for sup in (0, 12, 256):
        with pytest.raises(ValueError):
            wl.pack_tables(pv, inst, sup=sup)
