"""utils/kernel_select.py: the port's pass counts against the JAX
package's predict_ratio, exactly, on the 40,000-quad soup of
tests/test_kernel_select.py with 8,192 bounce rays (seed 5), and the
decision rule (regroup iff the predicted ratio < RATIO_THRESHOLD) under
given costs.

Tolerance: none. The counts are integers from the same float32 slab
test; the ratio under the JAX package's own (TPU v5e) unit costs, passed
in as a SelectCosts for this comparison only, equals its ratio to the
rounding both apply."""

import numpy as np
import pytest

from julia_raytracer_tpu.utils import kernel_select as jks
from julia_raytracer_tpu_torch.utils import kernel_select as tks


def _soup(n_prims, seed=3):
    """tests/test_kernel_select.py's soup."""
    rng = np.random.default_rng(seed)
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


JAX_COSTS = tks.SelectCosts(jks.US_WL_PASS, jks.US_RG_PASS, jks.US_RG_PAIR,
                            jks.US_RG_RAY, jks.MS_RG_FIXED)


@pytest.fixture(scope="module")
def soup():
    pv = _soup(40_000)
    return pv, np.zeros(len(pv), np.int32)


def test_pass_counts_equal_jax(soup):
    pv, inst = soup
    want = jks.predict_ratio(pv, inst, "", n_rays=8192, seed=5)
    got = tks.predict_ratio(pv, inst, n_rays=8192, seed=5, costs=JAX_COSTS)
    for k in ("n_rays", "n_super", "passes_wl", "passes_rg", "pairs",
              "rows_rg", "t_wl_ms", "t_rg_ms", "ratio"):
        assert got[k] == want[k], (k, got, want)
    assert 0 < got["passes_rg"] < got["passes_wl"] and got["n_super"] > 1


def test_bounce_rays_and_super_boxes_equal_jax(soup):
    pv, _ = soup
    for a, b in zip(tks.bounce_rays(pv, 3000, seed=2),
                    jks.bounce_rays(pv, 3000, seed=2)):
        np.testing.assert_array_equal(a, b)
    boxes = np.random.default_rng(0).random((300, 6)).astype(np.float32)
    for a, b in zip(tks._super_bbox(boxes), jks._super_bbox(boxes)):
        np.testing.assert_array_equal(a, b)


def test_row_pass_counts_do_not_depend_on_the_step(soup, monkeypatch):
    pv, _ = soup
    o, d, tmin, tmax = tks.bounce_rays(pv, 2048, seed=4)
    tmax[::3] = -1.0  # dead lanes pass nothing
    cb = np.random.default_rng(1).random((200, 6)).astype(np.float32)
    cb[:, 3:] = cb[:, :3] + 0.05
    full = tks._row_passes_device(o, d, tmin, tmax, "cpu", cb_shared=cb)
    monkeypatch.setattr(tks, "ROW_STEP_ELEMS", 3 * 200 * 128)
    assert tks._row_passes_device(o, d, tmin, tmax, "cpu", cb_shared=cb) == full
    rows = np.broadcast_to(cb, (16, 200, 6))
    assert tks._row_passes_device(o, d, tmin, tmax, "cpu", cb_rows=rows) == full
    assert 0 < full < 16 * 200


def test_decision_follows_the_threshold(soup):
    pv, inst = soup
    cheap_wl = tks.SelectCosts(1e-6, 1.0, 1.0, 1.0, 1.0)
    dear_wl = tks.SelectCosts(10.0, 1e-3, 1e-3, 1e-3, 0.0)
    for costs, kernel in ((cheap_wl, "worklist"), (dear_wl, "regroup")):
        sel = tks.select_bounce_kernel(pv[:20_000], inst[:20_000], costs=costs)
        assert sel["kernel"] == kernel
        assert (sel["kernel"] == "regroup") == (sel["ratio"] < sel["threshold"])
        assert sel["threshold"] == tks.RATIO_THRESHOLD == 0.35
    assert all(c > 0 for c in tks.H100_COSTS)


def test_decision_counts_rays_in_wavefront_order(soup):
    """select_bounce_kernel counts the sampled rays in the order the
    renderer's wavefront sort gives them: count_passes of the rays
    permuted by a stable argsort of integrator._sort_key over the quads'
    bounds. Sorted rows are coherent, so the worklist's passes fall."""
    import torch

    from julia_raytracer_tpu_torch.ops.cluster_tables import build_cluster_tables
    from julia_raytracer_tpu_torch.render.integrator import _sort_key
    pv, inst = soup
    o, d, tmin, tmax = tks.bounce_rays(pv, 8192, seed=5)
    flat = torch.from_numpy(pv.reshape(-1, 3))
    key = _sort_key(torch.from_numpy(o), torch.from_numpy(d),
                    flat.amin(dim=0), flat.amax(dim=0)).numpy()
    order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(tks.wavefront_order(pv, o, d), order)
    assert (np.diff(key[order]) >= 0).all()
    sampled = tks.bounce_counts(pv, inst, 8192, 5)
    got = tks.bounce_counts(pv, inst, 8192, 5, sort_rays=True)
    _, _, bbox, n_clusters = build_cluster_tables(pv.astype(np.float64), inst)
    want = tks.count_passes(o[order], d[order], tmin[order], tmax[order],
                            bbox[:n_clusters, 0:6])
    assert got == dict(n_rays=8192, **want)
    assert got["passes_wl"] < sampled["passes_wl"]
    assert got["n_super"] == sampled["n_super"]
    sel = tks.select_bounce_kernel(pv, inst)
    assert sel["ratio"] == tks.predict_ratio(pv, inst, sort_rays=True)["ratio"]
