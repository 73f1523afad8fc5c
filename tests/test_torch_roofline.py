"""utils/roofline.py and Renderer.sample_kernel_cost on the CPU.

  - count_cost is exact on hand programs: x + y (n flops, 3n elements of
    traffic), a sum (n flops), a matrix product (2MNK flops) and a view
    (nothing);
  - a kernel region counts the model reported to it and none of the ATen
    ops issued inside it; outside count_cost it is a null context;
  - roofline() gives the JAX package's keys, and its values equal the JAX
    formula with the H100 peaks in place of the TPU v5e's;
  - sample_kernel_cost on the Cornell box at 32 x 32 counts the same twice,
    leaves the caller's state bit for bit unchanged, gives the JAX
    package's chunks_per_sample, and flops = other + kernel flops.

Tolerance: none (integer counts; roofline values rounded as the JAX
function rounds them)."""

import torch

from julia_raytracer_tpu.render.renderer import MAX_CHUNK as JAX_MAX_CHUNK
from julia_raytracer_tpu.utils import roofline as jax_roofline
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import cornell_scene
from julia_raytracer_tpu_torch.utils import roofline


def test_count_cost_is_exact_on_hand_programs():
    x, y = torch.rand(1000), torch.rand(1000)
    _, c = roofline.count_cost(lambda: x + y)
    assert c.ops == {"add": [1, 1000.0, 12000.0]}
    _, c = roofline.count_cost(lambda: x.sum())
    assert c.ops == {"sum": [1, 1000.0, 4004.0]}
    a, b = torch.rand(6, 5), torch.rand(5, 7)
    _, c = roofline.count_cost(lambda: a @ b)
    assert c.ops == {"mm": [1, 2.0 * 6 * 7 * 5, 4.0 * (30 + 35 + 42)]}
    _, c = roofline.count_cost(lambda: a.view(30)[3:].t())
    assert c.ops == {} and c.totals()["other_bytes"] == 0.0


def test_kernel_region_counts_its_model_only():
    x = torch.rand(64)

    def fn():
        y = x * 2.0
        with roofline.kernel_region() as counter:
            (y * y).sum()
            counter.add_kernel("k", {"ops": 5, "bytes": 7})
        return y

    _, c = roofline.count_cost(fn)
    assert c.ops == {"mul": [1, 64.0, 512.0]}
    assert c.kernels == {"k": [1, 5.0, 7.0]}
    assert c.totals() == dict(other_flops=64.0, other_bytes=512.0,
                              kernel_flops=5.0, kernel_bytes=7.0)
    with roofline.kernel_region() as counter:
        assert counter is None


def test_roofline_matches_jax_formula(monkeypatch):
    monkeypatch.delenv("JRT_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("JRT_PEAK_HBM_GBS", raising=False)
    monkeypatch.setattr(jax_roofline, "V5E_PEAK_FLOPS", roofline.H100_PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "V5E_PEAK_HBM", roofline.H100_PEAK_HBM)
    assert roofline.H100_PEAK_FLOPS == 67e12
    assert roofline.H100_PEAK_HBM == 3.35e12
    for flops, nbytes, wall in ((3.1e9, 7.7e8, 0.0123), (0.0, 5e6, 1e-3),
                                (2e12, 0.0, 2.0), (1.0, 1.0, 0.0)):
        got = roofline.roofline(flops, nbytes, wall)
        want = jax_roofline.roofline(flops, nbytes, wall)
        assert set(got) == set(want)
        got.pop("mfu_note", None)
        want.pop("mfu_note", None)
        assert got == want
    note = roofline.roofline(1e9, 1e9, 1.0)["mfu_note"]
    assert "H100" in note and "count_cost" in note


def test_bound_takes_the_larger_time():
    assert roofline.bound(3.35e9, 0) == dict(bound_ms=1.0, bound_by="bytes")
    assert roofline.bound(0, 67e9) == dict(bound_ms=1.0, bound_by="operations")


def test_peak_overrides_move_roofline_not_bound(monkeypatch):
    """JRT_PEAK_* set roofline()'s peaks and its note names them; bound()
    stays at the data sheet's peaks."""
    monkeypatch.setenv("JRT_PEAK_TFLOPS", "10")
    monkeypatch.setenv("JRT_PEAK_HBM_GBS", "1000")
    r = roofline.roofline(1e12, 1e12, 1.0)
    assert r["mfu"] == 0.1 and r["hbm_util"] == 1.0
    assert "10 TFLOP/s" in r["mfu_note"] and "JRT_PEAK" in r["mfu_note"]
    assert roofline.bound(3.35e9, 0) == dict(bound_ms=1.0, bound_by="bytes")
    assert roofline.bound(0, 67e9) == dict(bound_ms=1.0, bound_by="operations")


def test_sample_kernel_cost_on_cornell():
    scene = cornell_scene()
    params = Params(resolution=32, samples=4, batch=1, bounces=4)
    r = Renderer(scene, params, device="cpu")
    st = make_trace_state(scene, params, device="cpu")
    r.trace_samples(st)
    before = [t.clone() for t in (st.image, st.albedo, st.normal, st.hits)]
    first = r.sample_kernel_cost(st)
    second = r.sample_kernel_cost(st)
    assert first == second
    assert st.samples == 1
    for a, b in zip(before, (st.image, st.albedo, st.normal, st.hits)):
        assert torch.equal(a, b)
    n = st.n_pixels
    assert first["chunks_per_sample"] == -(-n // min(JAX_MAX_CHUNK, n)) == 1
    assert first["flops"] == first["other_flops"] + first["kernel_flops"] > 0
    assert (first["bytes_accessed"]
            == first["other_bytes"] + first["kernel_bytes"] > 0)
    # the camera rays, then one intersect a body of the bounces + 1 bodies
    assert first["kernels"]["dense_intersect"][0] == params.bounces + 2
