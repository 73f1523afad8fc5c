"""Adaptive sampling (render/renderer.py: adaptive_cdf, adaptive_draw,
pixel_sums, Renderer._adaptive_sample) on the in-code Cornell box, 32 x 32,
4 bounces, on the CPU: the JAX tests/test_adaptive.py cases, the draw
against a numpy transcription of the JAX kernel's, the per-pixel sums
against index_add, and whole renders against the JAX package's.

Against JAX: within the warm-up the two renders meet the slice criterion
(testing.image_close). After it they draw different pixels for some
lanes, by design: the m2 that XLA's fused arithmetic computes carries
last-bit noise (after one sample a pixel's m2 is ~1e-6 in the JAX
package, where exact arithmetic, and the port, give 0), so the two CDFs
differ in the last bits and a draw near a pixel boundary lands on the
neighbour. A
pixel's value is the mean of its samples 0 .. count - 1 in both packages,
so the test holds the pixels whose counts agree (76% here) to the slice
criterion, the budget exactly, and the whole image's mean within 1e-2
relative (measured 1.8e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, TraceState, adaptive_cdf, adaptive_draw,
    inclusive_scan, make_trace_state, pixel_sums,
)
from julia_raytracer_tpu_torch.testing import cornell_scene, image_close
from torch_parity import cornell_scene_jax

RES, BOUNCES = 32, 4


def _render(adaptive, samples, warmup=2, res=RES, seed=0):
    scene = cornell_scene()
    p = Params(resolution=res, samples=samples, bounces=BOUNCES,
               sampler="path", batch=samples, seed=seed, adaptive=adaptive,
               adaptive_warmup=warmup)
    r = Renderer(scene, p, device="cpu")
    state = make_trace_state(scene, p, device="cpu")
    return r, r.trace_samples(state)


def _render_jax(samples, warmup):
    scene = cornell_scene_jax()
    p = jren.Params(resolution=RES, samples=samples, bounces=BOUNCES,
                    sampler="path", batch=samples, seed=0, adaptive=True,
                    adaptive_warmup=warmup)
    state = jren.make_trace_state(scene, p)
    return jren.Renderer(scene, p).trace_samples(state)


def test_warmup_matches_uniform():
    """With samples <= warmup the adaptive path reproduces the uniform
    accumulation (same placement and RNG keys; only the running mean's
    arithmetic differs)."""
    _, s_uni = _render(adaptive=False, samples=2)
    _, s_ada = _render(adaptive=True, samples=2, warmup=4)
    np.testing.assert_allclose(s_ada.image.numpy(), s_uni.image.numpy(),
                               atol=2e-5)
    assert int(s_ada.counts.min()) == int(s_ada.counts.max()) == 2


def test_adaptive_allocation_and_determinism():
    _, s1 = _render(adaptive=True, samples=8, warmup=2)
    _, s2 = _render(adaptive=True, samples=8, warmup=2)
    c = s1.counts.numpy()
    assert c.min() >= 2
    assert c.sum() == 8 * s1.n_pixels
    var = s1.m2.numpy() / np.maximum(c - 1, 1)
    hi = c > c.mean()
    assert hi.any() and (~hi).any()
    assert var[hi].mean() > var[~hi].mean()
    for name in ("image", "albedo", "normal", "hits", "counts", "m2"):
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name
    assert torch.isfinite(s1.image).all()


def test_adaptive_not_worse_than_uniform():
    _, s_ref = _render(adaptive=False, samples=48, seed=3)
    ref = s_ref.image[:, :3].numpy()
    _, s_uni = _render(adaptive=False, samples=12)
    _, s_ada = _render(adaptive=True, samples=12, warmup=3)
    mse_uni = float(((s_uni.image[:, :3].numpy() - ref) ** 2).mean())
    mse_ada = float(((s_ada.image[:, :3].numpy() - ref) ** 2).mean())
    assert mse_ada < mse_uni * 1.35, (mse_ada, mse_uni)


def test_adaptive_checkpoint_roundtrip(tmp_path):
    r, s = _render(adaptive=True, samples=6, warmup=2)
    path = str(tmp_path / "ck.npz")
    s.save(path)
    # the JAX package's checkpoint: same keys and dtypes, and it loads it
    z = np.load(path)
    assert sorted(z.files) == sorted(
        ["width", "height", "samples", "image", "albedo", "normal", "hits",
         "counts", "m2"])
    js = jren.TraceState.load(path)
    assert js.counts.dtype == jnp.int32 and js.m2.dtype == jnp.float32
    s2 = TraceState.load(path, device="cpu")
    assert s2.counts is not None and s2.m2 is not None
    for name in ("image", "albedo", "normal", "hits", "counts", "m2"):
        assert torch.equal(getattr(s, name), getattr(s2, name)), name
    r.params.samples = 8
    s2 = r.trace_samples(s2)
    assert int(s2.counts.sum()) == 8 * s2.n_pixels


def test_adaptive_budget_with_multiple_chunks(monkeypatch):
    """Tail chunks draw fewer lanes: with a chunk that does not divide
    the pixel count each round still adds exactly n_pixels samples, and a
    uniform resume of an adaptive state refuses."""
    monkeypatch.setattr(tren, "MAX_CHUNK", 700)  # 1024 px -> 2 chunks
    r, s = _render(adaptive=True, samples=4, warmup=2)
    assert int(s.counts.sum()) == 4 * s.n_pixels
    r.params.adaptive = False
    r.params.samples = 6
    with pytest.raises(ValueError, match="adaptive"):
        r.trace_samples(s)


def _numpy_draw(cdf, n, chunk, batch_id, seed):
    """JAX render/renderer.py:471-495 in numpy on the given float32 CDF,
    the uniforms from the JAX package's rng."""
    lane = jnp.arange(chunk, dtype=jnp.int32)
    u, _ = jrng.rand2f(jrng.seed_state(lane, jnp.int32(batch_id), seed + 0x5EED))
    u = np.asarray(u)[:, 0]
    ids = np.clip(np.searchsorted(cdf, u).astype(np.int32), 0, n - 1)
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    pos = np.arange(chunk, dtype=np.int32)
    is_start = np.concatenate([np.ones(1, bool), sid[1:] != sid[:-1]])
    start_pos = np.maximum.accumulate(np.where(is_start, pos, 0))
    rank = np.zeros(chunk, np.int32)
    rank[order] = pos - start_pos
    return ids, rank


@pytest.mark.parametrize("n, chunk, batch_id, seed", [
    (1024, 1024, 9, 0), (1000, 700, 31, 7), (300, 300, 2**31 - 1, 2**32 - 0x5EEE),
])
def test_draw_matches_numpy(n, chunk, batch_id, seed):
    g = np.random.default_rng(n + chunk)
    counts = g.integers(1, 12, n).astype(np.int32)
    m2 = (g.uniform(0, 1, n) ** 6).astype(np.float32)
    m2[::9] = 0.0
    cdf = adaptive_cdf(torch.from_numpy(counts), torch.from_numpy(m2))
    var = m2.astype(np.float64) / np.maximum(counts - 1.0, 1.0)
    w = np.sqrt(var)
    w = w + 0.05 * w.mean() + 1e-12
    np.testing.assert_allclose(cdf.numpy(), np.cumsum(w) / w.sum(), rtol=2e-6)
    assert cdf[-1] == 1.0
    ids, rank, order = adaptive_draw(cdf, chunk, batch_id, seed)
    want_ids, want_rank = _numpy_draw(cdf.numpy(), n, chunk, batch_id, seed)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want_ids, kind="stable"))
    # the draw stream's seed wraps at 32 bits, as the rng's seed does
    wrapped = adaptive_draw(cdf, chunk, batch_id, seed + 2**32)
    for a, b in zip(wrapped, (ids, rank, order)):
        assert torch.equal(a, b)


def test_pixel_sums_match_index_add():
    g = np.random.default_rng(0)
    for n_lanes, n_pix in ((1, 1), (7, 3), (1000, 60), (4097, 4097)):
        sid = torch.from_numpy(np.sort(g.integers(0, n_pix, n_lanes)))
        vals = torch.from_numpy(g.normal(size=(n_lanes, 5)))  # float64
        got = pixel_sums(sid, vals, n_pix)
        want = torch.zeros(n_pix, 5, dtype=vals.dtype).index_add_(0, sid, vals)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        x = vals[:, 0]
        torch.testing.assert_close(inclusive_scan(x), torch.cumsum(x, 0),
                                   rtol=1e-12, atol=1e-12)


def test_warmup_render_matches_jax():
    js = _render_jax(samples=2, warmup=4)
    _, ts = _render(adaptive=True, samples=2, warmup=4)
    image_close(ts.image.numpy(), np.asarray(js.image))
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.hits.numpy(), np.asarray(js.hits))


def test_adaptive_render_matches_jax():
    js = _render_jax(samples=4, warmup=2)
    _, ts = _render(adaptive=True, samples=4, warmup=2)
    jc, tc = np.asarray(js.counts), ts.counts.numpy()
    assert jc.sum() == tc.sum() == 4 * ts.n_pixels
    same = jc == tc
    assert same.mean() >= 0.5, same.mean()
    image_close(ts.image.numpy()[same], np.asarray(js.image)[same])
    got, want = ts.image.numpy().mean(), np.asarray(js.image).mean()
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)
