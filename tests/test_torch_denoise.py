"""The à-trous denoiser (render/denoise.py) against the JAX package's, and
the JAX tests/test_denoise.py cases (the two corpus ones on the in-code
Cornell box).

Tolerance against JAX: rtol 1e-4, atol 1e-5 (measured on these inputs:
at most 1.2e-5 relative, 1.1e-4 absolute on values up to 339). The port sums
each pass's 25 taps with torch.sum where the JAX version adds them one by
one, and the two frameworks' exp and pow round apart in the last bit."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu.render.denoise import denoise_image as jax_denoise
from julia_raytracer_tpu_torch.render.denoise import denoise_image
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import cornell_scene

SIZE = 48  # the JAX tests' size; 8 bounces, their Params default


def _buffers(seed, h, w, pad, hdr):
    g = np.random.default_rng(seed)
    n = h * w + pad
    img = g.uniform(0, 1, (n, 4)).astype(np.float32)
    img[:, :3] = img[:, :3] ** 3 * hdr
    albedo = g.uniform(0, 1, (n, 3)).astype(np.float32)
    albedo[::7] = 0.0  # misses: no demodulation
    normal = g.normal(size=(n, 3)).astype(np.float32)
    normal[::5] = 0.0  # the zero-normal dummy
    normal[1::5] *= 1e-7
    return img, albedo, normal


@pytest.mark.parametrize("h, w, pad, hdr", [
    (24, 40, 173, 1.0), (32, 32, 0, 200.0), (7, 5, 3, 20.0), (1, 9, 0, 5.0),
])
def test_denoise_matches_jax(h, w, pad, hdr):
    img, albedo, normal = _buffers(h * w, h, w, pad, hdr)
    want = np.asarray(jax_denoise(img, albedo, normal, w, h))
    got = denoise_image(torch.from_numpy(img), torch.from_numpy(albedo),
                        torch.from_numpy(normal), w, h)
    assert got.shape == (h * w, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[:, 3].numpy(), img[: h * w, 3])


@pytest.fixture(scope="module")
def renders():
    """Cornell box at 48 x 48, 8 bounces: 4, 16 and (seed 1) 64 samples."""
    scene = cornell_scene()
    out = {}
    for spp, seed in ((4, 0), (16, 0), (64, 1)):
        p = Params(resolution=SIZE, samples=spp, batch=spp, sampler="path",
                   seed=seed)
        st = make_trace_state(scene, p, device="cpu")
        Renderer(scene, p, device="cpu").trace_samples(st)
        out[spp] = st
    return out


def test_denoise_reduces_mse(renders):
    noisy, ref = renders[4], renders[64].image[:, :3].numpy()
    den = denoise_image(noisy.image, noisy.albedo, noisy.normal,
                        noisy.width, noisy.height).numpy()
    err_noisy = ((noisy.image[:, :3].numpy() - ref) ** 2).mean(axis=1)
    err_den = ((den[:, :3] - ref) ** 2).mean(axis=1)
    assert err_den.mean() < 0.9 * err_noisy.mean(), (
        err_den.mean(), err_noisy.mean())

    def trimmed(e):
        return float(np.sort(e)[: int(len(e) * 0.99)].mean())

    assert trimmed(err_den) < 0.5 * trimmed(err_noisy), (
        trimmed(err_den), trimmed(err_noisy))
    np.testing.assert_array_equal(den[:, 3], noisy.image[:, 3].numpy())
    assert np.isfinite(den).all()


def test_denoise_preserves_albedo_edges(renders):
    st = renders[16]
    den = denoise_image(st.image, st.albedo, st.normal, st.width,
                        st.height)[:, :3].numpy().reshape(SIZE, SIZE, 3)
    raw = st.image[:, :3].numpy().reshape(SIZE, SIZE, 3)
    rows = slice(SIZE // 3, 2 * SIZE // 3)

    def chroma(img, cols):
        c = img[rows, cols].mean(axis=(0, 1))
        return c / max(c.sum(), 1e-8)

    np.testing.assert_allclose(chroma(den, slice(2, 6)),
                               chroma(raw, slice(2, 6)), atol=0.05)
    np.testing.assert_allclose(chroma(den, slice(-6, -2)),
                               chroma(raw, slice(-6, -2)), atol=0.05)
    left = den[rows, 2:6].mean(axis=(0, 1))
    right = den[rows, -6:-2].mean(axis=(0, 1))
    assert left[0] > left[1] and right[1] > right[0]


def test_denoise_flat_regions_smooth():
    g = np.random.default_rng(0)
    H = W = 32
    base = np.full((H * W, 3), 0.5, np.float32)
    noise = g.normal(0, 0.2, (H * W, 3)).astype(np.float32)
    img = np.concatenate([base + noise, np.ones((H * W, 1), np.float32)], 1)
    albedo = np.full((H * W, 3), 0.7, np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (H * W, 1))
    den = denoise_image(torch.from_numpy(img), torch.from_numpy(albedo),
                        torch.from_numpy(normal), W, H).numpy()
    var_in, var_out = float(img[:, :3].var()), float(den[:, :3].var())
    assert var_out < 0.05 * var_in, (var_out, var_in)
    np.testing.assert_allclose(den[:, :3].mean(), img[:, :3].mean(), atol=0.01)


def test_denoise_accepts_padded_buffers():
    g = np.random.default_rng(1)
    H, W = 24, 40
    n = H * W
    img = g.uniform(0, 1, (n, 4)).astype(np.float32)
    albedo = g.uniform(0, 1, (n, 3)).astype(np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    pad = 173
    args = [torch.from_numpy(a) for a in (img, albedo, normal)]
    padded = [torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in args]
    den = denoise_image(*args, W, H)
    den_p = denoise_image(*padded, W, H)
    assert den_p.shape == (n, 4)
    torch.testing.assert_close(den_p, den, rtol=0, atol=0)
