"""--addsky / --envname (scene/augment.py) against the JAX package's:
make_sunsky bit-equal for three (sun elevation, turbidity, size) triples;
add_sky and add_environment (a PNG panorama written by save_png, an HDR
one written by cv2) leave the port's SceneData field for field equal to
the JAX package's; and the JAX tests/test_augment.py cases on the in-code
Cornell box instead of the corpus one: the sky's physical shape, the sun
moving with its elevation, and both augmentations rendering through the
port's device scene and integrator (plain versions on the CPU)."""

import cv2
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.scene import augment as jaug
from julia_raytracer_tpu_torch.render.integrator import (
    TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.augment import (
    add_environment, add_sky, make_sunsky,
)
from julia_raytracer_tpu_torch.testing import cornell_scene
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.imgio import save_png
from test_torch_loader import _assert_same
from torch_parity import cornell_scene_jax


@pytest.mark.parametrize("elevation, turbidity, size", [
    (np.pi / 4, 3.0, (256, 128)),
    (np.deg2rad(10), 2.0, (128, 64)),
    (np.deg2rad(70), 6.5, (96, 40)),
])
def test_sunsky_matches_jax(elevation, turbidity, size):
    kw = dict(width=size[0], height=size[1], sun_elevation=elevation,
              turbidity=turbidity)
    got, want = make_sunsky(**kw), jaug.make_sunsky(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_add_sky_matches_jax():
    port, jax_scene = cornell_scene(), cornell_scene_jax()
    add_sky(port, sun_elevation=0.7, turbidity=4.0, intensity=1.5)
    jaug.add_sky(jax_scene, sun_elevation=0.7, turbidity=4.0, intensity=1.5)
    _assert_same(port, jax_scene, "scene")
    assert len(port.environments) == 1 and port.textures[-1].linear


@pytest.mark.parametrize("ext", ["png", "hdr"])
def test_add_environment_matches_jax(tmp_path, ext):
    g = np.random.default_rng(5)
    path = str(tmp_path / f"pano.{ext}")
    if ext == "png":
        save_png(path, g.uniform(0, 1, (8, 16, 4)).astype(np.float32),
                 linear=False)
    else:
        cv2.imwrite(path, g.uniform(0, 5, (8, 16, 3)).astype(np.float32))
    port, jax_scene = cornell_scene(), cornell_scene_jax()
    add_environment(port, path)
    jaug.add_environment(jax_scene, path)
    _assert_same(port, jax_scene, "scene")
    assert port.environments[-1].emission_tex == len(port.textures) - 1


def test_sunsky_physical_shape():
    img = make_sunsky(width=256, height=128, sun_elevation=np.pi / 4)
    assert img.shape == (128, 256, 4)
    assert np.isfinite(img).all() and (img >= 0).all()
    rgb = img[..., :3]
    # sun at phi=0, elevation 45deg -> zenith angle 45deg -> v=0.25
    assert rgb[32, 0].max() == rgb.reshape(-1, 3).max()
    zenith = rgb[1].mean(axis=0)
    horizon = rgb[62].mean(axis=0)
    assert zenith[2] > zenith[0]
    assert horizon.mean() > zenith.mean()
    assert rgb[96:].mean() < rgb[:64].mean()


def test_sunsky_elevation_moves_sun():
    lo = make_sunsky(width=128, height=64, sun_elevation=np.deg2rad(10))
    hi = make_sunsky(width=128, height=64, sun_elevation=np.deg2rad(70))
    row_lo = np.unravel_index(np.argmax(lo[..., 1]), lo.shape[:2])[0]
    row_hi = np.unravel_index(np.argmax(hi[..., 1]), hi.shape[:2])[0]
    assert row_hi < row_lo


def _radiance(scene):
    dsc, cfg = build_device_scene(scene, device="cpu")
    n = 1024
    g = np.random.default_rng(3)
    ro = torch.tensor(np.tile([0.0, 1.0, 3.9], (n, 1)), dtype=torch.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rngs = rng_mod.seed_state(torch.arange(n, dtype=torch.int32), 0, 0)
    rad = trace_wavefront(dsc, cfg, TraceOptions(sampler="path", bounces=3),
                          ro, torch.from_numpy(rd), rngs,
                          intersector=build_intersector(dsc, cfg))[0]
    return cfg, rad.numpy()


def test_addsky_renders():
    scene = cornell_scene()
    n_env0 = len(scene.environments)
    add_sky(scene)
    assert len(scene.environments) == n_env0 + 1
    cfg, rad = _radiance(scene)
    assert cfg.n_envs == n_env0 + 1
    assert np.isfinite(rad).all() and rad.max() > 0


def test_envname_renders(tmp_path):
    img = np.zeros((8, 16, 4), np.float32)
    img[..., 0] = 0.8
    img[..., 3] = 1.0
    path = str(tmp_path / "pano.png")
    save_png(path, img, linear=False)
    scene = cornell_scene()
    n_env0, n_tex0 = len(scene.environments), len(scene.textures)
    add_environment(scene, path)
    assert len(scene.environments) == n_env0 + 1
    assert scene.environments[-1].emission_tex == n_tex0
    cfg, rad = _radiance(scene)
    assert cfg.n_envs == n_env0 + 1
    assert np.isfinite(rad).all()
