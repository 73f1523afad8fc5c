"""The port's trace_wavefront against the JAX package's on the in-code
Cornell box: the same DeviceScene arrays (through
device_scene_from_numpy), rays and rng streams into both integrators'
plain loops (the JAX CPU default). One JAX compile per sampler.

Criterion and tolerance as in test_torch_slice.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.camera import sample_camera as jax_sample_camera
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.render.scene_device import (
    build_device_scene as jax_build_device_scene,
)
from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.scene_device import device_scene_from_numpy
from julia_raytracer_tpu_torch.testing import image_close
from torch_parity import (
    BOUNCES, RES, cornell_scene_jax, jax_config_fields, jax_scene_arrays,
)


@pytest.mark.parametrize("sampler", ["path", "naive"])
def test_trace_wavefront_matches_jax(sampler):
    """Same DeviceScene arrays (through device_scene_from_numpy), rays and
    rng into both integrators' plain loops (the JAX CPU default)."""
    dj, cj = jax_build_device_scene(cornell_scene_jax())
    dt, ct = device_scene_from_numpy(jax_scene_arrays(dj), jax_config_fields(cj),
                                     device="cpu")
    cam = jren.camera_arrays(cornell_scene_jax().cameras[0])
    n = RES * RES
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = jrng.seed_state(pix, jnp.int32(3), 0)
    puv, rng = jrng.rand2f(rng)
    luv, rng = jrng.rand2f(rng)
    ij = jnp.stack([pix % RES, pix // RES], axis=-1)
    ro, rd = jax_sample_camera(cam, ij, (RES, RES), puv, luv, False)
    opts = jint.TraceOptions(sampler=sampler, bounces=BOUNCES)
    want = jax.jit(
        lambda ro, rd, rng: jint.trace_wavefront(dj, cj, opts, ro, rd, rng)
    )(ro, rd, rng)
    got = tint.trace_wavefront(
        dt, ct, tint.TraceOptions(sampler=sampler, bounces=BOUNCES),
        torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
        torch.from_numpy(np.asarray(rng).view(np.int32).copy()),
    )
    image_close(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in (2, 3):  # first-hit AOVs
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
