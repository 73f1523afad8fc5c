"""The wavefront sort: the port's _morton3 and _sort_key against the JAX
package's, bit for bit, and trace_wavefront(sort_rays=True) against the
JAX package's sorted trace_wavefront on the in-code Cornell box at
n = 16,384 (so that sorted-slice compaction engages on both sides: 2
levels at DIV 2), and against its own unsorted loop.

Tolerances: the keys exactly (int32); the sorted integrators as
test_torch_wavefront.py holds the unsorted ones (image_close, hit flags
equal, first-hit AOVs within 1e-5); sort on vs off in the port bit for
bit (each lane's path does not depend on its position in the wavefront,
and the Cornell box's dense intersector tests every quad)."""

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
from julia_raytracer_tpu_torch.ops.traversal import Intersector
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.scene_device import device_scene_from_numpy
from julia_raytracer_tpu_torch.testing import image_close
from torch_parity import cornell_scene_jax, jax_config_fields, jax_scene_arrays

RES = 128  # 16,384 lanes: the narrowest wavefront that compacts
BOUNCES = 4


def _rays(seed, n=50_000):
    """Origins inside and outside the bounds, directions with exact zero,
    negative zero and negative components, some NaN-free extremes."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-3.0, 4.0, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    zero = g.random((n, 3)) < 0.1
    rd[zero] = 0.0
    rd[g.random((n, 3)) < 0.05] = -0.0
    rd[: n // 10] /= np.linalg.norm(rd[: n // 10], axis=1, keepdims=True) + 1e-20
    ro[:7] = [[-1, 0, -1], [1, 2, 1], [0, 1, 3.9], [1e30, -1e30, 0],
              [-1, -1, -1], [5, 5, 5], [0.5, 0.5, 0.5]]
    return ro, rd


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_key_matches_jax(seed):
    ro, rd = _rays(seed)
    vmin = np.array([-1.0, 0.0, -1.0], np.float32)
    vmax = np.array([1.0, 2.0, 1.0], np.float32)
    want_m = np.asarray(jint._morton3(jnp.asarray(ro), jnp.asarray(vmin),
                                      jnp.asarray(vmax)))
    want_k = np.asarray(jint._sort_key(jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(vmin), jnp.asarray(vmax)))
    t = [torch.from_numpy(x) for x in (ro, rd, vmin, vmax)]
    got_m = tint._morton3(t[0], t[2], t[3])
    got_k = tint._sort_key(*t)
    assert got_m.dtype == got_k.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    assert want_k.min() >= 0 and want_k.max() < 2**30
    # stable argsort of the keys, dead lanes keyed 0x7FFFFFFF, as in JAX
    alive = np.random.default_rng(seed).random(len(ro)) < 0.6
    jkey = jnp.where(jnp.asarray(alive), jnp.asarray(want_k), 0x7FFFFFFF)
    tkey = torch.where(torch.from_numpy(alive), got_k, 0x7FFFFFFF)
    np.testing.assert_array_equal(torch.argsort(tkey, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jkey)))


@pytest.fixture(scope="module")
def cornell_case():
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
    targs = (torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
             torch.from_numpy(np.asarray(rng).view(np.int32).copy()))
    return dj, cj, dt, ct, (ro, rd, rng), targs


def test_sorted_trace_wavefront_matches_jax(cornell_case):
    dj, cj, dt, ct, (ro, rd, rng), targs = cornell_case
    opts = jint.TraceOptions(sampler="path", bounces=BOUNCES, sort_rays=True)
    want = jax.jit(
        lambda ro, rd, rng: jint.trace_wavefront(dj, cj, opts, ro, rd, rng)
    )(ro, rd, rng)
    got = tint.trace_wavefront(
        dt, ct, tint.TraceOptions(sampler="path", bounces=BOUNCES,
                                  sort_rays=True), *targs)
    image_close(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in (2, 3):  # first-hit AOVs
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)


def test_sort_on_and_off_agree_bit_for_bit(cornell_case, monkeypatch):
    """Sorted (sorted-slice compaction, 2 levels), unsorted (the lane
    compactor) and sorted without compaction: radiance, hit, albedo and
    normal identical."""
    _, _, dt, ct, _, targs = cornell_case
    widths = []
    body_calls = []
    build = tint.build_intersector

    def spy(dscene, config, **kw):
        isect = build(dscene, config, **kw)

        def counted(ro, rd, tmin, tmax):
            widths.append(ro.shape[0])
            return isect(ro, rd, tmin, tmax)
        return Intersector(counted)

    monkeypatch.setattr(tint, "build_intersector", spy)
    base = tint.TraceOptions(sampler="path", bounces=BOUNCES)
    runs = {}
    for name, opts in (("unsorted", base),
                       ("sorted", base._replace(sort_rays=True)),
                       ("sorted_plain", base._replace(sort_rays=True,
                                                      compact=False))):
        widths.clear()
        runs[name] = tint.trace_wavefront(dt, ct, opts, *targs)
        body_calls.append(sorted(set(widths)))
    # the sorted path narrowed to 8,192 then 4,096 lanes (DIV 2)
    assert body_calls[1] == [4096, 8192, 16384]
    assert body_calls[2] == [16384]
    for name in ("sorted", "sorted_plain"):
        for a, b in zip(runs["unsorted"][:4], runs[name][:4]):
            assert torch.equal(a, b), name
