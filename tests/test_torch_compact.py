"""The lane compactor's plain PyTorch versions (what csrc/lane_compact.cu
computes, and what the wrappers run for CPU tensors) are bit-exact
against the Pallas TPU kernels they replace (pallas_compact.compact_state
and expand_outputs, interpret mode) on adversarial payloads (NaN, Inf,
denormal and -0 floats, full-range int32/u32 words), and the port's
two-phase wavefront loop equals its plain loop bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops import pallas_compact as pc
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.render.integrator import trace_wavefront
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.testing import cornell_scene
from julia_raytracer_tpu_torch.utils import rng as rng_mod

PATTERNS = ["random", "dense", "sparse", "exact_cap", "empty", "runs"]


def _adversarial_f32(g, n):
    bits = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return bits.view(np.float32)


def _leaves(g, n):
    """The leaves of tests/test_compact.py; the u32 leaf rides as int32
    bits on the port side (the port carries its rng that way)."""
    return [
        _adversarial_f32(g, 3 * n).reshape(n, 3),
        _adversarial_f32(g, n),
        g.integers(-(2**31), 2**31, n).astype(np.int32),
        g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        g.integers(0, 2, n).astype(bool),
        _adversarial_f32(g, 3 * n).reshape(n, 3),
    ]


def _torch(leaf):
    if leaf.dtype == np.uint32:
        leaf = leaf.view(np.int32)
    return torch.from_numpy(leaf.copy())


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint8) if a.dtype != bool else a


def _alive(pattern, n, cap):
    g = np.random.default_rng(PATTERNS.index(pattern))
    if pattern == "random":
        alive = g.random(n) < 0.2
    elif pattern == "dense":
        alive = g.random(n) < 0.24
        alive[: n // 8] = True
        alive &= np.cumsum(alive) <= cap
    elif pattern == "sparse":
        alive = g.random(n) < 0.01
    elif pattern == "exact_cap":
        alive = np.zeros(n, bool)
        alive[g.permutation(n)[:cap]] = True
    elif pattern == "empty":
        alive = np.zeros(n, bool)
    else:  # runs: whole tiles dead, whole tiles mostly alive
        alive = np.zeros(n, bool)
        alive[1024:2048] = g.random(1024) < 0.9
        alive[3072:4096] = g.random(1024) < 0.5
        alive &= np.cumsum(alive) <= cap
    assert alive.sum() <= cap
    return alive


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compact_bit_exact_vs_pallas(pattern):
    n, cap = 4096, 1024
    leaves = _leaves(np.random.default_rng(17), n)
    alive = _alive(pattern, n, cap)
    want = pc.compact_state([jnp.asarray(x) for x in leaves],
                            jnp.asarray(alive), cap, interpret=True)
    planes, specs = lc.leaves_to_planes([_torch(x) for x in leaves])
    assert planes.shape == (3 + 1 + 1 + 1 + 1 + 3, n)
    got = lc.planes_to_leaves(
        lc.compact_planes(planes, torch.from_numpy(alive), cap), specs
    )
    total = int(alive.sum())
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(_bits(g_[:total]), _bits(w_[:total]))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_expand_bit_exact_vs_pallas(pattern):
    n, cap = 4096, 1024
    g = np.random.default_rng(23)
    narrow = [x[:cap] for x in _leaves(g, n)[:5]]
    fallback = _leaves(g, n)[:5]
    alive = _alive(pattern, n, cap)
    want = pc.expand_outputs([jnp.asarray(x) for x in narrow],
                             jnp.asarray(alive),
                             [jnp.asarray(x) for x in fallback], interpret=True)
    nar, specs = lc.leaves_to_planes([_torch(x) for x in narrow])
    fb, _ = lc.leaves_to_planes([_torch(x) for x in fallback])
    got = lc.planes_to_leaves(
        lc.expand_planes(nar, torch.from_numpy(alive), fb), specs
    )
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(_bits(g_), _bits(w_))


def test_planes_round_trip_and_checks():
    g = np.random.default_rng(5)
    leaves = [_torch(x) for x in _leaves(g, 2048)]
    planes, specs = lc.leaves_to_planes(leaves)
    for a, b in zip(lc.planes_to_leaves(planes, specs), leaves):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert a.dtype == b.dtype and a.shape == b.shape
    with pytest.raises(TypeError):
        lc.leaves_to_planes([torch.zeros(4, dtype=torch.float64)])


@pytest.fixture(scope="module")
def cornell_rays():
    """Camera rays of a 128 x 128 Cornell render (n = 16,384 lanes)."""
    scene = cornell_scene()
    params = Params(resolution=128, samples=1, bounces=6)
    r = Renderer(scene, params, device="cpu")
    st = make_trace_state(scene, params, device="cpu")
    n = st.width * st.height
    pix = torch.arange(n, dtype=torch.int32)
    rng = rng_mod.seed_state(pix, 0, 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = torch.stack([pix % st.width, pix // st.width], dim=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (st.width, st.height), puv, luv,
                           False)
    plain = trace_wavefront(r.dscene, r.config,
                            r.options._replace(compact=False), ro, rd, rng,
                            intersector=r.intersect)
    return r, ro, rd, rng, plain


@pytest.mark.parametrize("levels", [1, 2])
def test_wavefront_compaction_bit_identical(cornell_rays, levels):
    """Two-phase dispatch == plain loop, bit for bit, on the radiance, hit,
    albedo and normal outputs. DIV=2 so levels=2 engages two boundaries at
    n=16,384 (caps 8192, then 4096). The rng output is left out, as in
    tests/test_compact.py: the plain loop advances dead lanes' streams
    until the last survivor dies, the narrow loop does not."""
    r, ro, rd, rng, plain = cornell_rays
    opts = r.options._replace(compact=True, compact_div=2,
                              compact_levels=levels)
    syncs = trace_wavefront.host_syncs
    got = trace_wavefront(r.dscene, r.config, opts, ro, rd, rng,
                          intersector=r.intersect)
    assert trace_wavefront.host_syncs > syncs
    for a, b in zip(got[:4], plain[:4]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
