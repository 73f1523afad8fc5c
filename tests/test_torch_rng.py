"""The port's counter-based RNG (julia_raytracer_tpu_torch/utils/rng.py)
is bit-identical to julia_raytracer_tpu/utils/rng.py: same seeds, same
states, same floats, over many lanes including ids near 2**31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.utils import rng as trng


def _ids(seed, n=8192):
    g = np.random.default_rng(seed)
    pix = g.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    pix[:16] = np.arange(2**31 - 16, 2**31, dtype=np.int64)  # near 2**31
    pix[16:32] = np.arange(16)
    smp = g.integers(0, 2**31, n, dtype=np.int64).astype(np.int32)
    smp[:8] = 2**31 - 1
    return pix, smp


def _bits(jax_state):
    return np.asarray(jax_state).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
def test_seed_state_bit_identical(seed):
    pix, smp = _ids(seed % 97)
    want = _bits(jrng.seed_state(jnp.asarray(pix), jnp.asarray(smp), seed))
    got = trng.seed_state(torch.from_numpy(pix), torch.from_numpy(smp), seed)
    np.testing.assert_array_equal(got.numpy(), want)
    # scalar sample id, as the renderer passes it
    want0 = _bits(jrng.seed_state(jnp.asarray(pix), jnp.int32(7), seed))
    got0 = trng.seed_state(torch.from_numpy(pix), 7, seed)
    np.testing.assert_array_equal(got0.numpy(), want0)


@pytest.mark.parametrize("draw", ["rand1f", "rand2f", "rand3f"])
def test_draws_bit_identical(draw):
    pix, smp = _ids(3)
    js = jrng.seed_state(jnp.asarray(pix), jnp.asarray(smp), 5)
    ts = torch.from_numpy(_bits(js).copy())
    for _ in range(6):  # a few chained draws
        jv, js = getattr(jrng, draw)(js)
        tv, ts = getattr(trng, draw)(ts)
        np.testing.assert_array_equal(
            tv.numpy().view(np.int32), np.asarray(jv).view(np.int32)
        )
        np.testing.assert_array_equal(ts.numpy(), _bits(js))
    assert tv.dtype == torch.float32
    assert (tv >= 0).all() and (tv < 1).all()
