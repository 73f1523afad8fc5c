"""Counter-based per-lane RNG (PCG-RXS-M-XS 32-bit), bit-identical to
julia_raytracer_tpu/utils/rng.py.

The state is one 32-bit word per lane, keyed by (pixel, sample, seed),
so renders are deterministic and independent of how lanes are grouped.
Its bits are a parity contract with the JAX package.

PyTorch has no uint32 add or shift on the CPU, so the state is carried
as int32 tensors holding the same bit pattern, and every step computes
in int64 on values in [0, 2**32), masking with 0xFFFFFFFF after each
add and multiply. A product of two such values can exceed 2**63; its
low 32 bits survive the two's-complement wrap, which is all the mask
keeps. Right shifts act on non-negative int64 values, so they are
logical. `.to(torch.int32)` keeps the low 32 bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_MIX = 277803737


def _u32(state):
    """int32 bits -> int64 in [0, 2**32)."""
    return state.to(torch.int64) & _MASK


def _pcg_permute(s):
    word = (((s >> ((s >> 28) + 4)) ^ s) * _MIX) & _MASK
    return (word >> 22) ^ word


def _lcg(s):
    return (s * _MUL + _INC) & _MASK


def seed_state(pixel_id, sample_id, seed: int = 0):
    """Hash (pixel, sample, seed) into a well-mixed 32-bit state per lane.

    pixel_id/sample_id: integer tensors (or a python int for sample_id);
    returns int32 bits."""
    pix = _u32(torch.as_tensor(pixel_id))
    smp = _u32(torch.as_tensor(sample_id, device=pix.device))
    s = (pix * 0x9E3779B9) & _MASK
    s = (s + smp * 0x85EBCA6B) & _MASK
    s = (s + ((seed & _MASK) * 0xC2B2AE35 & _MASK)) & _MASK
    # two warm-up rounds decorrelate nearby (pixel, sample) pairs
    s = _lcg(s)
    s = _lcg(_pcg_permute(s))
    return s.to(torch.int32)


def next_uint32(state):
    """Advance one step; returns (output bits as int64 in [0, 2**32),
    new int32 state)."""
    s = _lcg(_u32(state))
    return _pcg_permute(s), s.to(torch.int32)


def rand1f(state):
    """One float in [0, 1) per lane; returns (value, new_state)."""
    bits, state = next_uint32(state)
    return (bits >> 8).to(torch.float32) * (2.0**-24), state


def rand2f(state):
    a, state = rand1f(state)
    b, state = rand1f(state)
    return torch.stack([a, b], dim=-1), state


def rand3f(state):
    a, state = rand1f(state)
    b, state = rand1f(state)
    c, state = rand1f(state)
    return torch.stack([a, b, c], dim=-1), state
