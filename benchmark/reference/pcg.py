"""Counter-based per-lane random stream (PCG-RXS-M-XS, 32 bits), a frozen
copy of the stream the program draws from: one state per lane keyed by
(pixel, sample, seed), so the reference draws the same numbers for the
same path. States are int64 tensors holding values in [0, 2**32).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def _permute(s):
    word = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & MASK
    return (word >> 22) ^ word


def _lcg(s):
    return (s * 747796405 + 2891336453) & MASK


def seed_state(pixel, sample, seed: int):
    """The stream's start for each lane of pixel ids and sample ids."""
    s = ((pixel.to(torch.int64) & MASK) * 0x9E3779B9) & MASK
    s = (s + (sample.to(torch.int64) & MASK) * 0x85EBCA6B) & MASK
    s = (s + ((seed & MASK) * 0xC2B2AE35 & MASK)) & MASK
    return _lcg(_permute(_lcg(s)))


def rand1f(state):
    """(uniform float32 in [0, 1), next state)."""
    state = _lcg(state)
    return (_permute(state) >> 8).to(torch.float32) * (2.0 ** -24), state


def rand2f(state):
    a, state = rand1f(state)
    b, state = rand1f(state)
    return torch.stack([a, b], dim=-1), state
