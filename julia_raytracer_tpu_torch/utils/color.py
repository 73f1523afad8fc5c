"""sRGB -> linear decode on tensors (port of the texture-side half of
julia_raytracer_tpu/utils/color.py): the exact piecewise curve applied
to the first three channels of RGBA data, alpha passed through."""

from __future__ import annotations

import torch


def srgb_to_rgb_scalar(c):
    """Piecewise sRGB decode."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def srgb_to_rgb(rgba):
    """Decode rgb channels, alpha passthrough."""
    return torch.cat([srgb_to_rgb_scalar(rgba[..., :3]), rgba[..., 3:]], dim=-1)
