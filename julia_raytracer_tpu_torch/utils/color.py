"""sRGB <-> linear conversions (the exact piecewise curve) and byte
packing, ported from julia_raytracer_tpu/utils/color.py.

The decode runs on tensors (texture lookups on the device). The encode
and the byte helpers run on numpy arrays on the host (PNG output), with
the same numpy arithmetic as the JAX package's host path, so they give
the same bits. Both apply the curve to the first three channels of RGBA
data and pass alpha through.
"""

from __future__ import annotations

import numpy as np
import torch


def srgb_to_rgb_scalar(c):
    """Piecewise sRGB decode."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def srgb_to_rgb(rgba):
    """Decode rgb channels, alpha passthrough."""
    return torch.cat([srgb_to_rgb_scalar(rgba[..., :3]), rgba[..., 3:]], dim=-1)


def rgb_to_srgb_scalar(c):
    """Piecewise sRGB encode (numpy)."""
    safe = np.where(c > 0.0031308, c, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * safe ** (1.0 / 2.4) - 0.055)


def rgb_to_srgb(rgba):
    """Encode rgb channels, alpha passthrough (numpy)."""
    return np.concatenate([rgb_to_srgb_scalar(rgba[..., :3]), rgba[..., 3:]], axis=-1)


def byte_to_float(b):
    return b.astype(np.float32) / 255.0


def float_to_byte(f):
    """trunc(f * 256) clamped to [0, 255] (numpy)."""
    return np.clip(np.trunc(f * 256.0), 0, 255).astype(np.uint8)
