"""Texture atlas sampling (bilinear, wrap-repeat) on flat tensors, port
of julia_raytracer_tpu/ops/texture.py.

All scene textures live in ONE flat [sum(w*h), 4] tensor; per-texture
metadata (offset/width/height/linear) is gathered per lane by texture
id. Semantics as in the JAX module: mod1 wrap (uv == integer maps to
1.0), bilinear 4-tap with per-tap sRGB decode for byte textures when
the caller wants linear values, texture id -1 -> white, zero-size
texture -> zeros.
"""

from __future__ import annotations

import torch

from julia_raytracer_tpu_torch.utils.color import srgb_to_rgb


def _mod1(x, m):
    """Julia mod1: result in (0, m], i.e. x == k*m maps to m."""
    r = torch.remainder(x, m)
    return torch.where(r == 0.0, m, r)


def eval_texture(tex, texture_id, uv, as_linear, no_interpolation=False):
    """Sample texture `texture_id` ([N] i32) at uv ([N, 2]) -> [N, 4].
    texture_id == -1 returns white."""
    n_tex = tex.width.shape[0]
    if n_tex == 0:
        return torch.ones(uv.shape[:-1] + (4,), device=uv.device)

    valid = texture_id >= 0
    tid = texture_id.clamp(0, n_tex - 1)
    width = tex.width[tid]
    height = tex.height[tid]
    offset = tex.offset[tid]
    linear = tex.linear[tid]
    wf = width.to(torch.float32)
    hf = height.to(torch.float32)

    s = _mod1(uv[..., 0], 1.0) * wf
    t = _mod1(uv[..., 1], 1.0) * hf
    s = torch.where(s < 0, s + wf, s)
    t = torch.where(t < 0, t + hf, t)

    i = torch.minimum(torch.clamp(s.to(torch.int32), min=0), width - 1)
    j = torch.minimum(torch.clamp(t.to(torch.int32), min=0), height - 1)
    ii = torch.where(i + 1 >= width, 0, i + 1)
    jj = torch.where(j + 1 >= height, 0, j + 1)
    u = s - i.to(torch.float32)
    v = t - j.to(torch.float32)
    last = tex.data.shape[0] - 1

    def lookup(x, y):
        idx = offset + y * width + x
        color = tex.data[idx.clamp(0, last)]
        if as_linear:
            # byte textures store raw sRGB; decode on tap
            return torch.where(linear[..., None], color, srgb_to_rgb(color))
        return color

    if no_interpolation:
        out = lookup(i, j)
    else:
        out = (
            lookup(i, j) * ((1 - u) * (1 - v))[..., None]
            + lookup(i, jj) * ((1 - u) * v)[..., None]
            + lookup(ii, j) * (u * (1 - v))[..., None]
            + lookup(ii, jj) * (u * v)[..., None]
        )

    empty = (width == 0) | (height == 0)
    out = torch.where(empty[..., None], 0.0, out)
    return torch.where(valid[..., None], out, 1.0)
