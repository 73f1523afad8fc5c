"""Vector/frame math on batched tensors (port of
julia_raytracer_tpu/utils/vecmath.py, the parts the path tracer calls).

Every function takes float32 tensors whose last axis is the vector
dimension ([..., 3] vectors, [..., 4, 3] frames: rows x, y, z axes then
the origin). Operation order follows the JAX module so the two round
alike.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return (a * b).sum(dim=-1)


def dot_keep(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(a):
    d = dot(a, a)
    pos = d > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, d, 1.0)), 0.0)


def normalize(a):
    """Zero-safe normalize: returns `a` unchanged when |a| == 0."""
    l = length(a)[..., None]
    return torch.where(l != 0, a / torch.where(l == 0, 1.0, l), a)


def orthonormalize(a, b):
    return normalize(a - b * dot_keep(a, b))


def reflect(w, n):
    return -w + 2.0 * dot_keep(n, w) * n


def refract(w, n, inv_eta):
    """Refraction; 0 on total internal reflection. `inv_eta` is a scalar
    or one value per lane."""
    inv_eta = torch.as_tensor(inv_eta, dtype=torch.float32, device=w.device)
    if inv_eta.dim() == w.dim() - 1:
        inv_eta = inv_eta[..., None]
    cosine = dot_keep(n, w)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    refr = -w * inv_eta + (
        inv_eta * cosine - torch.sqrt(torch.clamp(k, min=0.0))
    ) * n
    return torch.where(k >= 0.0, refr, torch.zeros_like(w))


def transform_point(frame, p):
    """(x*p0 + y*p1 + z*p2) + o."""
    return mat_mul_vec(frame[..., :3, :], p) + frame[..., 3, :]


def transform_vector(frame_or_mat, v):
    return mat_mul_vec(frame_or_mat[..., :3, :], v)


def transform_direction(frame_or_mat, v):
    return normalize(transform_vector(frame_or_mat, v))


def transform_normal(frame, n):
    """Rigid frames rotate and normalize."""
    return transform_direction(frame, n)


def mat_mul_vec(m, v):
    """Row combination m[0]*v0 + m[1]*v1 + m[2]*v2 ([..., 3, 3] x [..., 3])."""
    return (
        m[..., 0, :] * v[..., 0:1]
        + m[..., 1, :] * v[..., 1:2]
        + m[..., 2, :] * v[..., 2:3]
    )


def basis_fromz(v):
    """Branchless ONB (Duff et al.); returns [..., 3, 3] rows x, y, z."""
    z = normalize(v)
    sign = torch.where(z[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = torch.stack(
        [1.0 + sign * z[..., 0] * z[..., 0] * a, sign * b, -sign * z[..., 0]],
        dim=-1,
    )
    y = torch.stack([b, sign + z[..., 1] * z[..., 1] * a, -z[..., 1]], dim=-1)
    return torch.stack([x, y, z], dim=-2)
