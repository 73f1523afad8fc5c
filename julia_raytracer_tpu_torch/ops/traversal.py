"""Closest-hit record and the dense reference intersector (port of the
`Hit`, `hit_surface` and `intersect_bruteforce` parts of
julia_raytracer_tpu/ops/traversal.py).

`intersect_bruteforce` is the reference the dense kernel
(ops/dense_intersect.py) is held against. On a miss it returns prim 0
and t = F32_MAX, as the JAX function does; the kernel returns prim -1
and t = tmax. Parity tests compare hit lanes only. The BVH walk
(`intersect_bvh`) is not ported yet (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, interpolate_quad, intersect_quad, quad_normal,
)


class Hit(NamedTuple):
    """Closest-hit record. `position` is the interpolated surface point
    and `gnormal` the uv-independent element normal."""

    hit: torch.Tensor  # bool [N]
    prim: torch.Tensor  # i32 [N]
    u: torch.Tensor  # f32 [N]
    v: torch.Tensor  # f32 [N]
    t: torch.Tensor  # f32 [N]
    position: torch.Tensor  # f32 [N, 3]
    gnormal: torch.Tensor  # f32 [N, 3]
    instance: torch.Tensor  # i32 [N] owning instance


def hit_surface(prim_verts, prim, u, v):
    """(position, gnormal) of hit records via a vertex gather."""
    verts = prim_verts[prim.clamp(0, prim_verts.shape[0] - 1)]
    p1, p2, p3, p4 = (verts[..., k, :] for k in range(4))
    position = interpolate_quad(p1, p2, p3, p4, u, v)
    return position, quad_normal(p1, p2, p3, p4)


def intersect_bruteforce(prim_verts, ro, rd, tmin, tmax, prim_instance=None):
    """Dense all-prims intersection. prim_verts: [Q,4,3]; rays: [N,3].
    Closest hit wins; ties keep the lower prim index."""
    p = prim_verts[None]  # [1,Q,4,3]
    h, u, v, t = intersect_quad(
        ro[:, None], rd[:, None], tmin[:, None], tmax[:, None],
        p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :],
    )
    t = torch.where(h, t, F32_MAX)
    best = torch.argmin(t, dim=1, keepdim=True)  # first minimum
    hit = h.gather(1, best)[:, 0]
    prim = best[:, 0].to(torch.int32)
    bu = u.gather(1, best)[:, 0]
    bv = v.gather(1, best)[:, 0]
    bt = t.gather(1, best)[:, 0]
    pos, gn = hit_surface(prim_verts, prim, bu, bv)
    inst = (
        prim_instance[prim] if prim_instance is not None
        else torch.zeros_like(prim)
    )
    return Hit(hit, prim, bu, bv, bt, pos, gn, inst)
