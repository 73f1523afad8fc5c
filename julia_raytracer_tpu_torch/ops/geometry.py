"""Ray-primitive intersection + interpolation on batched tensors (port of
julia_raytracer_tpu/ops/geometry.py).

Semantics match the JAX module exactly: the slab-test robustness factor
`t1 *= 1.00000024` and the quad = two triangles (p1,p2,p4)+(p3,p4,p2)
with the second triangle's uv flipped. Everything is branchless and
batched over any leading ray axes.
"""

from __future__ import annotations

import torch

from julia_raytracer_tpu_torch.utils.vecmath import cross, dot, normalize

RAY_EPS = 1e-4
F32_MAX = 3.4028234663852886e38  # largest float32


def intersect_bbox(ro, rdinv, tmin, tmax, bb_min, bb_max):
    """Slab test. Returns (hit, t_enter)."""
    it_min = (bb_min - ro) * rdinv
    it_max = (bb_max - ro) * rdinv
    lo = torch.minimum(it_min, it_max)
    hi = torch.maximum(it_min, it_max)
    t0 = torch.maximum(lo.amax(dim=-1), tmin)
    t1 = torch.minimum(hi.amin(dim=-1), tmax) * 1.00000024
    return t0 <= t1, t0


def intersect_triangle(ro, rd, tmin, tmax, p1, p2, p3):
    """Moller-Trumbore -> (hit, u, v, t)."""
    edge1 = p2 - p1
    edge2 = p3 - p1
    pvec = cross(rd, edge2)
    det = dot(edge1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = ro - p1
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(rd, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    hit = (
        (det != 0.0)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin)
        & (t <= tmax)
    )
    return hit, u, v, t


def intersect_quad(ro, rd, tmin, tmax, p1, p2, p3, p4):
    """Quad as (p1,p2,p4)+(p3,p4,p2), second uv flipped. Degenerate quads
    (p3 == p4, embedded triangles) never hit the second triangle
    (det == 0). Returns (hit, u, v, t)."""
    h1, u1, v1, t1 = intersect_triangle(ro, rd, tmin, tmax, p1, p2, p4)
    h2, u2, v2, t2 = intersect_triangle(ro, rd, tmin, tmax, p3, p4, p2)
    t1 = torch.where(h1, t1, F32_MAX)
    t2 = torch.where(h2, t2, F32_MAX)
    first = t1 < t2
    hit = h1 | h2
    u = torch.where(first, u1, 1.0 - u2)
    v = torch.where(first, v1, 1.0 - v2)
    t = torch.where(first, t1, t2)
    return hit, u, v, t


def dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2: the order of the CPU's sum over the last
    axis, written out so that every device (and csrc/curve_intersect.cu)
    adds in it; a sum on the card may add in another."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def intersect_point(ro, rd, tmin, tmax, p, r):
    """Ray vs radius-point -> (hit, t)."""
    w = p - ro
    t = dot3(w, rd) / dot3(rd, rd)
    rp = ro + rd * t[..., None]
    prp = p - rp
    hit = (t >= tmin) & (t <= tmax) & (dot3(prp, prp) <= r * r)
    return hit, t


def intersect_line(ro, rd, tmin, tmax, p1, p2, r1, r2):
    """Ray vs line segment with radius -> (hit, u, v, t)."""
    u_ = rd
    v_ = p2 - p1
    w_ = ro - p1
    a = dot3(u_, u_)
    b = dot3(u_, v_)
    c = dot3(v_, v_)
    d = dot3(u_, w_)
    e = dot3(v_, w_)
    det = a * c - b * b
    safe = torch.where(det == 0.0, 1.0, det)
    t = (b * e - c * d) / safe
    s = torch.clamp((a * e - b * d) / safe, 0.0, 1.0)
    pr = ro + rd * t[..., None]
    pl = p1 + (p2 - p1) * s[..., None]
    prl = pr - pl
    d2 = dot3(prl, prl)
    r = r1 * (1.0 - s) + r2 * s
    hit = (det != 0.0) & (t >= tmin) & (t <= tmax) & (d2 <= r * r)
    return hit, s, torch.sqrt(d2) / torch.where(r == 0, 1.0, r), t


def interpolate_triangle(p1, p2, p3, u, v):
    w = (1.0 - u - v)[..., None]
    return p1 * w + p2 * u[..., None] + p3 * v[..., None]


def interpolate_quad(p1, p2, p3, p4, u, v):
    """Quad interpolation via the two-triangle convention."""
    lower = u + v <= 1.0
    a = interpolate_triangle(p1, p2, p4, u, v)
    b = interpolate_triangle(p3, p4, p2, 1.0 - u, 1.0 - v)
    return torch.where(lower[..., None], a, b)


def triangle_normal(p1, p2, p3):
    return normalize(cross(p2 - p1, p3 - p1))


def triangle_area(p1, p2, p3):
    c = cross(p2 - p1, p3 - p1)
    return torch.sqrt(dot(c, c)) * 0.5


def quad_normal(p1, p2, p3, p4):
    """normalize(n(p1,p2,p4) + n(p3,p4,p2))."""
    return normalize(triangle_normal(p1, p2, p4) + triangle_normal(p3, p4, p2))


def quad_area(p1, p2, p3, p4):
    return triangle_area(p1, p2, p4) + triangle_area(p3, p4, p2)


def triangle_tangents_fromuv(p1, p2, p3, uv1, uv2, uv3):
    """UV-aligned tangent pair -> (tu, tv)."""
    p = p2 - p1
    q = p3 - p1
    s0 = uv2[..., 0] - uv1[..., 0]
    s1 = uv3[..., 0] - uv1[..., 0]
    t0 = uv2[..., 1] - uv1[..., 1]
    t1 = uv3[..., 1] - uv1[..., 1]
    div = s0 * t1 - s1 * t0
    safe = torch.where(div == 0.0, 1.0, div)[..., None]
    tu = (t1[..., None] * p - t0[..., None] * q) / safe
    tv = (s0[..., None] * q - s1[..., None] * p) / safe
    ok = (div != 0.0)[..., None]
    dflt_u = torch.tensor([1.0, 0.0, 0.0], device=tu.device).expand_as(tu)
    dflt_v = torch.tensor([0.0, 1.0, 0.0], device=tv.device).expand_as(tv)
    return torch.where(ok, tu, dflt_u), torch.where(ok, tv, dflt_v)
