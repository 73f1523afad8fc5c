"""Differentiable closest hit around a flat intersector (the fixed-trip,
differentiable loop's intersector).

The intersect kernels (ops/dense_intersect.py, ops/worklist_intersect.py,
ops/regroup_intersect.py) take no autograd: they read host-built tables
and return plain tensors. The JAX package differentiates its CPU
intersectors directly (`intersect_bruteforce`, `intersect_bvh`): the
argmin-selected quad's u, v, t carry a gradient to its corners and to the
ray, and `hit_surface` carries it on to the hit position and the element
normal. No kernel has a backward pass there either.

`make_diff_intersect` gives the same gradient without one:
  - the wrapped intersector runs on detached rays (the kernel on the card,
    its plain version on the CPU), and its prim and hit are taken as they
    are;
  - for hit lanes, the chosen quad is re-tested in PyTorch on
    prim_verts[prim] and the differentiable rays: one quad per lane, the
    triangle the kernel took (u + v <= 1: the first, (p1, p2, p4); else
    the second, (p3, p4, p2), with its uv flipped, as intersect_quad
    reports it);
  - u, v, t, the position and the element normal return the kernel's
    values in the forward pass and the re-test's gradient (through
    ops/traversal.hit_surface) in the backward pass (`straight_through`).
So the forward is bit-equal to the non-differentiable render, and the
backward is the gradient of the JAX package's argmin-selected hit.

`make_diff_intersect_instanced` does the same around a work-item
intersector (ops/instanced_intersect.py: the cull and the work-item
kernel on the card), whose prim ids index shape-space quads: each hit
lane's differentiable ray moves into its instance's shape space
(`_to_shape_space` on the hit instance's row, the kernel's arithmetic),
the taken triangle is re-tested there, and the hit returns what the JAX
package's make_intersect_instanced_ref returns: t (the same in both
spaces, the shape-space direction is not normalised), the world
position ro + rd t, and the world element normal
normalize(quad_normal(verts) Fw); `instanced_diff` is a work-item
route's `Intersector.diff`. A hybrid scene's soup branch takes
make_diff_intersect over the world-space soup (render/integrator.py
make_intersect_hybrid wraps the two branches before it composes them)."""

from __future__ import annotations

import torch

from julia_raytracer_tpu_torch.ops.geometry import intersect_triangle, quad_normal
from julia_raytracer_tpu_torch.ops.instanced_intersect import _to_shape_space
from julia_raytracer_tpu_torch.ops.traversal import Intersector, hit_surface


# the miss lanes' re-test: a ray straight down onto the unit quad
_UNIT_QUAD = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 0.0))
_UNIT_RO = (0.25, 0.25, 1.0)
_UNIT_RD = (0.0, 0.0, -1.0)


class _KernelValue(torch.autograd.Function):
    """Forward: the kernel's value. Backward: the gradient goes to the
    re-test's value, none to the kernel's."""

    @staticmethod
    def forward(ctx, kernel, retest):
        return kernel.clone()

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def straight_through(kernel, retest):
    """`kernel` bit for bit in the forward pass, d/d`retest` backward."""
    return _KernelValue.apply(kernel, retest)


def retest_quad(verts, ro, rd, tmin, tmax, lower):
    """u, v, t of rays ro/rd [N, 3] on their quads verts [N, 4, 3], on the
    triangle `lower` [N] names (True: (p1, p2, p4); False: (p3, p4, p2),
    uv flipped), whether or not the re-test itself hits."""
    p1, p2, p3, p4 = verts.unbind(-2)
    _, u1, v1, t1 = intersect_triangle(ro, rd, tmin, tmax, p1, p2, p4)
    _, u2, v2, t2 = intersect_triangle(ro, rd, tmin, tmax, p3, p4, p2)
    return (torch.where(lower, u1, 1.0 - u2), torch.where(lower, v1, 1.0 - v2),
            torch.where(lower, t1, t2))


def _unit_case(device):
    return (torch.tensor(x, device=device)
            for x in (_UNIT_QUAD, _UNIT_RO, _UNIT_RD))


def _wants_grad(ro, rd, prim_verts) -> bool:
    return torch.is_grad_enabled() and (
        ro.requires_grad or rd.requires_grad or prim_verts.requires_grad)


def make_diff_intersect(intersect, prim_verts):
    """intersect(ro, rd, tmin, tmax) -> Hit of `intersect` (a flat
    intersector over the quads `prim_verts` [Q, 4, 3]) whose u, v, t,
    position and gnormal carry gradients to `prim_verts` and to ro/rd on
    hit lanes. Without a gradient to carry (grad mode off, or neither the
    rays nor prim_verts require one) it returns the wrapped Hit."""
    unit_quad, unit_ro, unit_rd = _unit_case(prim_verts.device)

    def diff_intersect(ro, rd, tmin, tmax):
        h = intersect(ro.detach(), rd.detach(), tmin, tmax)
        if not _wants_grad(ro, rd, prim_verts):
            return h
        prim = h.prim.clamp(0, prim_verts.shape[0] - 1)
        hit, hit3 = h.hit, h.hit[:, None]
        # miss lanes keep the kernel's values and take no gradient; they
        # re-test a fixed ray on a unit quad, whose derivatives are finite
        # (0 x inf would turn a masked lane's zero gradient into NaN)
        verts = torch.where(hit[:, None, None], prim_verts[prim], unit_quad)
        u, v, t = retest_quad(verts, torch.where(hit3, ro, unit_ro),
                              torch.where(hit3, rd, unit_rd), tmin, tmax,
                              h.u + h.v <= 1.0)
        u = straight_through(h.u, torch.where(hit, u, 0.0))
        v = straight_through(h.v, torch.where(hit, v, 0.0))
        t = straight_through(h.t, torch.where(hit, t, 0.0))
        position, gnormal = hit_surface(prim_verts, prim, u, v)
        return h._replace(
            u=u, v=v, t=t,
            position=straight_through(h.position,
                                      torch.where(hit3, position, 0.0)),
            gnormal=straight_through(h.gnormal,
                                     torch.where(hit3, gnormal, 0.0)),
        )

    return diff_intersect


def make_diff_intersect_instanced(intersect, prim_verts, inst_rows):
    """intersect(ro, rd, tmin, tmax) -> Hit of `intersect` (a work-item
    intersector over the shape-space quads `prim_verts` [Q, 4, 3] and the
    instance rows `inst_rows` [I, 24]: shape from world Ri (0:9), oi
    (9:12), the normal's Fw (12:21)) whose u, v, t, position and gnormal
    carry gradients to `prim_verts` and to ro/rd on hit lanes; no
    gradient reaches `inst_rows`. Without a gradient to carry it returns
    the wrapped Hit."""
    unit_quad, unit_ro, unit_rd = _unit_case(prim_verts.device)

    def diff_intersect(ro, rd, tmin, tmax):
        h = intersect(ro.detach(), rd.detach(), tmin.detach(), tmax.detach())
        if not _wants_grad(ro, rd, prim_verts):
            return h
        prim = h.prim.clamp(0, prim_verts.shape[0] - 1)
        hit, hit3 = h.hit, h.hit[:, None]
        xf = inst_rows[h.instance.clamp(0, inst_rows.shape[0] - 1).long()]
        # miss lanes move and re-test the fixed unit case (finite
        # derivatives under their zero gradient, as in make_diff_intersect)
        ro_w = torch.where(hit3, ro, unit_ro)
        rd_w = torch.where(hit3, rd, unit_rd)
        so, sd = _to_shape_space(ro_w, rd_w, xf)
        verts = torch.where(hit[:, None, None], prim_verts[prim], unit_quad)
        u, v, t = retest_quad(verts, torch.where(hit3, so, unit_ro),
                              torch.where(hit3, sd, unit_rd), tmin, tmax,
                              h.u + h.v <= 1.0)
        t = torch.where(hit, t, 0.0)
        gn = (quad_normal(*verts.unbind(-2))[:, None]
              @ xf[:, 12:21].reshape(-1, 3, 3))[:, 0]
        gl = torch.sqrt((gn * gn).sum(dim=-1, keepdim=True))
        gn = gn / torch.where(gl > 0, gl, 1.0)
        return h._replace(
            u=straight_through(h.u, torch.where(hit, u, 0.0)),
            v=straight_through(h.v, torch.where(hit, v, 0.0)),
            t=straight_through(h.t, t),
            position=straight_through(
                h.position, torch.where(hit3, ro_w + rd_w * t[:, None], 0.0)),
            gnormal=straight_through(h.gnormal, torch.where(hit3, gn, 0.0)),
        )

    return diff_intersect


def instanced_diff(intersect, inst_rows):
    """The `Intersector.diff` of the work-item route `intersect` (one
    query for all rays): make_diff_intersect_instanced over the call's
    dscene.prim_verts."""
    return lambda dscene: Intersector(make_diff_intersect_instanced(
        intersect, dscene.prim_verts, inst_rows))
