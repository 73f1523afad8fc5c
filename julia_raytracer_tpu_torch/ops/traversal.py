"""Closest-hit record, the route type every intersector is built as, and
the dense reference intersector (port of the `Hit`, `hit_surface` and
`intersect_bruteforce` parts of julia_raytracer_tpu/ops/traversal.py).

`intersect_bruteforce` is the reference the dense kernel
(ops/dense_intersect.py) is held against. On a miss it returns prim 0
and t = F32_MAX, as the JAX function does; the kernel returns prim -1
and t = tmax. Parity tests compare hit lanes only. `intersect_bvh` is
the JAX package's lock-step walk of the packed BVH, a plain reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, interpolate_quad, intersect_bbox, intersect_quad, quad_normal,
)

STACK_DEPTH = 48
LEAF_UNROLL = 4  # the builder's leaf size


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


@dataclasses.dataclass(frozen=True, eq=False)
class Intersector:
    """A scene's closest-hit route, built once (render/integrator.py
    build_intersector), whose fields the wavefront loop, its CUDA graphs,
    the renderer and the train step read: `hit(ro, rd, tmin, tmax) -> Hit`
    (also `self(...)`) for bounce rays; `primary` for camera rays and the
    light pdf's march, `hit` unless the route has a coherent-ray kernel
    (regroup's worklist over the same tables); `graph_safe`: no query
    reads the device back or sizes an allocation on the host, so a CUDA
    graph can capture them (render/body_graphs.py); `diff(dscene)`: the
    fixed-trip loop's Intersector, whose hits carry gradients to the
    call's scene (None: a flat route's, make_diff_intersect over
    dscene.prim_verts); `tables`, a diagnostic only tests and chip_smoke.py
    read: the route's kernel tables, the hybrid's (soup's, work items');
    `livegate`, regroup's liveness gate; `curves`, the culled curve walk's
    tables (ops/curve_intersect.py CurveTables) where the route merges
    lines and points through it (render/integrator.py curve_wrap), else
    None."""

    hit: Callable[..., Hit]
    primary: Callable[..., Hit] | None = None
    graph_safe: bool = False
    diff: Callable[[Any], Intersector] | None = None
    tables: Any = None
    livegate: float | None = None
    curves: Any = None

    def __post_init__(self):
        if self.primary is None:
            object.__setattr__(self, "primary", self.hit)

    def __call__(self, ro, rd, tmin, tmax) -> Hit:
        return self.hit(ro, rd, tmin, tmax)

    def each(self, wrap) -> tuple:
        """(wrap(hit), wrap(primary)); primary is wrapped apart only where
        it is not hit."""
        hit = wrap(self.hit)
        return hit, hit if self.primary is self.hit else wrap(self.primary)

    def differentiable(self, dscene) -> Intersector:
        """The fixed-trip loop's form of this route against `dscene`."""
        if self.diff is not None:
            return self.diff(dscene)
        # ops/diff_hit.py imports this module
        from julia_raytracer_tpu_torch.ops.diff_hit import make_diff_intersect

        return Intersector(*self.each(
            lambda f: make_diff_intersect(f, dscene.prim_verts)))


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


def intersect_bvh(nodes, prim_verts, ro, rd, tmin, tmax, find_any: bool = False,
                  prim_instance=None) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] by a walk of the
    packed BVH `nodes` [Nn, 16] (ops/bvh.py) over `prim_verts` [Q, 4, 3]
    in leaf order. `find_any`: a lane stops at its first recorded hit
    (which need not be the closest). A miss gives prim -1 and t = tmax."""
    n, dev = ro.shape[0], ro.device
    q = prim_verts.shape[0]
    rdinv = 1.0 / rd
    child_ids = nodes[:, 12:14].contiguous().view(torch.int32)
    rows = torch.arange(n, device=dev)

    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int32, device=dev)
    current = torch.zeros(n, dtype=torch.int32, device=dev)  # the root
    active = torch.ones(n, dtype=torch.bool, device=dev)
    best_t = tmax
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)

    while bool(active.any()):
        is_internal = current >= 0
        node_idx = torch.where(is_internal, current, 0).long()
        row = nodes[node_idx]  # [N, 16]: one row a lane a step
        child = child_ids[node_idx]
        hit_l, t_l = intersect_bbox(ro, rdinv, tmin, best_t, row[:, 0:3],
                                    row[:, 3:6])
        hit_r, t_r = intersect_bbox(ro, rdinv, tmin, best_t, row[:, 6:9],
                                    row[:, 9:12])
        near_is_l = torch.where(hit_l & hit_r, t_l <= t_r, hit_l)
        near = torch.where(near_is_l, child[:, 0], child[:, 1])
        far = torch.where(near_is_l, child[:, 1], child[:, 0])
        both = hit_l & hit_r
        any_child = hit_l | hit_r

        # a leaf is encoded -(start * 8 + count) - 1
        is_leaf = active & (current < 0)
        leaf_val = -(current + 1)
        start = torch.div(leaf_val, 8, rounding_mode="floor")
        count = leaf_val % 8
        for k in range(LEAF_UNROLL):
            pidx = (start + k).clamp(0, q - 1)
            pv = prim_verts[pidx.long()]
            h, u, v, t = intersect_quad(ro, rd, tmin, best_t, pv[:, 0],
                                        pv[:, 1], pv[:, 2], pv[:, 3])
            h = h & is_leaf & (k < count)
            best_t = torch.where(h, t, best_t)
            best_prim = torch.where(h, pidx, best_prim)
            best_u = torch.where(h, u, best_u)
            best_v = torch.where(h, v, best_v)

        # internal node: descend to the near child, push the far one
        do_push = active & is_internal & both & (sp < STACK_DEPTH)
        col = sp.clamp(max=STACK_DEPTH - 1).long()
        stack[rows, col] = torch.where(do_push, far, stack[rows, col])
        sp = torch.where(do_push, sp + 1, sp)
        descend = active & is_internal & any_child
        next_current = torch.where(descend, near, current)

        # pop for lanes at a leaf or at an internal node whose children
        # both missed
        need_pop = active & (is_leaf | (is_internal & ~any_child))
        if find_any:
            need_pop = need_pop & (best_prim < 0)
            active = active & ((best_prim < 0) | ~is_leaf)
        can_pop = need_pop & (sp > 0)
        sp_pop = (sp - 1).clamp(min=0)
        popped = stack[rows, sp_pop.long()]
        current = torch.where(can_pop, popped, next_current)
        sp = torch.where(can_pop, sp_pop, sp)
        active = active & ~(need_pop & (sp == 0) & ~can_pop)

    hit = best_prim >= 0
    safe_prim = best_prim.clamp(min=0)
    pos, gn = hit_surface(prim_verts, safe_prim, best_u, best_v)
    inst = (prim_instance[safe_prim.long()] if prim_instance is not None
            else torch.zeros_like(best_prim))
    return Hit(hit, best_prim, best_u, best_v, torch.where(hit, best_t, tmax),
               pos, gn, inst)
