"""Two-level instanced scene build (host side, numpy), port of
julia_raytracer_tpu/scene/instanced.py.

The reference keeps a scene BVH over instances and per-shape BVHs and
moves each ray into shape space at instance leaves. Flattening erases
that sharing: a forest of 12,755 instances over 141 shapes grows from
620k shape primitives to 16.8M world primitives. The two-level build
keeps each shape's cluster tables once, in shape space, and models
instancing as work items: one (instance, shape-supercluster) pair per
item, with a world-space box for culling. The work-item intersector
(ops/instanced_intersect.py) moves each ray into shape space per item
(t is preserved because directions are not renormalised:
M(o + t d) = Mo + t Md) and keeps the closest hit. The eval-side prim
arrays hold the shape-space primitives in the same (morton-ordered,
cluster-padded) layout the intersector's prim ids index.

The hybrid build (`select_flatten_shapes`, `build_world_flat`) expands
the instances of small, many-instance shapes into one world-space soup
for the flat intersectors and keeps the big shapes as work items.

The world expansion takes the C++/OpenMP pass of ops/native.py
(world_expand_permute) first, its numpy path (an einsum, the same
products summed in another order) when that is not in use. One
difference: the work items' world boxes are computed from the rotated
supercluster corners in float64 and rounded outward to float32 (the JAX
package computes them in float32, rounded to nearest), so each box holds
its supercluster's box; the work-item intersector tests each ray against
them, not only each group of rays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from julia_raytracer_tpu_torch.ops import native
from julia_raytracer_tpu_torch.ops.bvh import _morton3
from julia_raytracer_tpu_torch.ops.cluster_tables import (
    NOHIT, PRIMS_PER_CLUSTER, TRIS, build_cluster_tables,
)
from julia_raytracer_tpu_torch.scene.flatten import FlatScene
from julia_raytracer_tpu_torch.scene.types import INVALID_ID


@dataclass
class InstancedTables:
    """Host-side products of the instanced build (numpy; the intersector
    factory uploads them)."""

    sup: int  # clusters per supercluster (work-item granularity)
    # concatenated per-shape cluster tables (shape space)
    tab: np.ndarray  # f32 [total_sup, sup, 16, TRIS] transforms+normals
    bbox: np.ndarray  # f32 [total_sup, sup, 8] cluster boxes
    # work items (one per live (instance, supercluster) pair)
    wi_sup: np.ndarray  # i32 [Nis] global supercluster id
    wi_inst: np.ndarray  # i32 [Nis] instance id
    wi_bbox: np.ndarray  # f32 [Nis, 6] world box, rounded outward
    # per-instance transform rows:
    # [0:9] inverse rotation Ri (row-major; obj = world @ Ri + oi)
    # [9:12] oi, [12:21] forward rotation R (normals: n_w = n_s @ R)
    inst_rows: np.ndarray  # f32 [I, 24]
    # eval-side layout
    n_prims: int  # padded concat prim count (intersector prim-id space)
    shape_sup_offset: np.ndarray  # i64 [S+1]


def _shape_morton_order(verts: np.ndarray) -> np.ndarray:
    """Within-shape Morton order of prim centroids (cluster coherence)."""
    if len(verts) <= 1:
        return np.arange(len(verts), dtype=np.int64)
    cen = verts.mean(axis=1)
    lo = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo, 1e-30)
    qv = np.clip(((cen - lo) / ext) * ((1 << 21) - 1), 0, (1 << 21) - 1)
    return np.argsort(_morton3(qv.astype(np.uint64)), kind="stable")


def _f32_outward(x: np.ndarray, up: bool) -> np.ndarray:
    """float64 -> the nearest float32 at or above x (up) or at or below
    it."""
    f = x.astype(np.float32)
    if up:
        return np.where(f < x, np.nextafter(f, np.float32(np.inf)), f)
    return np.where(f > x, np.nextafter(f, np.float32(-np.inf)), f)


def _valid_instances(flat: FlatScene) -> tuple[np.ndarray, np.ndarray]:
    """(inst_shape [I], valid [I]): instances that reference a shape."""
    g = flat.geometry
    i_count, s_count = flat.n_instances, flat.n_shapes
    inst_shape = g.inst_shape[:i_count] if i_count else np.zeros(0, np.int32)
    valid = ((inst_shape != INVALID_ID) & (inst_shape >= 0)
             & (inst_shape < s_count))
    return inst_shape, valid


def build_instanced_tables(scene, flat: FlatScene, sup: int = 32,
                           instance_mask=None) -> tuple[InstancedTables, dict]:
    """Instanced cluster tables + work items from a non-expanded flatten
    (flatten_scene(expand_prims=False)).

    Returns (tables, eval_arrays): eval_arrays holds the morton-ordered,
    cluster-padded shape-space prim arrays (prim_verts/prim_vidx/
    prim_flags) the intersector's prim ids index. `instance_mask` (bool
    [n_instances], optional) restricts the work items to the masked
    instances (the hybrid build flattens the rest); tables and eval
    arrays still cover every shape, so every prim id stays resolvable."""
    del scene  # the flatten carries everything the build reads
    g = flat.geometry
    off = g.shape_prim_offset
    if off is None:
        raise ValueError("need flatten_scene(expand_prims=False)")
    s_count, i_count = flat.n_shapes, flat.n_instances

    tab_parts, bbox_parts = [], []
    pv_parts, pvi_parts, pfl_parts = [], [], []
    shape_sup_offset = np.zeros(s_count + 1, np.int64)
    # per-shape supercluster boxes in shape space (for the work items)
    shape_sup_bbox: list[np.ndarray] = []
    prim_base = 0

    for sid in range(s_count):
        lo, hi = int(off[sid]), int(off[sid + 1])
        p = hi - lo
        if p == 0:
            shape_sup_offset[sid + 1] = shape_sup_offset[sid]
            shape_sup_bbox.append(np.zeros((0, 6), np.float32))
            continue
        order = _shape_morton_order(g.prim_verts[lo:hi])
        verts = g.prim_verts[lo:hi][order]
        tfm, nrm, cbbox, c = build_cluster_tables(np.asarray(verts, np.float64))
        c_pad = -(-c // sup) * sup
        if c_pad > c:
            pt = np.zeros((c_pad - c, 12, TRIS), np.float32)
            pt[:, 11, :] = 1.0  # never-hit transforms
            tfm = np.concatenate([tfm, pt], axis=0)
            nrm = np.concatenate(
                [nrm, np.zeros((c_pad - c, 4, TRIS), np.float32)], axis=0
            )
            pb = np.zeros((c_pad - c, 8), np.float32)
            pb[:, 0:6] = NOHIT
            cbbox = np.concatenate([cbbox, pb], axis=0)
        ns = c_pad // sup
        tab_parts.append(
            np.concatenate([tfm, nrm], axis=1).reshape(ns, sup, 16, TRIS)
        )
        bbox_parts.append(cbbox.reshape(ns, sup, 8))
        # supercluster shape-space box (never-hit padding excluded)
        cb = cbbox.reshape(ns, sup, 8)
        real = cb[:, :, 0] < NOHIT  # [ns, sup]
        blo = np.where(real[..., None], cb[:, :, 0:3], np.inf).min(axis=1)
        bhi = np.where(real[..., None], cb[:, :, 3:6], -np.inf).max(axis=1)
        shape_sup_bbox.append(
            np.concatenate([blo, bhi], axis=1).astype(np.float32)
        )
        shape_sup_offset[sid + 1] = shape_sup_offset[sid] + ns

        # eval arrays in intersector prim-id order (padded to c_pad * 64)
        p_pad = c_pad * PRIMS_PER_CLUSTER
        pv = np.zeros((p_pad, 4, 3), np.float32)
        pv[:p] = verts
        pvi = np.zeros((p_pad, 4), np.int32)
        pvi[:p] = g.prim_vidx[lo:hi][order]
        pfl = np.zeros(p_pad, np.int32)
        pfl[:p] = g.prim_flags[lo:hi][order]
        pv_parts.append(pv)
        pvi_parts.append(pvi)
        pfl_parts.append(pfl)
        prim_base += p_pad

    def cat(parts, empty_shape, dtype=np.float32):
        return (np.concatenate(parts, axis=0) if parts
                else np.zeros(empty_shape, dtype))

    # per-instance transform rows (inverse for rays, forward rotation for
    # normals: the reference's rigid transform_normal)
    inst_rows = np.zeros((max(i_count, 1), 24), np.float32)
    for i in range(i_count):
        rot = g.inst_frame[i, :3].astype(np.float64)  # world = obj @ rot + org
        org = g.inst_frame[i, 3].astype(np.float64)
        ri = np.linalg.inv(rot)
        inst_rows[i, 0:9] = ri.reshape(-1)
        inst_rows[i, 9:12] = -(org @ ri)
        inst_rows[i, 12:21] = rot.reshape(-1)

    # work items: vectorised per shape over its instances
    inst_shape, valid = _valid_instances(flat)
    if instance_mask is not None:
        valid = valid & np.asarray(instance_mask, bool)[:i_count]
    wi_sup_l, wi_inst_l, wi_bbox_l = [], [], []
    for sid in range(s_count):
        ns = int(shape_sup_offset[sid + 1] - shape_sup_offset[sid])
        if ns == 0:
            continue
        members = np.nonzero(valid & (inst_shape == sid))[0]
        if len(members) == 0:
            continue
        sb = shape_sup_bbox[sid]  # [ns, 6]
        # the 8 corners of each supercluster box
        corners = np.stack(
            [
                sb[:, [0, 1, 2]], sb[:, [3, 1, 2]], sb[:, [0, 4, 2]],
                sb[:, [0, 1, 5]], sb[:, [3, 4, 2]], sb[:, [3, 1, 5]],
                sb[:, [0, 4, 5]], sb[:, [3, 4, 5]],
            ],
            axis=1,
        )  # [ns, 8, 3]
        rots = g.inst_frame[members, :3].astype(np.float64)  # [m, 3, 3]
        orgs = g.inst_frame[members, 3].astype(np.float64)  # [m, 3]
        wc = (np.einsum("nkj,mji->mnki", corners.astype(np.float64), rots)
              + orgs[:, None, None, :])
        blo = _f32_outward(wc.min(axis=2), up=False)  # [m, ns, 3]
        bhi = _f32_outward(wc.max(axis=2), up=True)
        m = len(members)
        wi_sup_l.append(np.tile(
            np.arange(ns, dtype=np.int32) + np.int32(shape_sup_offset[sid]), m))
        wi_inst_l.append(np.repeat(members.astype(np.int32), ns))
        wi_bbox_l.append(np.concatenate([blo, bhi], axis=-1)
                         .reshape(m * ns, 6).astype(np.float32))

    tables = InstancedTables(
        sup=sup,
        tab=cat(tab_parts, (0, sup, 16, TRIS)),
        bbox=cat(bbox_parts, (0, sup, 8)),
        wi_sup=cat(wi_sup_l, (0,), np.int32),
        wi_inst=cat(wi_inst_l, (0,), np.int32),
        wi_bbox=cat(wi_bbox_l, (0, 6)),
        inst_rows=inst_rows,
        n_prims=prim_base,
        shape_sup_offset=shape_sup_offset,
    )
    eval_arrays = dict(
        prim_verts=cat(pv_parts, (0, 4, 3)),
        prim_vidx=cat(pvi_parts, (0, 4), np.int32),
        prim_flags=cat(pfl_parts, (0,), np.int32),
    )
    return tables, eval_arrays


def expand_emissive_world_prims(scene, flat: FlatScene):
    """World-space expansion of only the emissive instances' primitives:
    the light-table input of instanced scenes (lights are always few).
    Returns (prim_verts [E, 4, 3], prim_instance [E], prim_flags [E])."""
    del scene
    g = flat.geometry
    m = flat.materials
    off = g.shape_prim_offset
    emissive_mat = (
        (np.abs(m.emission).sum(axis=1) > 0) if len(m.emission)
        else np.zeros(0, bool)
    )
    pv, pin, pfl = [], [], []
    for i in range(flat.n_instances):
        mat = g.inst_material[i]
        sid = g.inst_shape[i]
        if mat < 0 or mat >= len(emissive_mat) or not emissive_mat[mat]:
            continue
        if sid == INVALID_ID or sid < 0 or sid >= flat.n_shapes:
            continue
        lo, hi = int(off[sid]), int(off[sid + 1])
        if hi == lo:
            continue
        rot, org = g.inst_frame[i, :3], g.inst_frame[i, 3]
        world = g.prim_verts[lo:hi] @ rot + org
        pv.append(world.astype(np.float32))
        pin.append(np.full(hi - lo, i, np.int32))
        pfl.append(g.prim_flags[lo:hi])
    if pv:
        return np.concatenate(pv, axis=0), np.concatenate(pin), np.concatenate(pfl)
    return (np.zeros((0, 4, 3), np.float32), np.zeros(0, np.int32),
            np.zeros(0, np.int32))


def select_flatten_shapes(flat: FlatScene, budget: int) -> np.ndarray:
    """Shapes whose instances the hybrid build flattens to world space:
    smallest shapes first (the many-instance canopy that floods the
    work-item model with (instance, supercluster) pairs) until the
    flattened world-prim budget is spent. Returns bool [S]. Big shapes
    stay instanced: flattening them is what two-level instancing avoids."""
    off = flat.geometry.shape_prim_offset
    s_count = flat.n_shapes
    pp = np.diff(off).astype(np.int64)
    inst_shape, valid = _valid_instances(flat)
    cnt = np.bincount(inst_shape[valid], minlength=s_count)
    world = pp * cnt
    mask = np.zeros(s_count, bool)
    spent = 0
    for sid in np.argsort(pp, kind="stable"):
        if cnt[sid] == 0 or pp[sid] == 0:
            continue
        if spent + world[sid] > budget:
            # later shapes are bigger per prim but may have few
            # instances: keep scanning for ones that still fit
            continue
        mask[sid] = True
        spent += int(world[sid])
    return mask


def _spread10(x):
    x = (x | (x << 16)) & np.uint32(0x30000FF)
    x = (x | (x << 8)) & np.uint32(0x300F00F)
    x = (x | (x << 4)) & np.uint32(0x30C30C3)
    return (x | (x << 2)) & np.uint32(0x9249249)


def build_world_flat(flat: FlatScene, shape_mask: np.ndarray, sup: int = 32):
    """World-expand every instance of the masked shapes into one
    morton-ordered prim soup for the flat intersectors.

    Returns (world_pv f32 [Pf, 4, 3], world_inst i32 [Pf], remap i32
    [Pf]): remap[k] is the instanced eval-layout prim id (base + position
    in the shape's morton order, as build_instanced_tables lays them
    out), so the hybrid intersector maps flat hits back into the shared
    shape-space eval tables with one gather."""
    g = flat.geometry
    off = g.shape_prim_offset
    s_count = flat.n_shapes
    inst_shape, _ = _valid_instances(flat)

    # eval prim-id bases: build_instanced_tables' padding walk
    eval_base = np.zeros(s_count + 1, np.int64)
    for sid in range(s_count):
        p = int(off[sid + 1] - off[sid])
        if p == 0:
            eval_base[sid + 1] = eval_base[sid]
            continue
        c = max(1, -(-p // PRIMS_PER_CLUSTER))
        c_pad = -(-c // sup) * sup
        eval_base[sid + 1] = eval_base[sid] + c_pad * PRIMS_PER_CLUSTER

    # pass 1: per world prim, the (shape-prim row, instance, eval id)
    # triple and a world centroid, from the per-shape centroids
    pr_l, in_l, rm_l, cen_l = [], [], [], []
    for sid in np.nonzero(shape_mask)[0]:
        lo, hi = int(off[sid]), int(off[sid + 1])
        p = hi - lo
        if p == 0:
            continue
        members = np.nonzero((inst_shape == sid) & (inst_shape != INVALID_ID))[0]
        if len(members) == 0:
            continue
        order = _shape_morton_order(g.prim_verts[lo:hi])
        inv_order = np.empty(p, np.int64)
        inv_order[order] = np.arange(p)
        eval_ids = (eval_base[sid] + inv_order).astype(np.int32)
        m = len(members)
        cen_s = g.prim_verts[lo:hi].mean(axis=1).astype(np.float32)  # [p, 3]
        rots = g.inst_frame[members, :3]  # [m, 3, 3]
        orgs = g.inst_frame[members, 3]  # [m, 3]
        cen_w = (cen_s[None] @ rots) + orgs[:, None, :]  # [m, p, 3]
        pr_l.append(np.tile(np.arange(lo, hi, dtype=np.int32), m))
        in_l.append(np.repeat(members.astype(np.int32), p))
        rm_l.append(np.tile(eval_ids, m))
        cen_l.append(cen_w.reshape(-1, 3))

    if not pr_l:
        return (np.zeros((0, 4, 3), np.float32), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    src_prim = np.concatenate(pr_l)
    src_inst = np.concatenate(in_l)
    remap = np.concatenate(rm_l)
    cen = np.concatenate(cen_l, axis=0)

    # global morton order over world centroids (10 bits per axis)
    lo3 = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - lo3, 1e-30)
    qv = np.clip(((cen - lo3) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    key = (_spread10(qv[:, 0]) | (_spread10(qv[:, 1]) << np.uint32(1))
           | (_spread10(qv[:, 2]) << np.uint32(2)))
    gorder = np.argsort(key)
    src_prim = np.ascontiguousarray(src_prim[gorder])
    src_inst = np.ascontiguousarray(src_inst[gorder])
    remap = remap[gorder]

    # pass 2: expand into the permuted order (native: one streaming pass,
    # no [Pf, 4, 3] intermediates)
    sv = np.ascontiguousarray(g.prim_verts, np.float32)
    fr = np.ascontiguousarray(g.inst_frame, np.float32)
    world_pv = np.empty((len(src_prim), 4, 3), np.float32)
    if not native.world_expand_permute_native(sv, fr, src_prim, src_inst,
                                              world_pv):
        np.einsum("nkj,nji->nki", sv[src_prim], fr[src_inst, :3],
                  out=world_pv, casting="unsafe")
        world_pv += fr[src_inst, 3][:, None, :]
    return world_pv, src_inst, remap
