"""Light table build (host numpy) + light sampling and pdf on tensors,
port of julia_raytracer_tpu/render/lights.py.

`build_lights_np` is the JAX package's numpy builder, carried over
because its module imports jax. Area-light pdfs take the exact sweep
over every emissive element (`area_lights_pdf_exact`), closed form and
free of whole-scene traversals, for scenes of up to EXACT_ELEMS emissive
elements. Above that the pdf is a truncated whole-scene march: the
bounce's own hit is step 1, and `extra_steps` more closest-hit queries
each continue 1e-3 past the last hit (`sample_lights_pdf`;
`auto_light_pdf_steps` picks the budget).

The env-texel -> direction mapping uses 0-based texel coordinates, and
the pdf uses the same mapping, as in the JAX module.

CDF layout: per-light element CDFs are raw float32 cumulative sums,
concatenated into one flat array per light kind with (offset, count)
per light.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, interpolate_quad, triangle_normal,
)
from julia_raytracer_tpu_torch.scene.flatten import (
    FLAG_IS_TRIANGLE_SHAPE, FlatScene,
)
from julia_raytracer_tpu_torch.utils import timing
from julia_raytracer_tpu_torch.utils.vecmath import (
    cross, dot, normalize, transform_direction, transform_normal,
)

PIF = math.pi

# total light-element count up to which area_light_hit_pdf finds a hit's
# owner by a compare-select over the element prim ids, not a gather
DENSE_ELEMS = 64

# emissive-element cap of the exact (sweep-all-elements) light pdf; above
# it the truncated whole-scene march takes over
EXACT_ELEMS = 4096
# elements per slab in the exact pdf (bounds the [lanes, slab] temps)
ELEM_PDF_CHUNK = 16


class DeviceLights(NamedTuple):
    """Light table tensors. Instance lights come first, then environment
    lights."""

    inst_cdf: torch.Tensor  # f32 [Ci] concatenated element-area cumsums
    inst_cdf_offset: torch.Tensor  # i32 [Li]
    inst_cdf_count: torch.Tensor  # i32 [Li]
    inst_prim: torch.Tensor  # i32 [Ci] sorted-prim index per element
    inst_area: torch.Tensor  # f32 [Li] total area (cdf last)
    env_id: torch.Tensor  # i32 [Le] environment index
    env_cdf: torch.Tensor  # f32 [Ce] concatenated texel cumsums
    env_cdf_offset: torch.Tensor  # i32 [Le]
    env_cdf_count: torch.Tensor  # i32 [Le] (0 = no emission texture)
    prim_light_area: torch.Tensor  # f32 [Q] owning light's area (0 = not a light)
    elem_verts: torch.Tensor  # f32 [Ci, 12] world corners of each light element
    elem_is_tri: torch.Tensor  # bool [Ci]
    elem_owner_area: torch.Tensor  # f32 [Ci] owning light's total area


@dataclass
class LightCounts:
    """Static light counts."""

    n_instance: int
    n_env: int
    max_inst_elems: int = 1  # largest per-light element count (search depth)
    max_env_texels: int = 1
    total_inst_elems: int = 0

    @property
    def total(self) -> int:
        return self.n_instance + self.n_env


def build_lights_np(flat: FlatScene, order: np.ndarray) -> tuple[dict, LightCounts]:
    """Build the light table from the flattened scene as host numpy arrays.
    `order` is the BVH primitive permutation; emitted prim indices refer
    to the *sorted* primitive arrays."""
    g = flat.geometry
    m = flat.materials
    q = len(order)
    sorted_instance = g.prim_instance[order] if q else g.prim_instance
    sorted_verts = g.prim_verts[order] if q else g.prim_verts

    # per-sorted-prim area (degenerate quads = triangles)
    if q:
        p1, p2, p3, p4 = (sorted_verts[:, i] for i in range(4))
        a1 = 0.5 * np.linalg.norm(np.cross(p2 - p1, p4 - p1), axis=-1)
        a2 = 0.5 * np.linalg.norm(np.cross(p4 - p3, p2 - p3), axis=-1)
        prim_area = (a1 + a2).astype(np.float32)
    else:
        prim_area = np.zeros(0, np.float32)

    emissive_mat = (
        (np.abs(m.emission).sum(axis=1) > 0) if len(m.emission)
        else np.zeros(0, bool)
    )

    inst_cdf_parts, inst_prim_parts = [], []
    inst_offsets, inst_counts, inst_areas = [], [], []
    prim_light_area = np.zeros(max(q, 1), np.float32)
    offset = 0
    for i in range(flat.n_instances):
        mat = g.inst_material[i]
        if mat < 0 or not emissive_mat[mat]:
            continue
        prim_idx = np.nonzero(sorted_instance == i)[0]
        if len(prim_idx) == 0:
            continue  # shape without faces
        cdf = np.cumsum(prim_area[prim_idx], dtype=np.float32)
        total = float(cdf[-1])
        inst_cdf_parts.append(cdf)
        inst_prim_parts.append(prim_idx.astype(np.int32))
        inst_offsets.append(offset)
        inst_counts.append(len(prim_idx))
        inst_areas.append(total)
        prim_light_area[prim_idx] = total
        offset += len(prim_idx)

    env_ids, env_offsets, env_counts, env_cdf_parts = [], [], [], []
    eoffset = 0
    env_emission = flat.environments.emission
    for e in range(len(env_emission)):
        if np.abs(env_emission[e]).sum() == 0:
            continue
        tex_id = int(flat.environments.emission_tex[e])
        env_ids.append(e)
        env_offsets.append(eoffset)
        if tex_id < 0:
            env_counts.append(0)
            continue
        w = int(flat.textures.width[tex_id])
        h = int(flat.textures.height[tex_id])
        toff = int(flat.textures.offset[tex_id])
        pix = flat.textures.data[toff: toff + w * h]  # raw values
        j = np.arange(w * h) // w
        th = (j + 0.5).astype(np.float32) * np.float32(np.pi) / h
        # max over all 4 channels, alpha included, as the reference does;
        # any positive weight is valid while the pdf uses the same CDF
        weights = pix.max(axis=1) * np.sin(th)
        env_cdf_parts.append(np.cumsum(weights, dtype=np.float32))
        env_counts.append(w * h)
        eoffset += w * h

    # dense per-element tables (sorted-prim data, element order == cdf order)
    all_prim_idx = (
        np.concatenate(inst_prim_parts) if inst_prim_parts
        else np.zeros(0, np.int64)
    ).astype(np.int64)
    total_elems = len(all_prim_idx)
    e_cap = max(total_elems, 1)
    elem_verts_np = np.zeros((e_cap, 12), np.float32)
    elem_is_tri_np = np.zeros(e_cap, bool)
    elem_owner_area_np = np.zeros(e_cap, np.float32)
    if total_elems:
        elem_verts_np[:total_elems] = sorted_verts[all_prim_idx].reshape(-1, 12)
        sorted_flags = g.prim_flags[order] if q else g.prim_flags
        elem_is_tri_np[:total_elems] = (
            sorted_flags[all_prim_idx] & FLAG_IS_TRIANGLE_SHAPE
        ) != 0
        elem_owner_area_np[:total_elems] = prim_light_area[all_prim_idx]

    lights = dict(
        inst_cdf=(
            np.concatenate(inst_cdf_parts) if inst_cdf_parts
            else np.zeros(1, np.float32)
        ),
        inst_cdf_offset=np.array(inst_offsets or [0], np.int32),
        inst_cdf_count=np.array(inst_counts or [0], np.int32),
        inst_prim=(
            np.concatenate(inst_prim_parts) if inst_prim_parts
            else np.zeros(1, np.int32)
        ),
        inst_area=np.array(inst_areas or [0], np.float32),
        env_id=np.array(env_ids or [0], np.int32),
        env_cdf=(
            np.concatenate(env_cdf_parts) if env_cdf_parts
            else np.zeros(1, np.float32)
        ),
        env_cdf_offset=np.array(env_offsets or [0], np.int32),
        env_cdf_count=np.array(env_counts or [0], np.int32),
        prim_light_area=prim_light_area,
        elem_verts=elem_verts_np,
        elem_is_tri=elem_is_tri_np,
        elem_owner_area=elem_owner_area_np,
    )
    counts = LightCounts(
        n_instance=len(inst_areas),
        n_env=len(env_ids),
        max_inst_elems=max(inst_counts) if inst_counts else 1,
        max_env_texels=max(env_counts) if env_counts else 1,
        total_inst_elems=total_elems,
    )
    return lights, counts


def auto_light_pdf_steps(n_lights: int, has_transmission: bool) -> int:
    """March budget of the truncated whole-scene light pdf (scenes with
    more than EXACT_ELEMS emissive elements): 8 with more than 4 lights or
    a transmissive material, else 4. Occluder hits consume steps without
    adding to the pdf, so the budget is generous."""
    if n_lights > 4 or has_transmission:
        return 8
    return 4


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _take(table, idx):
    """table[idx] with the index clamped into range (JAX gather semantics)."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def sample_discrete(cdf_flat, offset, count, r, max_count: int = 1 << 32):
    """Segmented sample_discrete: pick an index in [0, count) from the
    cumsum segment cdf_flat[offset : offset+count] by a fixed-iteration
    binary search (upper bound). `max_count` (a bound on any segment's
    length) sets the depth: bit_length(max_count) iterations cover the
    count+1 states of the interval [0, count]."""
    count = torch.clamp(count, min=1)
    total = _take(cdf_flat, offset + count - 1)
    limit = torch.minimum(torch.clamp(r * total, min=0.0), total - 1e-5)
    lo = torch.zeros_like(count)
    hi = count
    for _ in range(max(1, int(max_count).bit_length())):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go = lo < hi
        pred = _take(cdf_flat, offset + mid) > limit
        hi = torch.where(go & pred, mid, hi)
        lo = torch.where(go & ~pred, mid + 1, lo)
    return torch.minimum(torch.clamp(lo, min=0), count - 1)


def sample_discrete_pdf(cdf_flat, offset, count, idx):
    """Weight of element idx = cdf[idx] - cdf[idx-1]."""
    hi = _take(cdf_flat, offset + idx)
    lo = torch.where(idx > 0, _take(cdf_flat, offset + idx - 1), 0.0)
    return hi - lo


def sample_triangle_uv(ruv):
    """Uniform triangle warp."""
    s = torch.sqrt(ruv[..., 0])
    return torch.stack([1.0 - s, ruv[..., 1] * s], dim=-1)


def sample_sphere(ruv):
    """Uniform sphere direction."""
    z = 2.0 * ruv[..., 1] - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PIF * ruv[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _env_texel_direction(scene, env_idx, texel, tex_id):
    """Texel index -> world direction through the env frame."""
    w = scene.textures.width[tex_id]
    h = scene.textures.height[tex_id]
    wc = torch.clamp(w, min=1)
    u = ((texel % wc).to(torch.float32) + 0.5) / w.to(torch.float32)
    v = (
        (torch.div(texel, wc, rounding_mode="floor")).to(torch.float32) + 0.5
    ) / h.to(torch.float32)
    local = torch.stack(
        [
            torch.cos(u * 2.0 * PIF) * torch.sin(v * PIF),
            torch.cos(v * PIF),
            torch.sin(u * 2.0 * PIF) * torch.sin(v * PIF),
        ],
        dim=-1,
    )
    return transform_direction(scene.env_frame[env_idx], local)


def sample_lights(scene, lights: DeviceLights, counts: LightCounts, position,
                  rl, rel, ruv):
    """Pick a light uniformly, then a point/texel by CDF; return the world
    direction from `position`."""
    L = counts.total
    if L == 0:
        return torch.zeros_like(position)
    lid = torch.clamp((rl * L).to(torch.int32), 0, L - 1)
    direction = torch.zeros_like(position)

    if counts.n_instance > 0:
        li = torch.clamp(lid, 0, counts.n_instance - 1)
        off = lights.inst_cdf_offset[li]
        cnt = lights.inst_cdf_count[li]
        elem = sample_discrete(
            lights.inst_cdf, off, cnt, rel, max_count=counts.max_inst_elems
        )
        eg = off + elem
        verts = _take(lights.elem_verts, eg).reshape(eg.shape + (4, 3))
        is_tri = _take(lights.elem_is_tri, eg)
        uv = torch.where(is_tri[..., None], sample_triangle_uv(ruv), ruv)
        lpos = interpolate_quad(
            verts[..., 0, :], verts[..., 1, :], verts[..., 2, :],
            verts[..., 3, :], uv[..., 0], uv[..., 1],
        )
        inst_dir = normalize(lpos - position)
        direction = torch.where(
            (lid < counts.n_instance)[..., None], inst_dir, direction
        )

    if counts.n_env > 0:
        ei = torch.clamp(lid - counts.n_instance, 0, counts.n_env - 1)
        if scene.textures.width.shape[0] == 0:
            # untextured environments: uniform sphere only
            env_dir = sample_sphere(ruv)
        else:
            env_idx = lights.env_id[ei]
            cnt = lights.env_cdf_count[ei]
            off = lights.env_cdf_offset[ei]
            texel = sample_discrete(
                lights.env_cdf, off, torch.clamp(cnt, min=1), rel,
                max_count=counts.max_env_texels,
            )
            tex_id = torch.clamp(scene.env_emission_tex[env_idx], min=0)
            tex_dir = _env_texel_direction(scene, env_idx, texel, tex_id)
            env_dir = torch.where((cnt > 0)[..., None], tex_dir, sample_sphere(ruv))
        direction = torch.where(
            (lid >= counts.n_instance)[..., None], env_dir, direction
        )

    return direction


def env_lights_pdf(scene, lights: DeviceLights, counts: LightCounts, direction):
    """Sum of env-light direction pdfs, without the final 1/L factor."""
    pdf = torch.zeros(direction.shape[:-1], device=direction.device)
    if scene.textures.width.shape[0] == 0:
        # untextured environments sample the uniform sphere
        return pdf + counts.n_env / (4.0 * PIF)
    for ei in range(counts.n_env):
        env_idx = lights.env_id[ei]
        cnt = lights.env_cdf_count[ei]
        off = lights.env_cdf_offset[ei]
        tex_id = torch.clamp(scene.env_emission_tex[env_idx], min=0)
        w = scene.textures.width[tex_id]
        h = scene.textures.height[tex_id]
        wl = transform_normal(scene.env_frame_inv[env_idx], direction)
        tx = torch.atan2(wl[..., 2], wl[..., 0]) / (2.0 * PIF)
        tx = torch.where(tx < 0.0, tx + 1.0, tx)
        ty = torch.acos(torch.clamp(wl[..., 1], -1.0, 1.0)) / PIF
        i = torch.minimum(torch.clamp((tx * w).to(torch.int32), min=0), w - 1)
        j = torch.minimum(torch.clamp((ty * h).to(torch.int32), min=0), h - 1)
        idx = j * w + i
        seg_total = _take(lights.env_cdf, off + cnt - 1)
        prob = sample_discrete_pdf(lights.env_cdf, off, cnt, idx) / torch.clamp(
            seg_total, min=1e-30
        )
        wf, hf = w.to(torch.float32), h.to(torch.float32)
        angle = (
            (2.0 * PIF / wf)
            * (PIF / hf)
            * torch.sin(PIF * (j.to(torch.float32) + 0.5) / hf)
        )
        with_tex = prob / torch.clamp(angle, min=1e-30)
        no_tex = torch.full_like(with_tex, 1.0 / (4.0 * PIF))
        pdf = pdf + torch.where(cnt > 0, with_tex, no_tex)
    return pdf


def _lex_less(p, q):
    """Strict lexicographic order of 3D points (edge-ownership tie-break)."""
    return torch.where(
        p[..., 0] != q[..., 0],
        p[..., 0] < q[..., 0],
        torch.where(p[..., 1] != q[..., 1], p[..., 1] < q[..., 1],
                    p[..., 2] < q[..., 2]),
    )


def area_lights_pdf_exact(lights: DeviceLights, counts: LightCounts, position,
                          direction):
    """Exact area-light pdf: sum t^2/(|cos|*area_owner) over EVERY
    emissive element the ray crosses (the closed form of the reference's
    occluder-free per-light marches). Elements are swept as two
    triangles each, (p1,p2,p4)+(p3,p4,p2), in ELEM_PDF_CHUNK-wide slabs.

    Boundaries are half-open: a hit exactly on a shared edge counts once.
    Each directed edge (a->b, b->c, c->a) owns its boundary iff its
    endpoints ascend lexicographically; adjacent triangles traverse a
    shared edge in opposite directions, so exactly one claims it."""
    ci = counts.total_inst_elems
    lanes = position.shape[:-1]
    pdf = torch.zeros(lanes, device=position.device)
    if ci == 0:
        return pdf
    ro = position[..., None, :]
    rd = direction[..., None, :]
    tmin = 1e-4

    def tri_contrib(a, b, c, area):
        edge1 = b - a
        edge2 = c - a
        pvec = cross(rd, edge2[None])
        det = dot(edge1[None], pvec)
        inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
        tvec = ro - a[None]
        u = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, edge1[None])
        v = dot(rd, qvec) * inv_det
        t = dot(edge2[None], qvec) * inv_det
        own_ab = _lex_less(a, b)[None]  # v == 0 lies on edge a-b
        own_bc = _lex_less(b, c)[None]  # u + v == 1 lies on edge b-c
        own_ca = _lex_less(c, a)[None]  # u == 0 lies on edge c-a
        hit = (
            (det != 0.0)
            & ((v > 0.0) | ((v == 0.0) & own_ab))
            & ((u > 0.0) | ((u == 0.0) & own_ca))
            & ((u + v < 1.0) | ((u + v == 1.0) & own_bc))
            & (t >= tmin)
        )
        nrm = triangle_normal(a, b, c)  # [chunk, 3]
        cos = torch.abs(dot(nrm[None], rd))
        contrib = t * t / torch.clamp(cos * area[None], min=1e-30)
        return torch.where(hit & (area[None] > 0), contrib, 0.0).sum(dim=-1)

    for s in range(0, ci, ELEM_PDF_CHUNK):
        e = min(s + ELEM_PDF_CHUNK, ci)
        v = lights.elem_verts[s:e].reshape(-1, 4, 3)
        a = lights.elem_owner_area[s:e]
        p1, p2, p3, p4 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
        # embedded triangles have p3 == p4, so the second is degenerate
        pdf = pdf + tri_contrib(p1, p2, p4, a) + tri_contrib(p3, p4, p2, a)
    return pdf


def area_light_hit_pdf(lights: DeviceLights, prim, dist2, lnormal, direction,
                       hit, total_elems: int = 0):
    """One march step's contribution: dist^2 / (|cos| * area_owner) where
    the hit prim belongs to a light. With at most DENSE_ELEMS light
    elements the owner is found by a compare-select over the element prim
    ids, else by a gather from the per-prim area table with the id clamped
    into range (a line or point hit, id >= Q, reads the last quad's)."""
    if 0 < total_elems <= DENSE_ELEMS:
        area = torch.zeros(prim.shape, device=prim.device)
        for e in range(total_elems):
            area = torch.where(prim == lights.inst_prim[e],
                               lights.elem_owner_area[e], area)
    else:
        area = _take(lights.prim_light_area, prim)
    cos = torch.abs(dot(lnormal, direction))
    contrib = dist2 / torch.clamp(cos * area, min=1e-30)
    return torch.where(hit & (area > 0), contrib, 0.0)


def area_lights_pdf_march(lights: DeviceLights, counts: LightCounts,
                          intersect_fn, position, direction, first_hit,
                          extra_steps: int):
    """Truncated whole-scene march of the area-light pdf: `first_hit`
    (the bounce's own closest hit along `direction`) is step 1; each of
    `extra_steps` more steps starts 1e-3 past the last hit with tmin 1e-4
    and adds its hit's contribution at the accumulated distance. Lanes
    that stopped marching carry tmax = -1, which fails every slab test
    even when the origin sits inside a box (a small positive tmax would
    not). The steps add in a fixed order.

    A `light_march` span (utils/timing.py device_span) covers the extra
    steps: `lanes` and `steps` (integers), and tensors read when the
    units are: `marching`, the lane-steps whose lane still marched when
    the step was issued (every step runs at full width); `emitter_hits`,
    the lane-steps whose hit added to the pdf; `truncated`, the lanes
    whose last step still hit, whose pdf the budget cut short."""
    t_cum = first_hit.t
    hit = first_hit.hit
    pdf = area_light_hit_pdf(lights, first_hit.prim, t_cum * t_cum,
                             first_hit.gnormal, direction, hit,
                             total_elems=counts.total_inst_elems)
    marching = hit
    with timing.device_span("light_march", position.device,
                            lanes=t_cum.shape[0], steps=extra_steps) as sp:
        # every hit of the march, the first's included, and the steps
        # that added: a lane marches at step k while its first k hits hit
        hits = hit.to(torch.int32)
        added = torch.zeros_like(hits)
        for _ in range(extra_steps):
            origin = position + direction * (t_cum + 1e-3)[..., None]
            tmin = torch.full_like(t_cum, 1e-4)
            tmax = torch.where(marching, F32_MAX, -1.0)
            step = intersect_fn(origin, direction, tmin, tmax)
            hit = step.hit & marching
            t_cum = torch.where(hit, t_cum + 1e-3 + step.t, t_cum)
            term = area_light_hit_pdf(lights, step.prim, t_cum * t_cum,
                                      step.gnormal, direction, hit,
                                      total_elems=counts.total_inst_elems)
            pdf = pdf + term
            hits += hit
            added += term > 0
            marching = hit
        truncated = marching.sum(dtype=torch.int64)
        sp.add(marching=hits.sum(dtype=torch.int64) - truncated,
               emitter_hits=added.sum(dtype=torch.int64), truncated=truncated)
    return pdf


def sample_lights_pdf(scene, lights: DeviceLights, counts: LightCounts,
                      position, direction, intersect_fn=None, first_hit=None,
                      extra_steps: int = 4):
    """Solid-angle pdf of `direction` under light sampling, over L: the
    area lights' exact element sweep when the scene has at most
    EXACT_ELEMS emissive elements (`intersect_fn`, `first_hit` and
    `extra_steps` are unused there), else the truncated march
    (`area_lights_pdf_march`) through `intersect_fn` from `first_hit`;
    plus the env-light pdfs."""
    L = counts.total
    if L == 0:
        return torch.zeros(position.shape[:-1], device=position.device)
    if counts.total_inst_elems <= EXACT_ELEMS:
        pdf = area_lights_pdf_exact(lights, counts, position, direction)
    else:
        if intersect_fn is None or first_hit is None:
            raise ValueError(
                f"{counts.total_inst_elems} emissive elements > "
                f"{EXACT_ELEMS}: the light pdf marches, so it needs "
                "intersect_fn and first_hit")
        pdf = area_lights_pdf_march(lights, counts, intersect_fn, position,
                                    direction, first_hit, extra_steps)
    if counts.n_env > 0:
        pdf = pdf + env_lights_pdf(scene, lights, counts, direction)
    return pdf * (1.0 / L)
