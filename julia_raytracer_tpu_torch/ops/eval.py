"""Surface evaluation at hit points, port of julia_raytracer_tpu/ops/eval.py.

Given (prim, u, v) hits, these produce the shading normal (vertex
normals, normal mapping, the refractive-orientation rule), interpolated
attributes, and the MaterialPoint the integrator shades with.
Primitives are unified as quads (triangles are degenerate quads).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops import texture as tex_ops
from julia_raytracer_tpu_torch.ops.geometry import (
    interpolate_quad, quad_normal, triangle_tangents_fromuv,
)
from julia_raytracer_tpu_torch.ops.row_gather import gather_rows
from julia_raytracer_tpu_torch.scene.flatten import (
    FLAG_HAS_COLORS, FLAG_HAS_NORMALS, FLAG_HAS_TEXCOORDS,
)
from julia_raytracer_tpu_torch.scene.types import MIN_ROUGHNESS, MaterialType
from julia_raytracer_tpu_torch.utils.vecmath import (
    cross, dot, mat_mul_vec, normalize, orthonormalize, transform_normal,
)


class MaterialPoint(NamedTuple):
    """Per-lane evaluated material."""

    type: torch.Tensor  # i32 [N]
    emission: torch.Tensor  # f32 [N, 3]
    color: torch.Tensor  # f32 [N, 3]
    opacity: torch.Tensor  # f32 [N]
    roughness: torch.Tensor  # f32 [N]
    metallic: torch.Tensor  # f32 [N]
    ior: torch.Tensor  # f32 [N]
    density: torch.Tensor  # f32 [N, 3]
    scattering: torch.Tensor  # f32 [N, 3]
    scanisotropy: torch.Tensor  # f32 [N]
    trdepth: torch.Tensor  # f32 [N]


def gather_prim(scene, prim):
    """Per-prim data for hit lanes: verts [N,4,3], vidx, instance, flags."""
    return (
        scene.prim_verts[prim],
        scene.prim_vidx[prim],
        scene.prim_instance[prim],
        scene.prim_flags[prim],
    )


def _interp4(attr, u, v):
    """Interpolate a [N, 4, K] per-corner attribute at (u, v)."""
    return interpolate_quad(
        attr[..., 0, :], attr[..., 1, :], attr[..., 2, :], attr[..., 3, :], u, v
    )


def eval_position(verts, u, v):
    """World hit position via quad interpolation."""
    return _interp4(verts, u, v)


def eval_texcoord(scene, vidx, flags, u, v):
    """Interpolated texcoord; uv passthrough when absent."""
    out = _interp4(scene.vert_texcoords[vidx], u, v)
    has = (flags & FLAG_HAS_TEXCOORDS) != 0
    return torch.where(has[..., None], out, torch.stack([u, v], dim=-1))


def eval_color_attr(scene, vidx, flags, u, v):
    """Interpolated vertex color; white when absent."""
    out = _interp4(scene.vert_colors[vidx], u, v)
    has = (flags & FLAG_HAS_COLORS) != 0
    return torch.where(has[..., None], out, 1.0)


def eval_element_normal(verts):
    """Geometric normal from world verts (degenerate quads reduce to the
    triangle normal)."""
    return quad_normal(
        verts[..., 0, :], verts[..., 1, :], verts[..., 2, :], verts[..., 3, :]
    )


def eval_normal(scene, gnormal, vidx, inst, flags, u, v,
                with_vertex_normals=True):
    """Interpolated shading normal, world space. `gnormal` is the element
    normal from the intersector; `with_vertex_normals=False` skips the
    gather when no shape has vertex normals."""
    if not with_vertex_normals:
        return gnormal
    interp = normalize(_interp4(scene.vert_normals[vidx], u, v))
    world = transform_normal(scene.inst_frame[inst], interp)
    has = (flags & FLAG_HAS_NORMALS) != 0
    return torch.where(has[..., None], world, gnormal)


def eval_element_tangents(scene, verts, vidx, flags):
    """UV tangents of the element's first triangle, in the space of
    `verts`."""
    tc = scene.vert_texcoords[vidx]
    tu, tv = triangle_tangents_fromuv(
        verts[..., 0, :], verts[..., 1, :], verts[..., 3, :],
        tc[..., 0, :], tc[..., 1, :], tc[..., 3, :],
    )
    return normalize(tu), normalize(tv)


def eval_normalmap(scene, normal, texcoord, normal_tex, verts, vidx, flags,
                   inst=None, instanced=False):
    """Tangent-space normal mapping. In instanced mode `verts` are shape
    space, so the tangents rotate into world by the instance frame."""
    nm = tex_ops.eval_texture(scene.textures, normal_tex, texcoord,
                              as_linear=False)
    normalmap = nm[..., :3] * 2.0 - 1.0
    tu, tv = eval_element_tangents(scene, verts, vidx, flags)
    if instanced:
        frame = scene.inst_frame[inst]
        tu = transform_normal(frame, tu)
        tv = transform_normal(frame, tv)
    f1 = orthonormalize(tu, normal)
    f2 = normalize(cross(normal, f1))
    flip_v = dot(f2, tv) < 0.0
    n2 = normalmap[..., 1] * torch.where(flip_v, 1.0, -1.0)
    nm_vec = torch.stack([normalmap[..., 0], n2, normalmap[..., 2]], dim=-1)
    frame = torch.stack([f1, f2, normal], dim=-2)
    mapped = normalize(mat_mul_vec(frame, nm_vec))
    has_tc = (flags & FLAG_HAS_TEXCOORDS) != 0
    apply = (normal_tex >= 0) & has_tc
    return torch.where(apply[..., None], mapped, normal)


def eval_shading_normal(
    scene, gnormal, verts, vidx, inst, flags, u, v, outgoing, mat_type,
    normal_tex, texcoord, with_normalmap=True, with_vertex_normals=True,
    refractive_present=True, instanced=False,
):
    """Full shading-normal pipeline: vertex normal, optional normal map,
    faceforward, except refractive materials keep the geometric
    orientation. The with_* flags drop stages the scene cannot exercise;
    `verts` may be None when with_normalmap is False. `instanced=True`:
    `verts` are shape space (instanced scenes), so the normal-map tangents
    rotate into world by the instance frame."""
    normal = eval_normal(
        scene, gnormal, vidx, inst, flags, u, v,
        with_vertex_normals=with_vertex_normals,
    )
    if with_normalmap:
        normal = eval_normalmap(scene, normal, texcoord, normal_tex, verts,
                                vidx, flags, inst=inst, instanced=instanced)
    forward = torch.where(dot(normal, outgoing)[..., None] >= 0.0, normal, -normal)
    if not refractive_present:
        return forward
    keep = mat_type == MaterialType.REFRACTIVE
    return torch.where(keep[..., None], normal, forward)


def _material_point(mtype, emission, color, opacity, roughness, metallic,
                    ior, scattering, scanisotropy, trdepth):
    """Shared tail of the eval_material variants: roughness^2 with the
    min-roughness clamp, and density from trdepth for volume-like types.
    `roughness` arrives unsquared."""
    roughness = roughness * roughness
    volumetric_like = is_volumetric_type(mtype)
    density = torch.where(
        volumetric_like[..., None],
        -torch.log(torch.clamp(color, 1e-4, 1.0)) / trdepth[..., None],
        0.0,
    )
    clamp_min = (
        (mtype == MaterialType.MATTE)
        | (mtype == MaterialType.GLTFPBR)
        | (mtype == MaterialType.GLOSSY)
    )
    roughness = torch.where(
        clamp_min,
        torch.clamp(roughness, MIN_ROUGHNESS, 1.0),
        torch.where(
            mtype == MaterialType.VOLUMETRIC,
            0.0,
            torch.where(roughness < MIN_ROUGHNESS, 0.0, roughness),
        ),
    )
    return MaterialPoint(
        type=mtype, emission=emission, color=color, opacity=opacity,
        roughness=roughness, metallic=metallic, ior=ior, density=density,
        scattering=scattering, scanisotropy=scanisotropy, trdepth=trdepth,
    )


def eval_material(scene, inst, texcoord, shp_color):
    """Evaluate the MaterialPoint through the instance -> material tables:
    texture modulation, roughness^2 + min-roughness clamp, density from
    trdepth."""
    mid = scene.inst_material[inst]
    m = scene.materials
    tex = scene.textures
    emission_tex = tex_ops.eval_texture(tex, m.emission_tex[mid], texcoord, True)
    color_tex = tex_ops.eval_texture(tex, m.color_tex[mid], texcoord, True)
    roughness_tex = tex_ops.eval_texture(tex, m.roughness_tex[mid], texcoord, False)
    scattering_tex = tex_ops.eval_texture(tex, m.scattering_tex[mid], texcoord, True)
    # the float tables in one gather, whose backward sums the lanes into
    # the few material rows without serialising (ops/row_gather.py)
    (emission, color, opacity, roughness, metallic, ior, scattering,
     scanisotropy, trdepth) = gather_rows(
        mid, m.emission, m.color, m.opacity, m.roughness, m.metallic, m.ior,
        m.scattering, m.scanisotropy, m.trdepth)
    return _material_point(
        m.type[mid],
        emission=emission * emission_tex[..., :3],
        color=color * color_tex[..., :3] * shp_color[..., :3],
        opacity=opacity * color_tex[..., 3] * shp_color[..., 3],
        roughness=roughness * roughness_tex[..., 1],
        metallic=metallic * roughness_tex[..., 2],
        ior=ior,
        scattering=scattering * scattering_tex[..., :3],
        scanisotropy=scanisotropy,
        trdepth=trdepth,
    )


def eval_material_dense(scene, inst, shp_color):
    """eval_material for UNTEXTURED scenes from the folded per-instance
    table scene.inst_mat_dense ([I, 21], see render/scene_device.py): one
    row gather in place of the instance -> material indirection. Texture
    terms are identity by construction, so the result equals
    eval_material."""
    row = scene.inst_mat_dense[inst]
    return _material_point(
        row[..., 0].to(torch.int32),
        emission=row[..., 1:4],
        color=row[..., 4:7] * shp_color[..., :3],
        opacity=row[..., 15] * shp_color[..., 3],
        roughness=row[..., 7],
        metallic=row[..., 8],
        ior=row[..., 9],
        scattering=row[..., 10:13],
        scanisotropy=row[..., 13],
        trdepth=row[..., 14],
    )


def eval_material_rows(scene, rows, texcoord, shp_color):
    """eval_material from pre-gathered [N, 21] dense-material rows
    (constants + texture ids): the textured counterpart of
    eval_material_dense."""
    tex = scene.textures
    e_tex, c_tex, r_tex, s_tex = (
        rows[..., k].to(torch.int32) for k in (16, 17, 18, 19)
    )
    emission_tex = tex_ops.eval_texture(tex, e_tex, texcoord, True)
    color_tex = tex_ops.eval_texture(tex, c_tex, texcoord, True)
    roughness_tex = tex_ops.eval_texture(tex, r_tex, texcoord, False)
    scattering_tex = tex_ops.eval_texture(tex, s_tex, texcoord, True)
    return _material_point(
        rows[..., 0].to(torch.int32),
        emission=rows[..., 1:4] * emission_tex[..., :3],
        color=rows[..., 4:7] * color_tex[..., :3] * shp_color[..., :3],
        opacity=rows[..., 15] * color_tex[..., 3] * shp_color[..., 3],
        roughness=rows[..., 7] * roughness_tex[..., 1],
        metallic=rows[..., 8] * roughness_tex[..., 2],
        ior=rows[..., 9],
        scattering=rows[..., 10:13] * scattering_tex[..., :3],
        scanisotropy=rows[..., 13],
        trdepth=rows[..., 14],
    )


def is_delta(material: MaterialPoint):
    t, r = material.type, material.roughness
    return (
        ((t == MaterialType.REFLECTIVE) & (r == 0.0))
        | ((t == MaterialType.REFRACTIVE) & (r == 0.0))
        | ((t == MaterialType.TRANSPARENT) & (r == 0.0))
        | (t == MaterialType.VOLUMETRIC)
    )


def is_volumetric_type(mtype):
    """On the base material type."""
    return (
        (mtype == MaterialType.REFRACTIVE)
        | (mtype == MaterialType.VOLUMETRIC)
        | (mtype == MaterialType.SUBSURFACE)
    )


def eval_emission(material: MaterialPoint, normal, outgoing):
    facing = dot(normal, outgoing) >= 0.0
    return torch.where(facing[..., None], material.emission, 0.0)


def eval_environment(scene, direction):
    """Sum of all environment contributions."""
    total = torch.zeros_like(direction[..., :3])
    for e in range(scene.env_frame.shape[0]):
        wl = transform_normal(scene.env_frame_inv[e], direction)
        tx = torch.atan2(wl[..., 2], wl[..., 0]) / (2.0 * math.pi)
        tx = torch.where(tx < 0.0, tx + 1.0, tx)
        ty = torch.acos(torch.clamp(wl[..., 1], -1.0, 1.0)) / math.pi
        texcoord = torch.stack([tx, ty], dim=-1)
        tid = scene.env_emission_tex[e].expand(direction.shape[:-1])
        emis = tex_ops.eval_texture(scene.textures, tid, texcoord, True)
        total = total + scene.env_emission[e] * emis[..., :3]
    return total
