"""Scene -> flat arrays (numpy), port of
julia_raytracer_tpu/scene/flatten.py.

By default every instance's primitives are expanded into one world-space
quad soup. With `expand_prims=False` (the two-level instanced build,
scene/instanced.py) each shape's primitives appear once, in shape space,
concatenated in shape order with `shape_prim_offset` bounds, and
`prim_instance` holds the owning shape id. Triangles use the
degenerate-quad convention (a, b, c, c), which is how the reference
treats its triangle/quad duality. Vertex attributes stay in object
space, concatenated across shapes and indexed by global vertex ids per
primitive.

Not ported yet (they raise NotImplementedError, see ROADMAP.md):
line/point primitives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from julia_raytracer_tpu_torch.scene.types import INVALID_ID, SceneData

# per-prim flag bits
FLAG_HAS_NORMALS = 1
FLAG_HAS_TEXCOORDS = 2
FLAG_HAS_COLORS = 4
FLAG_IS_TRIANGLE_SHAPE = 8  # true triangle mesh (affects light uv warp)


@dataclass
class FlatGeometry:
    """Expanded world-space primitives + concatenated vertex attributes.
    In instanced mode (flatten_scene(expand_prims=False)) the prim arrays
    hold each shape's primitives once, in shape space, and prim_instance
    is the owning shape id."""

    # per expanded primitive (count Q)
    prim_verts: np.ndarray  # f32 [Q, 4, 3] world-space corners
    prim_vidx: np.ndarray  # i32 [Q, 4] global vertex ids
    prim_instance: np.ndarray  # i32 [Q]
    prim_element: np.ndarray  # i32 [Q] element index within its shape
    prim_flags: np.ndarray  # i32 [Q] FLAG_* bitmask
    # concatenated object-space vertex attributes (count V)
    vert_normals: np.ndarray  # f32 [V, 3] (zeros when absent)
    vert_texcoords: np.ndarray  # f32 [V, 2] (zeros when absent)
    vert_colors: np.ndarray  # f32 [V, 4] (ones when absent)
    vert_positions: np.ndarray  # f32 [V, 3] object space
    # per instance (count I)
    inst_frame: np.ndarray  # f32 [I, 4, 3]
    inst_material: np.ndarray  # i32 [I]
    inst_shape: np.ndarray  # i32 [I]
    # per shape (count S)
    shape_vert_offset: np.ndarray  # i64 [S+1] into concatenated vertex arrays
    # instanced mode only: per-shape prim bounds into the prim arrays
    shape_prim_offset: np.ndarray = None  # i64 [S+1] (None when expanded)


@dataclass
class FlatMaterials:
    type: np.ndarray  # i32 [M]
    emission: np.ndarray  # f32 [M, 3]
    color: np.ndarray  # f32 [M, 3]
    roughness: np.ndarray  # f32 [M]
    metallic: np.ndarray  # f32 [M]
    ior: np.ndarray  # f32 [M]
    scattering: np.ndarray  # f32 [M, 3]
    scanisotropy: np.ndarray  # f32 [M]
    trdepth: np.ndarray  # f32 [M]
    opacity: np.ndarray  # f32 [M]
    emission_tex: np.ndarray  # i32 [M]
    color_tex: np.ndarray  # i32 [M]
    roughness_tex: np.ndarray  # i32 [M]
    scattering_tex: np.ndarray  # i32 [M]
    normal_tex: np.ndarray  # i32 [M]


@dataclass
class FlatTextures:
    """All textures in one flat atlas, row-major per texture."""

    data: np.ndarray  # f32 [sum(w*h), 4] raw values (byte textures /255, no srgb)
    offset: np.ndarray  # i32 [T]
    width: np.ndarray  # i32 [T]
    height: np.ndarray  # i32 [T]
    linear: np.ndarray  # bool [T] True = float/HDR (already linear)


@dataclass
class FlatEnvironments:
    frame: np.ndarray  # f32 [E, 4, 3]
    frame_inv: np.ndarray  # f32 [E, 4, 3] (precomputed rigid inverse)
    emission: np.ndarray  # f32 [E, 3]
    emission_tex: np.ndarray  # i32 [E]


@dataclass
class FlatScene:
    geometry: FlatGeometry
    materials: FlatMaterials
    textures: FlatTextures
    environments: FlatEnvironments
    n_instances: int
    n_shapes: int


def _shape_prims(shape) -> tuple[np.ndarray, bool]:
    """Shape faces as unified quads [P, 4] (0-based) + is-triangle-mesh flag."""
    if len(shape.quads):
        return shape.quads.astype(np.int64), False
    if len(shape.triangles):
        t = shape.triangles.astype(np.int64)
        return np.concatenate([t, t[:, 2:3]], axis=1), True
    return np.zeros((0, 4), np.int64), False


def flatten_scene(scene: SceneData, expand_prims: bool = True) -> FlatScene:
    S = len(scene.shapes)
    for inst in scene.instances:
        if 0 <= inst.shape < S:
            shape = scene.shapes[inst.shape]
            if len(shape.lines) or len(shape.points):
                raise NotImplementedError(
                    "line and point primitives are not ported yet "
                    "(ROADMAP.md queue 1, item 10)"
                )
    shape_quads = []
    shape_is_tri = np.zeros(S, bool)
    vert_offset = np.zeros(S + 1, np.int64)
    for s, shape in enumerate(scene.shapes):
        q, is_tri = _shape_prims(shape)
        shape_quads.append(q)
        shape_is_tri[s] = is_tri
        vert_offset[s + 1] = vert_offset[s] + len(shape.positions)

    # concatenated vertex attributes (defaults where a shape lacks them)
    def concat_attr(name, width, default):
        parts = []
        for shape in scene.shapes:
            arr = getattr(shape, name)
            n = len(shape.positions)
            if len(arr) == n and n > 0:
                parts.append(arr.astype(np.float32))
            else:
                parts.append(np.full((n, width), default, np.float32))
        return (
            np.concatenate(parts, axis=0)
            if parts
            else np.zeros((0, width), np.float32)
        )

    vert_positions = concat_attr("positions", 3, 0.0)
    vert_normals = concat_attr("normals", 3, 0.0)
    vert_texcoords = concat_attr("texcoords", 2, 0.0)
    vert_colors = concat_attr("colors", 4, 1.0)

    def shape_flags(sid: int) -> int:
        shape = scene.shapes[sid]
        flags = 0
        if len(shape.normals) == len(shape.positions) and len(shape.normals):
            flags |= FLAG_HAS_NORMALS
        if len(shape.texcoords) == len(shape.positions) and len(shape.texcoords):
            flags |= FLAG_HAS_TEXCOORDS
        if len(shape.colors) == len(shape.positions) and len(shape.colors):
            flags |= FLAG_HAS_COLORS
        if shape_is_tri[sid]:
            flags |= FLAG_IS_TRIANGLE_SHAPE
        return flags

    # expand instances to world-space primitives
    pv, pvi, pin, pel, pfl = [], [], [], [], []
    I = len(scene.instances)
    inst_frame = np.zeros((max(I, 1), 4, 3), np.float32)
    inst_material = np.zeros(max(I, 1), np.int32)
    inst_shape = np.zeros(max(I, 1), np.int32)
    for i, inst in enumerate(scene.instances):
        inst_frame[i] = inst.frame
        inst_material[i] = inst.material
        inst_shape[i] = inst.shape
        if not expand_prims or inst.shape == INVALID_ID or inst.shape >= S:
            continue
        shape = scene.shapes[inst.shape]
        quads = shape_quads[inst.shape]
        if len(quads) == 0:
            continue
        gidx = quads + vert_offset[inst.shape]
        world = shape.positions[quads.reshape(-1)].reshape(-1, 4, 3)
        rot, org = inst.frame[:3], inst.frame[3]
        world = world @ rot + org  # transform_point
        flags = shape_flags(inst.shape)
        pv.append(world.astype(np.float32))
        pvi.append(gidx.astype(np.int32))
        pin.append(np.full(len(quads), i, np.int32))
        pel.append(np.arange(len(quads), dtype=np.int32))
        pfl.append(np.full(len(quads), flags, np.int32))

    shape_prim_offset = None
    if not expand_prims:
        # instanced mode: each shape's prims once, in shape space
        shape_prim_offset = np.zeros(S + 1, np.int64)
        for sid, shape in enumerate(scene.shapes):
            quads = shape_quads[sid]
            shape_prim_offset[sid + 1] = shape_prim_offset[sid] + len(quads)
            if len(quads) == 0:
                continue
            pv.append(shape.positions[quads.reshape(-1)].reshape(-1, 4, 3)
                      .astype(np.float32))
            pvi.append((quads + vert_offset[sid]).astype(np.int32))
            pin.append(np.full(len(quads), sid, np.int32))  # shape id
            pel.append(np.arange(len(quads), dtype=np.int32))
            pfl.append(np.full(len(quads), shape_flags(sid), np.int32))

    if pv:
        prim_verts = np.concatenate(pv, axis=0)
        prim_vidx = np.concatenate(pvi, axis=0)
        prim_instance = np.concatenate(pin, axis=0)
        prim_element = np.concatenate(pel, axis=0)
        prim_flags = np.concatenate(pfl, axis=0)
    else:
        prim_verts = np.zeros((0, 4, 3), np.float32)
        prim_vidx = np.zeros((0, 4), np.int32)
        prim_instance = np.zeros(0, np.int32)
        prim_element = np.zeros(0, np.int32)
        prim_flags = np.zeros(0, np.int32)

    geometry = FlatGeometry(
        prim_verts=prim_verts,
        prim_vidx=prim_vidx,
        prim_instance=prim_instance,
        prim_element=prim_element,
        prim_flags=prim_flags,
        vert_normals=vert_normals,
        vert_texcoords=vert_texcoords,
        vert_colors=vert_colors,
        vert_positions=vert_positions,
        inst_frame=inst_frame,
        inst_material=inst_material,
        inst_shape=inst_shape,
        shape_vert_offset=vert_offset.astype(np.int64),
        shape_prim_offset=shape_prim_offset,
    )

    M = len(scene.materials)

    def mat_col(name, dtype, *shape):
        return np.array(
            [getattr(m, name) for m in scene.materials], dtype
        ).reshape(M, *shape)

    mats = FlatMaterials(
        type=mat_col("type", np.int32),
        emission=mat_col("emission", np.float32, 3),
        color=mat_col("color", np.float32, 3),
        roughness=mat_col("roughness", np.float32),
        metallic=mat_col("metallic", np.float32),
        ior=mat_col("ior", np.float32),
        scattering=mat_col("scattering", np.float32, 3),
        scanisotropy=mat_col("scanisotropy", np.float32),
        trdepth=mat_col("trdepth", np.float32),
        opacity=mat_col("opacity", np.float32),
        emission_tex=mat_col("emission_tex", np.int32),
        color_tex=mat_col("color_tex", np.int32),
        roughness_tex=mat_col("roughness_tex", np.int32),
        scattering_tex=mat_col("scattering_tex", np.int32),
        normal_tex=mat_col("normal_tex", np.int32),
    )

    T = len(scene.textures)
    sizes = [t.width * t.height for t in scene.textures]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    tex = FlatTextures(
        data=(
            np.concatenate([t.pixels for t in scene.textures], axis=0)
            if T
            else np.zeros((0, 4), np.float32)
        ),
        offset=offsets[:-1].astype(np.int32) if T else np.zeros(0, np.int32),
        width=np.array([t.width for t in scene.textures], np.int32).reshape(T),
        height=np.array([t.height for t in scene.textures], np.int32).reshape(T),
        linear=np.array([t.linear for t in scene.textures], bool).reshape(T),
    )

    E = len(scene.environments)
    env_frames = np.array(
        [e.frame for e in scene.environments], np.float32
    ).reshape(E, 4, 3)
    # rigid inverse: transpose the rotation
    inv = np.zeros_like(env_frames)
    for i in range(E):
        minv = env_frames[i, :3].T
        inv[i, :3] = minv
        inv[i, 3] = -(env_frames[i, 3] @ minv)
    envs = FlatEnvironments(
        frame=env_frames,
        frame_inv=inv,
        emission=np.array(
            [e.emission for e in scene.environments], np.float32
        ).reshape(E, 3),
        emission_tex=np.array(
            [e.emission_tex for e in scene.environments], np.int32
        ).reshape(E),
    )

    return FlatScene(
        geometry=geometry,
        materials=mats,
        textures=tex,
        environments=envs,
        n_instances=I,
        n_shapes=S,
    )
