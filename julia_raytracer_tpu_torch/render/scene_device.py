"""Device-resident scene: every tensor the integrator touches, port of
julia_raytracer_tpu/render/scene_device.py.

Flat build: the host FlatScene (scene/flatten.py) + the BVH permutation
of the port's ops/bvh.py (a numpy copy of the JAX package's builder):
primitive arrays are reordered to BVH leaf order once, on the host, so
prim ids match the JAX package's.

Instanced build (`build_device_scene_instanced`, taken automatically
for scenes whose flattening would be >= 4M quads and >= 4x duplication,
as the JAX package does): per-shape cluster tables in shape space plus
(instance, supercluster) work items (scene/instanced.py); the prim
arrays are then the shape-space eval layout the work-item intersector's
prim ids index, and `prim_instance` is a 1-element placeholder (hits
carry their instance). With >= 1,024 instances the hybrid build also
expands the instances of small shapes into a world-space soup.

`DeviceScene` is a NamedTuple of tensors on one device; `SceneConfig`
holds the static facts that prune the integrator. Entry points take
`device=None`, which means the card (`resolve_device`); the CPU only
when the caller passes `device="cpu"`.

Not ported (see ROADMAP.md): the on-disk cache.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.bvh import build_bvh, quad_bounds
from julia_raytracer_tpu_torch.render.lights import (
    EXACT_ELEMS, DeviceLights, LightCounts, build_lights_np,
)
from julia_raytracer_tpu_torch.scene.flatten import (
    FLAG_HAS_COLORS, FLAG_HAS_NORMALS, FLAG_HAS_TEXCOORDS, flatten_scene,
)
from julia_raytracer_tpu_torch.scene.instanced import (
    InstancedTables, build_instanced_tables, build_world_flat,
    expand_emissive_world_prims, select_flatten_shapes,
)


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None. Raises RuntimeError when the
    card is asked for (explicitly or by default) and none is present:
    there is no silent CPU fallback; pass device="cpu" for the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default, pass device=\"cpu\" to run on the CPU"
        )
    return dev


class DeviceMaterials(NamedTuple):
    type: torch.Tensor  # i32 [M]
    emission: torch.Tensor  # f32 [M, 3]
    color: torch.Tensor  # f32 [M, 3]
    roughness: torch.Tensor
    metallic: torch.Tensor
    ior: torch.Tensor
    scattering: torch.Tensor  # [M, 3]
    scanisotropy: torch.Tensor
    trdepth: torch.Tensor
    opacity: torch.Tensor
    emission_tex: torch.Tensor  # i32
    color_tex: torch.Tensor
    roughness_tex: torch.Tensor
    scattering_tex: torch.Tensor
    normal_tex: torch.Tensor


class DeviceTextures(NamedTuple):
    data: torch.Tensor  # f32 [P, 4]
    offset: torch.Tensor  # i32 [T]
    width: torch.Tensor  # i32 [T]
    height: torch.Tensor  # i32 [T]
    linear: torch.Tensor  # bool [T]


class DeviceScene(NamedTuple):
    """All scene tensors, primitive arrays in BVH leaf order."""

    prim_verts: torch.Tensor  # f32 [Q, 4, 3]
    prim_vidx: torch.Tensor  # i32 [Q, 4]
    prim_instance: torch.Tensor  # i32 [Q]
    prim_flags: torch.Tensor  # i32 [Q]
    nodes: torch.Tensor  # f32 [Nn, 16] packed BVH
    vert_normals: torch.Tensor
    vert_texcoords: torch.Tensor
    vert_colors: torch.Tensor
    inst_frame: torch.Tensor  # f32 [I, 4, 3]
    inst_material: torch.Tensor  # i32 [I]
    materials: DeviceMaterials
    textures: DeviceTextures
    env_frame: torch.Tensor  # f32 [E, 4, 3]
    env_frame_inv: torch.Tensor
    env_emission: torch.Tensor  # f32 [E, 3]
    env_emission_tex: torch.Tensor  # i32 [E]
    lights: DeviceLights
    # per-instance material constants folded to one row: [I, 21] =
    # [type, emission*3, color*3, roughness, metallic, ior,
    #  scattering*3, scanisotropy, trdepth, opacity,
    #  emission_tex, color_tex, roughness_tex, scattering_tex, normal_tex]
    inst_mat_dense: torch.Tensor


class SceneConfig(NamedTuple):
    """Static facts about the scene. The feature flags let the integrator
    drop material lobes, texture paths, normal mapping, opacity and volume
    work the scene cannot exercise."""

    n_prims: int
    root_is_leaf: bool
    n_envs: int
    light_counts: LightCounts
    has_normal_maps: bool
    has_opacity: bool
    present_types: tuple = tuple(range(8))  # sorted MaterialType ints present
    n_instances: int = 0
    has_textures: bool = True
    has_vertex_normals: bool = True
    has_texcoords: bool = True
    has_colors: bool = True
    has_volumes: bool = True
    # host (numpy) copies of the sorted primitive arrays, from which
    # build_intersector makes the intersector's tables
    host_prim_verts: object = None
    host_prim_instance: object = None
    # curve/point primitive counts (the port rejects scenes with any)
    n_lines: int = 0
    n_points: int = 0
    # two-level instancing (scene/instanced.py InstancedTables). When set,
    # the prim arrays are shape space (the cluster-padded concatenation in
    # intersector prim-id order) and hits carry the instance
    inst_tables: object = None
    # world-space scene bounds (lo[3], hi[3]) in instanced mode, where the
    # integrator cannot derive them from the shape-space prim arrays
    world_bounds: object = None
    # hybrid instancing (scene/instanced.py build_world_flat): instances
    # of many-instance small shapes flattened into a world-space soup for
    # the flat intersectors, and the remap of its prim ids into the
    # shape-space eval layout. Host numpy; None = pure instanced
    hyb_world_verts: object = None  # f32 [Pf, 4, 3]
    hyb_world_inst: object = None  # i32 [Pf]
    hyb_remap: object = None  # i32 [Pf] -> eval prim id


def _inst_mat_dense(g, m) -> np.ndarray:
    """Fold the instance -> material indirection into one packed f32 row
    per instance (texture-free constants + texture ids)."""
    i_count = max(len(g.inst_material), 1)
    out = np.zeros((i_count, 21), np.float32)
    out[:, 16:21] = -1.0  # texture ids default to "none"
    if len(m.type) == 0:
        return out
    mid = np.clip(g.inst_material, 0, len(m.type) - 1)
    n = len(mid)
    out[:n, 0] = m.type[mid]
    out[:n, 1:4] = m.emission[mid]
    out[:n, 4:7] = m.color[mid]
    out[:n, 7] = m.roughness[mid]
    out[:n, 8] = m.metallic[mid]
    out[:n, 9] = m.ior[mid]
    out[:n, 10:13] = m.scattering[mid]
    out[:n, 13] = m.scanisotropy[mid]
    out[:n, 14] = m.trdepth[mid]
    out[:n, 15] = m.opacity[mid]
    out[:n, 16] = m.emission_tex[mid]
    out[:n, 17] = m.color_tex[mid]
    out[:n, 18] = m.roughness_tex[mid]
    out[:n, 19] = m.scattering_tex[mid]
    out[:n, 20] = m.normal_tex[mid]
    return out


# expansion thresholds for automatic two-level instancing (the same rule
# as the JAX package: flattening both huge AND mostly duplication)
INSTANCING_MIN_FLAT = 4_000_000
INSTANCING_MIN_RATIO = 4.0


def _should_instance(scene_data) -> bool:
    shape_prims = [
        max(len(sh.quads), len(sh.triangles)) for sh in scene_data.shapes
    ]
    total = sum(shape_prims)
    flat_total = 0
    for inst in scene_data.instances:
        if 0 <= inst.shape < len(shape_prims):
            flat_total += shape_prims[inst.shape]
    return (
        flat_total >= INSTANCING_MIN_FLAT
        and total > 0
        and flat_total >= INSTANCING_MIN_RATIO * total
    )


HYBRID_MIN_INSTANCES = 1024  # below this the work-item model is cheap
HYBRID_FLAT_BUDGET = 8_000_000  # world prims the hybrid may flatten
# the hybrid flattens everything (no work items) when the whole world
# expansion is at most this many quads (the JAX package's HBM-sized cap,
# kept so that both route a scene alike)
HYBRID_FULL_FLAT_MAX = 24_000_000


def auto_hybrid_budget(flat) -> int:
    """The hybrid budget of a flatten_scene(expand_prims=False) result when
    the caller gives none: with >= HYBRID_MIN_INSTANCES instances, all of
    the world expansion (+1) when it is <= HYBRID_FULL_FLAT_MAX quads, else
    HYBRID_FLAT_BUDGET; below that, 0 (no hybrid)."""
    if flat.n_instances < HYBRID_MIN_INSTANCES:
        return 0
    g = flat.geometry
    pp = np.diff(g.shape_prim_offset).astype(np.int64)
    inst_shape = g.inst_shape[: flat.n_instances]
    valid = (inst_shape >= 0) & (inst_shape < flat.n_shapes)
    cnt = np.bincount(inst_shape[valid], minlength=flat.n_shapes)
    total_world = int((pp * cnt).sum())
    return (total_world + 1 if total_world <= HYBRID_FULL_FLAT_MAX
            else HYBRID_FLAT_BUDGET)


def _scene_fields(flat, prim_verts, prim_vidx, prim_instance, prim_flags,
                  nodes, lights_np, light_counts, n_prims, root_is_leaf):
    """(arrays, config fields) of device_scene_from_numpy, shared by the
    flat and the instanced build (the JAX package's `_assemble`)."""
    g, m, t, e = flat.geometry, flat.materials, flat.textures, flat.environments
    flags_union = (
        int(np.bitwise_or.reduce(g.prim_flags)) if len(g.prim_flags) else 0
    )
    # opacity can also come from a color texture's alpha channel
    any_tex_alpha = bool((t.data[:, 3] < 1.0).any()) if len(t.data) else False
    present = tuple(sorted(set(int(x) for x in m.type))) if len(m.type) else ()
    arrays = dict(
        prim_verts=prim_verts,
        prim_vidx=prim_vidx,
        prim_instance=prim_instance,
        prim_flags=prim_flags,
        nodes=nodes,
        vert_normals=g.vert_normals,
        vert_texcoords=g.vert_texcoords,
        vert_colors=g.vert_colors,
        inst_frame=g.inst_frame,
        inst_material=np.maximum(g.inst_material, 0),
        materials={f: getattr(m, f) for f in DeviceMaterials._fields},
        textures={f: getattr(t, f) for f in DeviceTextures._fields},
        env_frame=e.frame,
        env_frame_inv=e.frame_inv,
        env_emission=e.emission,
        env_emission_tex=e.emission_tex,
        lights=lights_np,
        inst_mat_dense=_inst_mat_dense(g, m),
    )
    config_fields = dict(
        n_prims=n_prims,
        root_is_leaf=root_is_leaf,
        n_envs=len(e.emission),
        light_counts=light_counts,
        has_normal_maps=(
            bool((m.normal_tex >= 0).any()) if len(m.normal_tex) else False
        ),
        has_opacity=(
            bool((m.opacity < 1.0).any()) if len(m.opacity) else False
        ) or any_tex_alpha,
        present_types=present,
        n_instances=flat.n_instances,
        has_textures=len(t.data) > 0,
        has_vertex_normals=bool(flags_union & FLAG_HAS_NORMALS),
        has_texcoords=bool(flags_union & FLAG_HAS_TEXCOORDS),
        has_colors=bool(flags_union & FLAG_HAS_COLORS),
        has_volumes=bool(set(present) & {4, 5, 6}),
    )
    return arrays, config_fields


def build_device_scene_instanced(scene_data, sup: int = 32,
                                 hybrid_budget: int | None = None,
                                 device=None) -> tuple[DeviceScene, SceneConfig]:
    """Two-level instanced build on `device` (None: the card): per-shape
    cluster tables in shape space + (instance, supercluster) work items
    (scene/instanced.py); the world expansion never happens.

    For many-instance scenes a hybrid build flattens the instances of
    small shapes into a world-space soup for the flat intersectors and
    keeps the big shapes as work items. `hybrid_budget` (the JAX
    package's JRT_HYBRID_BUDGET): the most world prims to flatten; None =
    `auto_hybrid_budget`; 0 = no hybrid."""
    device = resolve_device(device)
    flat = flatten_scene(scene_data, expand_prims=False)
    g = flat.geometry
    if hybrid_budget is None:
        hybrid_budget = auto_hybrid_budget(flat)
    hyb_pv = hyb_inst = hyb_remap = None
    instance_mask = None
    if hybrid_budget > 0:
        shape_mask = select_flatten_shapes(flat, hybrid_budget)
        if shape_mask.any():
            hyb_pv, hyb_inst, hyb_remap = build_world_flat(flat, shape_mask,
                                                           sup=sup)
            if len(hyb_pv):
                inst_shape = g.inst_shape[: flat.n_instances]
                flattened = shape_mask[
                    np.clip(inst_shape, 0, flat.n_shapes - 1)
                ] & (inst_shape >= 0) & (inst_shape < flat.n_shapes)
                instance_mask = ~flattened
            else:
                hyb_pv = hyb_inst = hyb_remap = None

    tables, eval_arrays = build_instanced_tables(
        scene_data, flat, sup=sup, instance_mask=instance_mask
    )

    # light table from only the emissive instances, expanded to world
    epv, epin, epfl = expand_emissive_world_prims(scene_data, flat)
    shim = SimpleNamespace(
        geometry=SimpleNamespace(
            prim_verts=epv, prim_instance=epin, prim_flags=epfl,
            inst_material=g.inst_material,
        ),
        materials=flat.materials,
        environments=flat.environments,
        textures=flat.textures,
        n_instances=flat.n_instances,
        n_shapes=flat.n_shapes,
    )
    lights_np, light_counts = build_lights_np(shim, np.arange(len(epv)))
    if light_counts.total_inst_elems > EXACT_ELEMS:
        raise AssertionError(
            "instanced scenes require the exact light-pdf sweep "
            f"({light_counts.total_inst_elems} emissive elements > {EXACT_ELEMS})"
        )

    wib = tables.wi_bbox
    lo_parts, hi_parts = [], []
    if len(wib):
        lo_parts.append(wib[:, 0:3].min(axis=0))
        hi_parts.append(wib[:, 3:6].max(axis=0))
    if hyb_pv is not None:
        lo_parts.append(hyb_pv.reshape(-1, 3).min(axis=0))
        hi_parts.append(hyb_pv.reshape(-1, 3).max(axis=0))
    world_bounds = (
        (np.min(lo_parts, axis=0), np.max(hi_parts, axis=0)) if lo_parts
        else (np.zeros(3, np.float32), np.ones(3, np.float32))
    )
    arrays, config_fields = _scene_fields(
        flat, eval_arrays["prim_verts"], eval_arrays["prim_vidx"],
        np.zeros(1, np.int32), eval_arrays["prim_flags"],
        np.zeros((1, 16), np.float32), lights_np, light_counts,
        tables.n_prims, False,
    )
    config_fields.update(
        inst_tables=tables, world_bounds=world_bounds,
        hyb_world_verts=hyb_pv, hyb_world_inst=hyb_inst, hyb_remap=hyb_remap,
    )
    return device_scene_from_numpy(arrays, config_fields, device)


def build_device_scene(scene_data, highquality_bvh: bool = False,
                       instancing: bool | None = None, device=None,
                       hybrid_budget: int | None = None,
                       ) -> tuple[DeviceScene, SceneConfig]:
    """Host SceneData -> (DeviceScene, SceneConfig) on `device` (None: the
    card): flattens, builds the BVH, reorders primitives, assembles the
    light table. Scenes whose flattening would mostly duplicate shared
    shapes take the two-level instanced build (`instancing` overrides;
    `hybrid_budget` goes to build_device_scene_instanced)."""
    device = resolve_device(device)
    if instancing is None:
        instancing = _should_instance(scene_data)
    if instancing:
        return build_device_scene_instanced(
            scene_data, hybrid_budget=hybrid_budget, device=device)
    flat = flatten_scene(scene_data)
    g = flat.geometry
    bb_min, bb_max = quad_bounds(g.prim_verts)
    tree = build_bvh(bb_min, bb_max, sah=highquality_bvh)
    order = tree.order

    def sort(a):
        return a[order] if len(order) else a

    lights_np, light_counts = build_lights_np(flat, order)
    arrays, config_fields = _scene_fields(
        flat, sort(g.prim_verts), sort(g.prim_vidx), sort(g.prim_instance),
        sort(g.prim_flags), tree.nodes, lights_np, light_counts,
        tree.n_prims, tree.root_is_leaf,
    )
    return device_scene_from_numpy(arrays, config_fields, device)


def device_scene_from_numpy(arrays: dict, config_fields: dict, device=None,
                            ) -> tuple[DeviceScene, SceneConfig]:
    """Numpy scene arrays -> (DeviceScene, SceneConfig) on `device` (None:
    the card): the upload tail shared by build_device_scene (the JAX
    package's `_assemble`) and the way to carry a JAX DeviceScene across.

    `arrays` maps each DeviceScene field to a numpy array, and `materials`,
    `textures` and `lights` to dicts of their fields: what `np.asarray` of
    each leaf of a JAX DeviceScene gives. Extra keys (the JAX package's
    line/point arrays and kernel tables) must be empty. `config_fields`
    maps SceneConfig field names to values; `light_counts` may be any
    object with LightCounts' attributes. `host_prim_verts` and
    `host_prim_instance` default to the arrays' own. An `inst_tables`
    of the JAX package's InstancedTables is copied into the port's."""
    device = resolve_device(device)
    for key, value in arrays.items():
        if key not in DeviceScene._fields and np.size(value):
            raise NotImplementedError(
                f"scene array {key} is not empty; line/point primitives "
                "are not ported yet (ROADMAP.md queue 1, item 10)"
            )

    def put(a):
        return torch.tensor(np.asarray(a), device=device)

    nested = {
        "materials": DeviceMaterials,
        "textures": DeviceTextures,
        "lights": DeviceLights,
    }
    dscene = DeviceScene(**{
        f: (
            nested[f](**{k: put(arrays[f][k]) for k in nested[f]._fields})
            if f in nested else put(arrays[f])
        )
        for f in DeviceScene._fields
    })
    fields = {k: v for k, v in config_fields.items() if k in SceneConfig._fields}
    lc = fields["light_counts"]
    fields["light_counts"] = LightCounts(**{
        f.name: int(getattr(lc, f.name)) for f in dataclasses.fields(LightCounts)
    })
    fields["present_types"] = tuple(int(x) for x in fields["present_types"])
    if fields.get("host_prim_verts") is None:
        fields["host_prim_verts"] = np.asarray(arrays["prim_verts"])
    if fields.get("host_prim_instance") is None:
        fields["host_prim_instance"] = np.asarray(arrays["prim_instance"])
    tb = fields.get("inst_tables")
    if tb is not None and not isinstance(tb, InstancedTables):
        fields["inst_tables"] = InstancedTables(**{
            f.name: getattr(tb, f.name)
            for f in dataclasses.fields(InstancedTables)
        })
    config = SceneConfig(**fields)
    if config.n_lines or config.n_points:
        raise NotImplementedError(
            "line/point primitives are not ported yet (ROADMAP.md queue 1, "
            "item 10)"
        )
    return dscene, config
