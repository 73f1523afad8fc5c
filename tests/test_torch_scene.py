"""The port's host-side scene pipeline builds the same arrays as the JAX
package's: the port's own copy of the BVH builder (same `order` and
`nodes`), flatten_scene, the BVH-sorted prim arrays and build_lights_np
on the in-code Cornell box and sphere grid; device_scene_from_numpy
round-trips a JAX DeviceScene, line arrays included."""

import dataclasses

import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops import bvh as jbvh
from julia_raytracer_tpu.render import lights as jlights
from julia_raytracer_tpu.render.scene_device import (
    build_device_scene as jax_build_device_scene,
)
from julia_raytracer_tpu.scene.flatten import flatten_scene as jax_flatten
from julia_raytracer_tpu_torch.ops import bvh as tbvh
from julia_raytracer_tpu_torch.render import lights as tlights
from julia_raytracer_tpu_torch.render.scene_device import (
    build_device_scene, device_scene_from_numpy,
)
from julia_raytracer_tpu_torch.scene.flatten import flatten_scene
from julia_raytracer_tpu_torch.scene.types import InstanceData, ShapeData
from julia_raytracer_tpu_torch.testing import cornell_scene, sphere_grid_scene
from torch_parity import (
    cornell_scene_jax, jax_config_fields, jax_scene_arrays, sphere_grid_scene_jax,
)

SCENES = {
    "cornell": (cornell_scene, cornell_scene_jax),
    "spheres": (lambda: sphere_grid_scene(2, 16),
                lambda: sphere_grid_scene_jax(2, 16)),
}


def _assert_same_dataclass(got, want, skip=()):
    for f in dataclasses.fields(got):
        if f.name in skip:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            _assert_same_dataclass(g, w)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f.name)


def test_cornell_mirror_and_flatten_equal():
    """The JAX mirror of cornell_scene() flattens to the same arrays."""
    got = flatten_scene(cornell_scene())
    want = jax_flatten(cornell_scene_jax())
    _assert_same_dataclass(got, want)
    assert got.geometry.prim_verts.shape == (18, 4, 3)


@pytest.mark.parametrize("sah", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_bvh_equals_jax_bvh(scene, sah):
    """The port's ops/bvh.py copy gives the JAX builder's leaf order and
    nodes, which decide prim ids and cluster membership."""
    verts = flatten_scene(SCENES[scene][0]()).geometry.prim_verts
    got = tbvh.build_bvh(*tbvh.quad_bounds(verts), sah=sah)
    want = jbvh.build_bvh(*jbvh.quad_bounds(verts), sah=sah)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.nodes.view(np.int32),
                                  want.nodes.view(np.int32))
    assert (got.n_prims, got.root_is_leaf) == (want.n_prims, want.root_is_leaf)


def test_sphere_grid_mirror_flatten_and_lights_equal():
    """sphere_grid_scene and its JAX mirror flatten to the same arrays, and
    the two light tables in BVH order are equal."""
    flat_t = flatten_scene(sphere_grid_scene(2, 16))
    flat_j = jax_flatten(sphere_grid_scene_jax(2, 16))
    _assert_same_dataclass(flat_t, flat_j)
    assert flat_t.geometry.prim_verts.shape == (4 * 16 * 16 + 6, 4, 3)
    assert flat_t.n_instances == 4 + 4
    tree = tbvh.build_bvh(*tbvh.quad_bounds(flat_t.geometry.prim_verts))
    lt, ct = tlights.build_lights_np(flat_t, tree.order)
    lj, cj = jlights.build_lights_np(flat_j, tree.order)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for k in lt:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


def test_sorted_prims_and_lights_equal():
    build_bvh, quad_bounds = tbvh.build_bvh, tbvh.quad_bounds

    flat_t = flatten_scene(cornell_scene())
    flat_j = jax_flatten(cornell_scene_jax())
    tree = build_bvh(*quad_bounds(flat_t.geometry.prim_verts))
    lt, ct = tlights.build_lights_np(flat_t, tree.order)
    lj, cj = jlights.build_lights_np(flat_j, tree.order)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert lt.keys() == lj.keys()
    for k in lt:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    assert ct.n_instance == 1 and ct.total_inst_elems == 1

    dj, cfg_j = jax_build_device_scene(cornell_scene_jax())
    dt, cfg_t = build_device_scene(cornell_scene(), device="cpu")
    arrays = jax_scene_arrays(dj)
    for name, value in dt._asdict().items():
        if isinstance(value, torch.Tensor):
            np.testing.assert_array_equal(value.numpy(), arrays[name],
                                          err_msg=name)
        else:
            for k, v in value._asdict().items():
                np.testing.assert_array_equal(v.numpy(), arrays[name][k],
                                              err_msg=f"{name}.{k}")
    for f in ("n_prims", "root_is_leaf", "n_envs", "has_normal_maps",
              "has_opacity", "present_types", "n_instances", "has_textures",
              "has_vertex_normals", "has_texcoords", "has_colors",
              "has_volumes"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f


def test_device_scene_from_numpy_round_trip():
    dj, cfg_j = jax_build_device_scene(cornell_scene_jax())
    arrays = jax_scene_arrays(dj)
    dt, cfg_t = device_scene_from_numpy(arrays, jax_config_fields(cfg_j),
                                     device="cpu")
    for name, value in dt._asdict().items():
        if isinstance(value, torch.Tensor):
            np.testing.assert_array_equal(value.numpy(), arrays[name])
            assert value.numpy().dtype == arrays[name].dtype
        else:
            for k, v in value._asdict().items():
                np.testing.assert_array_equal(v.numpy(), arrays[name][k])
    assert cfg_t.light_counts == tlights.LightCounts(**dataclasses.asdict(
        cfg_j.light_counts))
    np.testing.assert_array_equal(cfg_t.host_prim_verts, cfg_j.host_prim_verts)


def test_unported_scenes_raise():
    """Lines and points now build in both modes (the instanced build
    leaves their arrays empty, as the JAX package's does), and
    device_scene_from_numpy carries a JAX scene's line arrays; what still
    raises is a non-empty array that is no DeviceScene field."""
    s = cornell_scene()
    s.shapes.append(ShapeData(lines=np.array([[0, 1]], np.int32),
                              positions=np.zeros((2, 3), np.float32)))
    s.instances.append(InstanceData(shape=len(s.shapes) - 1, material=0))
    d, cfg = build_device_scene(s, device="cpu")
    assert (cfg.n_lines, cfg.n_points) == (1, 0)
    assert tuple(d.line_verts.shape) == (1, 2, 3)
    d, cfg = build_device_scene(s, instancing=True, device="cpu")
    assert (cfg.n_lines, tuple(d.line_verts.shape)) == (0, (0, 2, 3))
    fields = jax_config_fields(jax_build_device_scene(cornell_scene_jax())[1])
    arrays = jax_scene_arrays(jax_build_device_scene(cornell_scene_jax())[0])
    arrays["line_verts"] = np.zeros((1, 2, 3), np.float32)
    arrays["line_radius"] = np.zeros((1, 2), np.float32)
    arrays["line_instance"] = np.zeros(1, np.int32)
    arrays["line_attr"] = np.zeros((1, 2, 9), np.float32)
    _, cfg = device_scene_from_numpy(arrays, fields, device="cpu")
    assert cfg.n_lines == 1
    arrays["isec_tables"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="isec_tables"):
        device_scene_from_numpy(arrays, fields, device="cpu")
