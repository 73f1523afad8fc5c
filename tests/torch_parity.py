"""Helpers shared by the tests/test_torch_*.py parity tests: the JAX
package's SceneData mirrors of the port's in-code scenes (the Cornell box
and the sphere grid), the JAX DeviceScene -> numpy conversion that feeds
the port's device_scene_from_numpy, and the small instanced scene and
rays of the instanced-path tests."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from julia_raytracer_tpu.scene import types as jt
from julia_raytracer_tpu_torch.scene.types import (
    CameraData, EnvironmentData, InstanceData, MaterialData, SceneData,
    ShapeData,
)
from julia_raytracer_tpu_torch.testing import cornell_scene, sphere_grid_scene

# The suite runs several pytest-xdist workers on a few cores, beside
# JAX's own thread pools; PyTorch's default of one intra-op thread per
# core oversubscribes the machine and slows every file. Every worker
# imports this module while it collects the torch tests.
torch.set_num_threads(2)


def _mirror(obj, cls, **overrides):
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    fields.update(overrides)
    return cls(**fields)


def to_jax_scene(s) -> jt.SceneData:
    """A port SceneData as the JAX package's SceneData, field for field."""
    return jt.SceneData(
        cameras=[_mirror(c, jt.CameraData) for c in s.cameras],
        instances=[_mirror(i, jt.InstanceData) for i in s.instances],
        environments=[_mirror(e, jt.EnvironmentData) for e in s.environments],
        shapes=[_mirror(sh, jt.ShapeData) for sh in s.shapes],
        textures=[_mirror(t, jt.TextureData) for t in s.textures],
        materials=[
            _mirror(m, jt.MaterialData, type=jt.MaterialType(int(m.type)))
            for m in s.materials
        ],
        subdivs=[_mirror(d, jt.SubdivData) for d in s.subdivs],
    )


def cornell_scene_jax() -> jt.SceneData:
    """The port's cornell_scene() as the JAX package's SceneData."""
    return to_jax_scene(cornell_scene())


def sphere_grid_scene_jax(grid: int = 5, segments: int = 64) -> jt.SceneData:
    """The port's sphere_grid_scene() as the JAX package's SceneData."""
    return to_jax_scene(sphere_grid_scene(grid, segments))


def jax_scene_arrays(dscene) -> dict:
    """np.asarray of every leaf of a JAX DeviceScene (nested tuples as
    dicts), the input format of device_scene_from_numpy."""
    out = {}
    for name, value in dscene._asdict().items():
        if hasattr(value, "_asdict"):
            out[name] = {k: np.asarray(v) for k, v in value._asdict().items()}
        elif isinstance(value, tuple):
            out[name] = value
        else:
            out[name] = np.asarray(value)
    return out


def jax_config_fields(config) -> dict:
    return dict(config._asdict())


# size of the end-to-end parity renders (test_torch_slice/wavefront.py)
RES, BOUNCES = 32, 4


def icosphere_like(rng, n_tris=40, scale=1.0) -> ShapeData:
    """Random closed-ish triangle soup around the origin (the port's copy
    of tests/test_instanced.py's _icosphere_like)."""
    base = rng.normal(size=(n_tris, 3)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
    pos = np.concatenate([base * scale, base * scale + e1, base * scale + e2])
    tris = np.stack(
        [np.arange(n_tris), n_tris + np.arange(n_tris),
         2 * n_tris + np.arange(n_tris)], axis=1,
    ).astype(np.int32)
    return ShapeData(triangles=tris, positions=pos)


def frame(rot_deg, translate, scale=1.0) -> np.ndarray:
    """A [4, 3] instance frame: rotation about +y times `scale`, then
    `translate`."""
    th = np.deg2rad(rot_deg)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32) * scale
    f = np.zeros((4, 3), np.float32)
    f[:3] = rot
    f[3] = translate
    return f


def instanced_test_scene(emissive=False, env=False) -> SceneData:
    """tests/test_instanced.py's scene in the port's types: two random
    triangle soups, five rotated and scaled instances. `emissive` makes
    the fourth instance a light, `env` adds a white environment."""
    rng = np.random.default_rng(7)
    shapes = [icosphere_like(rng, 40, 1.0), icosphere_like(rng, 25, 0.6)]
    mats = [MaterialData(color=np.array([0.7, 0.7, 0.7], np.float32)),
            MaterialData(emission=np.array([4.0, 3.0, 2.0], np.float32))]
    light = 1 if emissive else 0
    instances = [
        InstanceData(frame=frame(0, [0, 0, 0]), shape=0, material=0),
        InstanceData(frame=frame(40, [2.5, 0, 0]), shape=0, material=0),
        InstanceData(frame=frame(-70, [-2.5, 0.5, 0]), shape=1, material=0),
        InstanceData(frame=frame(120, [0, 2.5, -1], scale=1.4), shape=1,
                     material=light),
        InstanceData(frame=frame(200, [1.5, -2.0, 1], scale=0.7), shape=0,
                     material=0),
    ]
    envs = ([EnvironmentData(emission=np.array([1.0, 1.0, 1.0], np.float32))]
            if env else [])
    return SceneData(cameras=[CameraData()], shapes=shapes, materials=mats,
                     instances=instances, environments=envs)


INSTANCED_N_RAYS = 2048


def instanced_test_rays() -> list[np.ndarray]:
    """[ro, rd, tmin, tmax] of 2,048 rays from (0, 0, 8) towards the
    instanced test scene, every ninth lane dead (tmax = -1)."""
    n = INSTANCED_N_RAYS
    rng = np.random.default_rng(7)
    ro = np.tile([0.0, 0.0, 8.0], (n, 1)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 3.4e38, np.float32)
    tmax[::9] = -1.0  # dead lanes, as the integrator sends them
    return [ro, rd, tmin, tmax]
