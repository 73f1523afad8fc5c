"""Helpers shared by the tests/test_torch_*.py parity tests: the JAX
package's SceneData mirrors of the port's in-code scenes (the Cornell box
and the sphere grid), and the JAX DeviceScene -> numpy conversion that
feeds the port's device_scene_from_numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from julia_raytracer_tpu.scene import types as jt
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
