"""The port's instanced-scene path rendered, against the JAX package's on
the CPU: trace_wavefront on the instanced scene, the hybrid and pure
builds against each other, a JAX instanced scene carried across through
device_scene_from_numpy, and instanced normal maps.

The scene is tests/test_instanced.py's (torch_parity.instanced_test_scene:
two random triangle soups, five rotated and scaled instances), with an
emissive instance and an environment. Tolerances: renders within
rtol/atol 2e-3, as the JAX package's own hybrid render test; shading
normals within rtol 1e-4, atol 1e-5 (float32, the same formulas)."""

import jax.numpy as jnp
import numpy as np
import torch

from julia_raytracer_tpu.ops import eval as jeval
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import scene_device as jsd
from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.ops import eval as teval
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import scene_device as tsd
from julia_raytracer_tpu_torch.scene import instanced as tinst
from julia_raytracer_tpu_torch.scene.types import TextureData
from julia_raytracer_tpu_torch.utils import rng as trng
from torch_parity import (
    INSTANCED_N_RAYS as N_RAYS, instanced_test_rays, instanced_test_scene,
    jax_config_fields, jax_scene_arrays, to_jax_scene,
)

BOUNCES = 3


def _trace(d, cfg, rays, intersect=None):
    ro, rd = (torch.from_numpy(x) for x in rays[:2])
    rng = trng.seed_state(torch.arange(N_RAYS, dtype=torch.int32), 0, 0)
    return tint.trace_wavefront(
        d, cfg, tint.TraceOptions(sampler="path", bounces=BOUNCES), ro, rd,
        rng, intersector=intersect)


def test_trace_wavefront_instanced_matches_jax():
    """trace_wavefront on the instanced scene (environment + an emissive
    instance, 3 bounces) against the JAX package's, both through their
    plain reference intersectors."""
    s = instanced_test_scene(emissive=True, env=True)
    d, cfg = tsd.build_device_scene(s, instancing=True, device="cpu")
    dj, cfg_j = jsd.build_device_scene(to_jax_scene(s), instancing=True)
    rays = instanced_test_rays()
    rng = jrng.seed_state(jnp.arange(N_RAYS, dtype=jnp.int32), jnp.int32(0), 0)
    want = jint.trace_wavefront(
        dj, cfg_j, jint.TraceOptions(sampler="path", bounces=BOUNCES),
        jnp.asarray(rays[0]), jnp.asarray(rays[1]), rng,
        intersect=jint.make_intersect(dj, cfg_j))
    got = _trace(d, cfg, rays, tint.make_intersect(d, cfg))
    rad = got[0].numpy()
    assert np.isfinite(rad).all() and rad.max() > 0
    np.testing.assert_allclose(rad, np.asarray(want[0]), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the routed intersector (the work-item plain version) renders alike
    np.testing.assert_allclose(_trace(d, cfg, rays)[0].numpy(), rad,
                               rtol=2e-3, atol=2e-3)


def test_hybrid_and_pure_render_alike():
    s = instanced_test_scene(emissive=True, env=True)
    rays = instanced_test_rays()
    images = []
    for budget in (0, 60):
        d, cfg = tsd.build_device_scene_instanced(s, hybrid_budget=budget,
                                                  device="cpu")
        assert (cfg.hyb_world_verts is None) == (budget == 0)
        images.append(_trace(d, cfg, rays)[0].numpy())
    np.testing.assert_allclose(images[0], images[1], rtol=2e-3, atol=2e-3)


def test_jax_scene_carried_across_renders_alike():
    """A JAX instanced DeviceScene through device_scene_from_numpy renders
    like the port's own build (the hybrid at budget 60)."""
    s = instanced_test_scene(emissive=True, env=True)
    dj, cfg_j = jsd.build_device_scene_instanced(to_jax_scene(s),
                                                 hybrid_budget=60)
    dc, cfg_c = tsd.device_scene_from_numpy(
        jax_scene_arrays(dj), jax_config_fields(cfg_j), device="cpu")
    assert isinstance(cfg_c.inst_tables, tinst.InstancedTables)
    d, cfg = tsd.build_device_scene_instanced(s, hybrid_budget=60, device="cpu")
    rays = instanced_test_rays()
    np.testing.assert_allclose(_trace(dc, cfg_c, rays)[0].numpy(),
                               _trace(d, cfg, rays)[0].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_instanced_normal_map_matches_jax():
    """eval_shading_normal(..., instanced=True): shape-space tangents
    rotated by the instance frame, against the JAX package's."""
    s = instanced_test_scene()
    g = np.random.default_rng(21)
    s.textures = [TextureData(width=4, height=4,
                              pixels=g.random((16, 4), dtype=np.float32))]
    s.materials[0].normal_tex = 0
    for shape in s.shapes:
        shape.texcoords = g.random((len(shape.positions), 2), dtype=np.float32)
    dj, cfg_j = jsd.build_device_scene_instanced(to_jax_scene(s))
    d, cfg = tsd.device_scene_from_numpy(jax_scene_arrays(dj),
                                         jax_config_fields(cfg_j), device="cpu")
    assert cfg.has_normal_maps and cfg.has_texcoords
    n = 512
    hp = np.flatnonzero(np.abs(np.asarray(dj.prim_verts)).sum(axis=(1, 2)) > 0)
    prim = g.choice(hp, n).astype(np.int32)
    inst = g.integers(0, cfg.n_instances, n).astype(np.int32)
    u, v = g.random(n, dtype=np.float32), g.random(n, dtype=np.float32)
    out = g.normal(size=(n, 3)).astype(np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    gn = g.normal(size=(n, 3)).astype(np.float32)
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    mtype = np.zeros(n, np.int32)
    ntex = np.zeros(n, np.int32)
    args = dict(prim=prim, inst=inst, u=u, v=v, out=out, gn=gn, mtype=mtype,
                ntex=ntex)
    J = {k: jnp.asarray(x) for k, x in args.items()}
    T = {k: torch.from_numpy(x) for k, x in args.items()}
    jverts, jvidx, _, jflags = jeval.gather_prim(
        dj._replace(prim_instance=jnp.zeros(cfg.n_prims, jnp.int32)), J["prim"])
    # the instanced prim_instance is a 1-element placeholder that no prim id
    # may index, so the rest of the prim's data is gathered here
    tverts, tvidx, tflags = (x[T["prim"]] for x in (d.prim_verts, d.prim_vidx,
                                                     d.prim_flags))
    jtc = jeval.eval_texcoord(dj, jvidx, jflags, J["u"], J["v"])
    ttc = teval.eval_texcoord(d, tvidx, tflags, T["u"], T["v"])
    want = jeval.eval_shading_normal(
        dj, J["gn"], jverts, jvidx, J["inst"], jflags, J["u"], J["v"],
        J["out"], J["mtype"], J["ntex"], jtc, instanced=True)
    got = teval.eval_shading_normal(
        d, T["gn"], tverts, tvidx, T["inst"], tflags, T["u"], T["v"],
        T["out"], T["mtype"], T["ntex"], ttc, instanced=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    flat = teval.eval_shading_normal(
        d, T["gn"], tverts, tvidx, T["inst"], tflags, T["u"], T["v"],
        T["out"], T["mtype"], T["ntex"], ttc, instanced=False)
    assert not torch.allclose(flat, got, atol=1e-3)  # the rotation matters
