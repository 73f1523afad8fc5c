"""The truncated-march light pdf of scenes with more than EXACT_ELEMS
(4,096) emissive elements, in the port against the JAX package, on
testing.many_lights_scene((64, 65)): 4,160 emissive quads, over the real
threshold (nothing is patched).

  - area_light_hit_pdf, both ways of finding a hit's owner (the
    compare-select over <= DENSE_ELEMS elements and the clamped gather),
    and auto_light_pdf_steps: equal to the JAX functions (rtol 1e-6);
  - the march branch of sample_lights_pdf on the same rays and the same
    first hits, each package marching through its own intersect_bvh over
    the same nodes: rtol 1e-4 (atol 1e-6);
  - an 8 x 8, 2-bounce render against the JAX trace_wavefront
    (testing.image_close);
  - Params.light_pdf_extra_steps = -1 picks the JAX Renderer's steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.camera import sample_camera as jax_sample_camera
from julia_raytracer_tpu.ops.traversal import Hit as JHit
from julia_raytracer_tpu.ops.traversal import intersect_bvh as jax_bvh
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import lights as jlights
from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.render.scene_device import (
    build_device_scene as jax_build_device_scene,
)
from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.ops.traversal import Hit, intersect_bvh
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import lights as tlights
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render.scene_device import device_scene_from_numpy
from julia_raytracer_tpu_torch.scene.types import MaterialData, MaterialType
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, image_close, many_lights_scene,
)
from julia_raytracer_tpu_torch.utils import timing
from torch_parity import jax_config_fields, jax_scene_arrays, to_jax_scene

PANEL = (64, 65)  # 4,160 emissive quads
N_RAYS = 512


@pytest.fixture(scope="module")
def lights_scene():
    scene = many_lights_scene(PANEL)
    dj, cj = jax_build_device_scene(to_jax_scene(scene))
    dt, ct = device_scene_from_numpy(jax_scene_arrays(dj),
                                     jax_config_fields(cj), device="cpu")
    assert ct.light_counts.total_inst_elems == PANEL[0] * PANEL[1]
    assert ct.light_counts.total_inst_elems > tlights.EXACT_ELEMS
    return scene, dj, cj, dt, ct


def test_auto_light_pdf_steps_matches_jax():
    for n in range(0, 10):
        for trans in (False, True):
            assert (tlights.auto_light_pdf_steps(n, trans)
                    == jlights.auto_light_pdf_steps(n, trans))


def _hit_pdf_inputs(g, q, n=N_RAYS):
    prim = g.integers(-2, q + 40, n).astype(np.int32)  # ids past Q clamp
    dist2 = g.uniform(0.0, 9.0, n).astype(np.float32)
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit = g.random(n) < 0.8
    return prim, dist2, nrm, d, hit


@pytest.mark.parametrize("which", ["compare_select", "gather"])
def test_area_light_hit_pdf_matches_jax(which, lights_scene):
    if which == "gather":
        _, dj, cj, dt, ct = lights_scene
    else:
        dj, cj = jax_build_device_scene(to_jax_scene(cornell_scene()))
        dt, ct = device_scene_from_numpy(jax_scene_arrays(dj),
                                         jax_config_fields(cj), device="cpu")
    elems = ct.light_counts.total_inst_elems
    assert (0 < elems <= tlights.DENSE_ELEMS) == (which == "compare_select")
    g = np.random.default_rng(3)
    q = dt.prim_verts.shape[0]
    args = _hit_pdf_inputs(g, q)
    # a third of the lanes hit a light element
    lit = dt.lights.inst_prim.numpy()[:elems]
    args[0][::3] = lit[g.integers(0, elems, len(args[0][::3]))]
    want = jlights.area_light_hit_pdf(dj.lights, *(jnp.asarray(a) for a in args),
                                      total_elems=elems)
    got = tlights.area_light_hit_pdf(dt.lights, *(torch.from_numpy(a) for a in args),
                                     total_elems=elems)
    assert (got > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _march_rays(g, n=N_RAYS):
    """Rays from points in the room up at the panel (most) and anywhere."""
    ro = g.uniform([-0.8, 0.05, -0.8], [0.8, 1.6, 0.8], (n, 3)).astype(np.float32)
    target = np.stack([g.uniform(-0.55, 0.55, n), np.full(n, 2.5),
                       g.uniform(-0.45, 0.45, n)], axis=1)
    rd = target - ro
    rd[::4] = g.normal(size=(len(rd[::4]), 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("steps", [0, 2, 4])
def test_march_matches_jax(steps, lights_scene):
    """Both packages march the same rays from the same first hit (the JAX
    intersect_bvh's), each through its own intersect_bvh."""
    _, dj, cj, dt, ct = lights_scene
    g = np.random.default_rng(steps)
    ro, rd = _march_rays(g)
    n = len(ro)
    first = jax_bvh(dj.nodes, dj.prim_verts, jnp.asarray(ro), jnp.asarray(rd),
                    jnp.full(n, 1e-4), jnp.full(n, 3.4e38),
                    prim_instance=dj.prim_instance)

    def jax_fn(o, d, tmin, tmax):
        return jax_bvh(dj.nodes, dj.prim_verts, o, d, tmin, tmax,
                       prim_instance=dj.prim_instance)

    def port_fn(o, d, tmin, tmax):
        return intersect_bvh(dt.nodes, dt.prim_verts, o, d, tmin, tmax,
                             prim_instance=dt.prim_instance)

    want = jlights.sample_lights_pdf(dj, dj.lights, cj.light_counts, jax_fn,
                                     jnp.asarray(ro), jnp.asarray(rd), first,
                                     extra_steps=steps)
    got = tlights.sample_lights_pdf(
        dt, dt.lights, ct.light_counts, torch.from_numpy(ro),
        torch.from_numpy(rd), intersect_fn=port_fn,
        first_hit=Hit(*(torch.from_numpy(np.array(x)) for x in first)),
        extra_steps=steps)
    assert (got > 0).float().mean() > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    assert isinstance(first, JHit)


def test_march_steps_add_to_the_pdf(lights_scene):
    """More steps cross more panel quads behind the first (the panel's
    gaps let rays through at a slant): the pdf never falls, and rises
    somewhere. Without an intersector the march refuses."""
    _, _, _, dt, ct = lights_scene
    ro, rd = (torch.from_numpy(x) for x in _march_rays(np.random.default_rng(8)))
    n = ro.shape[0]

    def fn(o, d, tmin, tmax):
        return intersect_bvh(dt.nodes, dt.prim_verts, o, d, tmin, tmax,
                             prim_instance=dt.prim_instance)

    first = fn(ro, rd, torch.full((n,), 1e-4), torch.full((n,), 3.4e38))
    pdfs = [tlights.sample_lights_pdf(dt, dt.lights, ct.light_counts, ro, rd,
                                      intersect_fn=fn, first_hit=first,
                                      extra_steps=k) for k in (0, 1, 4)]
    assert (pdfs[1] >= pdfs[0]).all() and (pdfs[2] >= pdfs[1]).all()
    assert (pdfs[2] > pdfs[0]).any()
    with pytest.raises(ValueError, match="march"):
        tlights.sample_lights_pdf(dt, dt.lights, ct.light_counts, ro, rd)


def test_render_matches_jax(lights_scene):
    scene, dj, cj, dt, ct = lights_scene
    res, steps = 8, 4
    cam = jren.camera_arrays(to_jax_scene(scene).cameras[0])
    n = res * res
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = jrng.seed_state(pix, jnp.int32(3), 0)
    puv, rng = jrng.rand2f(rng)
    luv, rng = jrng.rand2f(rng)
    ij = jnp.stack([pix % res, pix // res], axis=-1)
    ro, rd = jax_sample_camera(cam, ij, (res, res), puv, luv, False)
    want = jax.jit(lambda ro, rd, rng: jint.trace_wavefront(
        dj, cj, jint.TraceOptions(bounces=2, light_pdf_extra_steps=steps),
        ro, rd, rng))(ro, rd, rng)
    with timing.span("frame"):
        got = tint.trace_wavefront(
            dt, ct, tint.TraceOptions(bounces=2, light_pdf_extra_steps=steps),
            torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
            torch.from_numpy(np.asarray(rng).view(np.int32).copy()))
    assert timing.units()[-1]["table"]["frame/wavefront/body"]["n"] > 0
    image_close(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].mean() > 0


@pytest.mark.parametrize("variant", ["auto", "auto_glass", "fixed_3"])
def test_renderer_steps_match_jax(variant):
    """Params.light_pdf_extra_steps: -1 lets auto_light_pdf_steps choose
    over the light count and the transmissive types, as the JAX Renderer
    does; a value >= 0 is taken as it is."""
    scene = many_lights_scene((8, 8))
    if variant == "auto_glass":
        scene.materials[5] = MaterialData(type=MaterialType.REFRACTIVE,
                                          color=np.float32([0.9, 0.9, 0.9]))
    steps = 3 if variant == "fixed_3" else -1
    tr = tren.Renderer(scene, tren.Params(resolution=8, bounces=2,
                                          light_pdf_extra_steps=steps),
                       device="cpu")
    jr = jren.Renderer(to_jax_scene(scene), jren.Params(
        resolution=8, samples=1, bounces=2, light_pdf_extra_steps=steps))
    assert (tr.options.light_pdf_extra_steps
            == jr.options.light_pdf_extra_steps)
    assert tr.options.light_pdf_extra_steps == {
        "auto": 4, "auto_glass": 8, "fixed_3": 3}[variant]
