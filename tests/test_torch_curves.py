"""Line and point (capsule) primitives in the port against the JAX
package, on testing.hairball_scene(): 400 single-segment hairs (the JAX
package's tests/test_curves.py hairball in the Cornell box) and a
polyline ball (3 segments a hair, so line_attr interpolates along each
hair), each with radius-points.

  - flatten_scene's line and point arrays bit-equal to the JAX
    package's, and empty with expand_prims=False in both;
  - build_device_scene's fields and counts equal to the JAX package's;
  - curve_wrap hits against the JAX package's make_intersect
    (testing.check_hits: the tolerances of tests/test_pallas_kernels.py),
    chunked or not, and with no quads at all;
  - a 32 x 32, 3-bounce render against the JAX trace_wavefront
    (testing.image_close: mean within 1e-3 relative, >= 99% of pixels
    within 1e-3);
  - the regroup intersector keeps its `primary` (the worklist) under
    the wrap;
  - the fixed-trip loop over curves: its render equals the while loop's
    bit for bit, and its colour gradient meets jax.grad of the JAX
    make_param_loss within testing.GRAD_TOL."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.camera import sample_camera as jax_sample_camera
from julia_raytracer_tpu.render import diff as jdiff
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.render.scene_device import (
    build_device_scene as jax_build_device_scene,
)
from julia_raytracer_tpu.scene.flatten import flatten_scene as jax_flatten
from julia_raytracer_tpu.utils import rng as jrng
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import diff as tdiff
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render.scene_device import (
    CURVE_FIELDS, build_device_scene, device_scene_from_numpy,
)
from julia_raytracer_tpu_torch.scene.flatten import flatten_scene
from julia_raytracer_tpu_torch.scene.types import (
    EnvironmentData, InstanceData,
)
from julia_raytracer_tpu_torch.testing import (
    HAIR_CENTER, check_hits, grads_close, hairball_scene, image_close,
    uv_sphere,
)
from torch_parity import jax_config_fields, jax_scene_arrays, to_jax_scene

SCENES = {
    "hairs_400": lambda: hairball_scene(400, 1, 24),
    "polyline": lambda: hairball_scene(160, 3, 24),
}
RES, BOUNCES = 32, 3  # the render
GRAD_RES, GRAD_BOUNCES = 12, 3  # the gradient


@pytest.fixture(params=sorted(SCENES), scope="module")
def scene(request):
    return SCENES[request.param]()


@pytest.fixture(scope="module")
def built(scene):
    """The JAX DeviceScene and the port's, carried across from it."""
    dj, cj = jax_build_device_scene(to_jax_scene(scene))
    dt, ct = device_scene_from_numpy(jax_scene_arrays(dj),
                                     jax_config_fields(cj), device="cpu")
    return dj, cj, dt, ct


def _rays(n=3000, seed=0):
    """Rays from the camera at the hair ball (and past it)."""
    g = np.random.default_rng(seed)
    ro = np.tile(np.float32([0.0, 1.0, 3.9]), (n, 1))
    rd = np.asarray(HAIR_CENTER) + g.normal(0, 0.4, (n, 3)) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd, np.full(n, 1e-4, np.float32), np.full(n, 3.4e38, np.float32)


def test_flatten_arrays_match_jax(scene):
    want = jax_flatten(to_jax_scene(scene)).geometry
    got = flatten_scene(scene).geometry
    assert len(got.line_verts) and len(got.point_pos)
    for name in CURVE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # polylines: each hair's ends carry different texcoords and colours
    la = got.line_attr
    assert (la[:, 0, 3:9] != la[:, 1, 3:9]).any(axis=1).all()
    # the instanced mode leaves them empty, as the JAX package does
    want = jax_flatten(to_jax_scene(scene), expand_prims=False).geometry
    got = flatten_scene(scene, expand_prims=False).geometry
    for name in CURVE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype and len(a) == 0, name


def test_device_scene_matches_jax(scene, built):
    dj, cj, dt, ct = built
    d, c = build_device_scene(scene, device="cpu")
    assert (c.n_lines, c.n_points) == (cj.n_lines, cj.n_points)
    assert (ct.n_lines, ct.n_points) == (cj.n_lines, cj.n_points)
    for name in CURVE_FIELDS:
        np.testing.assert_array_equal(getattr(d, name).numpy(),
                                      np.asarray(getattr(dj, name)))
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      np.asarray(getattr(dj, name)))
    # a scene without curves carries empty-shaped arrays
    d0, c0 = build_device_scene(hairball_scene(0, 1, 0), device="cpu")
    assert (c0.n_lines, c0.n_points) == (0, 0)
    assert tuple(d0.line_attr.shape) == (0, 2, 9)
    assert tuple(d0.point_attr.shape) == (0, 9)


def test_curve_wrap_hits_match_jax(built):
    dj, cj, dt, ct = built
    rays = _rays()
    want = jint.make_intersect(dj, cj)(*(jnp.asarray(x) for x in rays))
    got = tint.make_intersect(dt, ct)(*(torch.from_numpy(x) for x in rays))
    q = dt.prim_verts.shape[0]
    prim = got.prim.numpy()
    assert ((prim >= q) & (prim < q + ct.n_lines)).mean() > 0.1  # lines
    assert (prim >= q + ct.n_lines).any()  # points
    check_hits(want, got)
    np.testing.assert_array_equal(prim, np.asarray(want.prim))


def test_chunked_sweep_equals_one_chunk(built, monkeypatch):
    """Lines and points swept in chunks of 7 elements give the one-chunk
    sweep's hits bit for bit (ties keep the lower element)."""
    _, _, dt, ct = built
    rays = [torch.from_numpy(x) for x in _rays(500, seed=1)]
    whole = tint.make_intersect(dt, ct)(*rays)
    monkeypatch.setitem(tint.CURVE_CHUNK, "cpu", 7 * 500)
    chunked = tint.make_intersect(dt, ct)(*rays)
    for a, b in zip(whole, chunked, strict=True):
        assert torch.equal(a, b)


def test_curves_without_quads_match_jax():
    """A scene of only lines and points (Q = 0) under an environment: the
    quad intersector is never built or called, as in the JAX package."""
    s = hairball_scene(60, 2, 12)
    s.shapes = s.shapes[-2:]
    s.instances = [InstanceData(shape=0, material=4),
                   InstanceData(shape=1, material=5)]
    s.environments = [EnvironmentData(emission=np.float32([0.8, 0.9, 1.0]))]
    dj, cj = jax_build_device_scene(to_jax_scene(s))
    dt, ct = build_device_scene(s, device="cpu")
    # no quad route: no kernel tables
    assert ct.n_prims == 0 and tint.build_intersector(dt, ct).tables is None
    _render_vs_jax(dj, cj, dt, ct, to_jax_scene(s), 16)


def _render_vs_jax(dj, cj, dt, ct, scene_j, res):
    cam = jren.camera_arrays(scene_j.cameras[0])
    n = res * res
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = jrng.seed_state(pix, jnp.int32(3), 0)
    puv, rng = jrng.rand2f(rng)
    luv, rng = jrng.rand2f(rng)
    ij = jnp.stack([pix % res, pix // res], axis=-1)
    ro, rd = jax_sample_camera(cam, ij, (res, res), puv, luv, False)
    want = jax.jit(lambda ro, rd, rng: jint.trace_wavefront(
        dj, cj, jint.TraceOptions(bounces=BOUNCES), ro, rd, rng))(ro, rd, rng)
    got = tint.trace_wavefront(
        dt, ct, tint.TraceOptions(bounces=BOUNCES),
        torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
        torch.from_numpy(np.asarray(rng).view(np.int32).copy()))
    image_close(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in (2, 3):  # first-hit AOVs
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    return got


def test_render_matches_jax(scene, built):
    dj, cj, dt, ct = built
    got = _render_vs_jax(dj, cj, dt, ct, to_jax_scene(scene), RES)
    assert got[0].mean() > 0


def test_regroup_wrap_keeps_primary(scene):
    """With regroup on, the wrap routes camera rays (and the light pdf's
    march) through the regroup intersector's `primary`, the worklist
    over the same tables, each wrapped apart; the hits agree. A sphere
    of 256 quads behind the ball takes the scene past the dense
    intersector's 112."""
    scene = copy.deepcopy(scene)
    scene.shapes.append(uv_sphere(0.3, 16))
    frame = np.eye(4, 3, dtype=np.float32)
    frame[3] = (0.0, 1.0, -0.6)
    scene.instances.append(InstanceData(frame=frame,
                                        shape=len(scene.shapes) - 1,
                                        material=0))
    d, c = build_device_scene(scene, device="cpu")
    assert c.n_prims > tint.BRUTEFORCE_THRESHOLD
    isect = tint.build_intersector(d, c, regroup="on", regroup_min_prims=0)
    assert isect.livegate == rg.DEF_LIVEGATE
    assert isinstance(isect.tables, wl.WorklistTables)
    assert isect.primary is not isect.hit
    rays = [torch.from_numpy(x) for x in _rays(800, seed=2)]
    a, b = isect(*rays), isect.primary(*rays)
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)
    assert (a.prim >= c.n_prims).any()


def test_fixed_trip_equals_while_loop(scene):
    r = tren.Renderer(scene, tren.Params(resolution=16, bounces=BOUNCES),
                      device="cpu")
    args = (r.cam_arrays, 16, 16, torch.arange(256, dtype=torch.int32), 0)
    with torch.no_grad():
        want = tdiff.render_radiance(r.dscene, r.config, r.options, *args)
        got = tdiff.render_radiance(
            r.dscene, r.config, tdiff.diff_options(r.options, r.config), *args)
    assert torch.equal(got, want) and want.mean() > 0


def test_fixed_trip_color_grads_match_jax(scene):
    """The diff wrapper sits on the quad intersector inside curve_wrap (a
    curve hit's prim id names no quad), and the sweep differentiates as
    it is: colour and emission gradients of the pixel loss against
    jax.grad of the JAX package's make_param_loss."""
    tr = tren.Renderer(scene, tren.Params(resolution=GRAD_RES,
                                          bounces=GRAD_BOUNCES), device="cpu")
    jr = jren.Renderer(to_jax_scene(scene), jren.Params(
        resolution=GRAD_RES, samples=1, bounces=GRAD_BOUNCES, sampler="path"))
    n = GRAD_RES * GRAD_RES
    target = np.random.default_rng(4).uniform(0.0, 0.5, (n, 3)).astype(
        np.float32)
    loss = jdiff.make_param_loss(jr.dscene, jr.config, jr.options,
                                 jr.cam_arrays, GRAD_RES, GRAD_RES)
    value_j, (gc_j, ge_j) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1)), static_argnums=(4,))(
        jr.dscene.materials.color, jr.dscene.materials.emission,
        jnp.arange(n, dtype=jnp.int32), jnp.asarray(target), 1)
    loss_t = tdiff.make_param_loss(tr.dscene, tr.config, tr.options,
                                   tr.cam_arrays, GRAD_RES, GRAD_RES)
    c = tr.dscene.materials.color.clone().requires_grad_()
    e = tr.dscene.materials.emission.clone().requires_grad_()
    value = loss_t(c, e, torch.arange(n, dtype=torch.int32),
                   torch.as_tensor(target), 1)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(value_j),
                               rtol=1e-4)
    grads_close(c.grad, np.asarray(gc_j))
    grads_close(e.grad, np.asarray(ge_j))
    hair_mat = scene.instances[-2].material
    assert c.grad[hair_mat].abs().sum() > 0  # the hairs' colour

