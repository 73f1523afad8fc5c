"""The port's differentiable path (render/diff.py, the fixed-trip loop of
render/integrator.py, ops/diff_hit.py) against the JAX package's, on the
CPU at small sizes, the inputs made in code from seeded numpy:

  - the fixed-trip render equals the while-loop render bit for bit
    (tests/test_diff.py:31), and reads dscene.materials, not the folded
    per-instance rows (the JAX package's integrator.py:812);
  - make_param_loss's colour and emission gradients on the Cornell box
    against jax.grad of the JAX package's make_param_loss;
  - the textured quad under a constant environment of
    tests/test_diff_extended.py: gradients with respect to texels,
    environment emission, camera frame and lens, and prim_verts (the
    straight-through re-test of the dense intersector's plain version)
    against jax.grad;
  - the port's own central finite differences and the emission
    gradient's sign (tests/test_diff.py:50-105);
  - the sphere grid through the worklist intersector's plain version:
    prim_verts gradients against jax.grad of the JAX trace_wavefront over
    its argmin-selected intersect_bruteforce (the JAX package's CPU
    make_intersect walks intersect_bvh there, a lax.while_loop, which
    reverse mode cannot differentiate);
  - the backward pass recomputes every bounce, intersector included,
    once.

JAX parity: every entry within rtol 1e-3, atol 1e-6 (the two frameworks'
CPU transcendentals differ by an ulp here and there). Finite
differences: eps 1e-2, rtol 0.05, atol 1e-5, as in the JAX package's
tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.traversal import intersect_bruteforce as j_bruteforce
from julia_raytracer_tpu.render import diff as jdiff
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.render.scene_device import build_device_scene as j_build
from julia_raytracer_tpu.utils import rng as j_rng
from julia_raytracer_tpu.ops.camera import sample_camera as j_sample_camera
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.traversal import Intersector
from julia_raytracer_tpu_torch.ops.diff_hit import (
    make_diff_intersect, retest_quad,
)
from julia_raytracer_tpu_torch.render import diff as tdiff
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render.integrator import TraceOptions
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.types import (
    CameraData, EnvironmentData, InstanceData, MaterialData, SceneData,
    ShapeData, TextureData,
)
from julia_raytracer_tpu_torch.testing import cornell_scene, sphere_grid_scene
from torch_parity import to_jax_scene

RES, BOUNCES = 16, 4  # the Cornell box's size here
LIGHT = 3  # the emissive material of testing.cornell_scene()
RTOL, ATOL = 1e-3, 1e-6  # JAX parity, per entry
FD_EPS, FD_RTOL, FD_ATOL = 1e-2, 0.05, 1e-5
EXT_RES = 12  # the textured quad's size (tests/test_diff_extended.py)


def _pix(n, lib=torch):
    return lib.arange(n, dtype=lib.int32)


@pytest.fixture(scope="module")
def cornell():
    scene = cornell_scene()
    tr = tren.Renderer(scene, tren.Params(resolution=RES, bounces=BOUNCES),
                       device="cpu")
    jr = jren.Renderer(to_jax_scene(scene),
                       jren.Params(resolution=RES, samples=1, bounces=BOUNCES,
                                   sampler="path"))
    return tr, jr


def _jax_param_grads(jr, target, n_samples):
    loss = jdiff.make_param_loss(jr.dscene, jr.config, jr.options,
                                 jr.cam_arrays, RES, RES)
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)),
                           static_argnums=(4,))(
        jr.dscene.materials.color, jr.dscene.materials.emission,
        _pix(RES * RES, jnp), jnp.asarray(target), n_samples)
    return float(value), [np.asarray(g) for g in grads]


def _port_param_grads(tr, target, n_samples):
    loss = tdiff.make_param_loss(tr.dscene, tr.config, tr.options,
                                 tr.cam_arrays, RES, RES)
    c = tr.dscene.materials.color.clone().requires_grad_()
    e = tr.dscene.materials.emission.clone().requires_grad_()
    value = loss(c, e, _pix(RES * RES), torch.as_tensor(target), n_samples)
    value.backward()
    return float(value.detach()), [c.grad.numpy(), e.grad.numpy()]


def test_fixed_trip_equals_while_loop(cornell):
    """The fixed-trip loop's body is fully masked: its render equals the
    while loop's bit for bit, with no host sync (tests/test_diff.py:31)."""
    tr, _ = cornell
    pix = _pix(RES * RES)
    args = (tr.cam_arrays, RES, RES, pix, 0)
    with torch.no_grad():
        rad_w = tdiff.render_radiance(tr.dscene, tr.config, tr.options, *args)
        syncs = tint.trace_wavefront.host_syncs
        rad_s = tdiff.render_radiance(
            tr.dscene, tr.config, tdiff.diff_options(tr.options, tr.config),
            *args)
    assert tint.trace_wavefront.host_syncs == syncs
    assert torch.equal(rad_w, rad_s)
    assert rad_w.mean() > 0


def test_fixed_trip_reads_the_material_table(cornell):
    """Cornell's 6 instances take the folded per-instance material rows in
    the while loop; the fixed-trip loop must read dscene.materials, whose
    colour and emission are the parameters (fault: with the rows, their
    gradients would be zero)."""
    tr, _ = cornell
    assert 0 < tr.config.n_instances <= 64 and not tr.config.has_textures
    poisoned = tr.dscene._replace(
        inst_mat_dense=torch.full_like(tr.dscene.inst_mat_dense, float("nan")))
    opts = tdiff.diff_options(tr.options, tr.config)
    args = (tr.config, opts, tr.cam_arrays, RES, RES, _pix(RES * RES), 0)
    with torch.no_grad():
        want = tdiff.render_radiance(tr.dscene, *args)
        got = tdiff.render_radiance(poisoned, *args)
    assert torch.equal(got, want)


def test_param_loss_grads_match_jax(cornell):
    """Colour and emission gradients of the pixel loss against jax.grad of
    the JAX package's make_param_loss: same scene, seed and samples."""
    tr, jr = cornell
    target = np.random.default_rng(4).uniform(
        0.0, 0.5, (RES * RES, 3)).astype(np.float32)
    lj, (gc_j, ge_j) = _jax_param_grads(jr, target, 2)
    lt, (gc_t, ge_t) = _port_param_grads(tr, target, 2)
    np.testing.assert_allclose(lt, lj, rtol=RTOL)
    for got, want in ((gc_t, gc_j), (ge_t, ge_j)):
        assert np.abs(got).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # every surface's colour takes a gradient, the light's emission too
    assert (np.abs(gc_t[:LIGHT]).sum(axis=1) > 0).all()
    assert np.abs(ge_t[LIGHT]).sum() > 0


@pytest.mark.parametrize("mat,chan,which", [
    (LIGHT, 1, "emission"), (0, 0, "color"), (1, 1, "color"),
    (LIGHT, 0, "emission")])
def test_grads_vs_finite_differences(cornell, mat, chan, which):
    """d loss / d emission and d loss / d colour against central finite
    differences of the same deterministic estimator (target 0, 2
    samples; tests/test_diff.py:50-89)."""
    tr, _ = cornell
    target = np.zeros((RES * RES, 3), np.float32)
    _, (gc, ge) = _port_param_grads(tr, target, 2)
    assert np.isfinite(gc).all() and np.isfinite(ge).all()
    loss = tdiff.make_param_loss(tr.dscene, tr.config, tr.options,
                                 tr.cam_arrays, RES, RES)

    def at(delta):
        c = tr.dscene.materials.color.clone()
        e = tr.dscene.materials.emission.clone()
        (c if which == "color" else e)[mat, chan] += delta
        with torch.no_grad():
            return float(loss(c, e, _pix(RES * RES), torch.as_tensor(target), 2))

    fd = (at(FD_EPS) - at(-FD_EPS)) / (2 * FD_EPS)
    ad = (gc if which == "color" else ge)[mat, chan]
    np.testing.assert_allclose(ad, fd, rtol=FD_RTOL, atol=FD_ATOL)


def test_emission_grad_direction(cornell):
    """Target = 2x the current render: more light lowers the loss, so the
    light's emission gradient is negative (tests/test_diff.py:92)."""
    tr, _ = cornell
    with torch.no_grad():
        rad = tdiff.render_radiance(
            tr.dscene, tr.config, tdiff.diff_options(tr.options, tr.config),
            tr.cam_arrays, RES, RES, _pix(RES * RES), 0)
    _, (_, ge) = _port_param_grads(tr, (2.0 * rad).numpy(), 1)
    assert ge[LIGHT].sum() < 0


def test_backward_recomputes_each_bounce_once(cornell):
    """Each fixed-trip body runs under torch.utils.checkpoint: the
    backward pass runs it again, its intersector call included, once per
    body (the camera rays' call is not in a body)."""
    tr, _ = cornell
    calls = []

    def counting(ro, rd, tmin, tmax):
        calls.append(ro.shape[0])
        return tr.intersect(ro, rd, tmin, tmax)

    opts = tdiff.diff_options(tr.options, tr.config)
    c = tr.dscene.materials.color.clone().requires_grad_()
    d = tr.dscene._replace(materials=tr.dscene.materials._replace(color=c))
    rad = tdiff.render_radiance(d, tr.config, opts, tr.cam_arrays, RES, RES,
                                _pix(RES * RES), 0,
                                intersector=Intersector(counting))
    assert len(calls) == 1 + opts.fixed_iterations
    rad.sum().backward()
    assert len(calls) == 1 + 2 * opts.fixed_iterations
    assert c.grad.abs().sum() > 0


def test_fixed_trip_camera_rays_reach_primary(cornell):
    """The fixed-trip render sends its camera rays through the
    Intersector's `primary` and its bounce rays through `hit`, as the
    while loop does (on a regroup route `primary` is the worklist)."""
    tr, _ = cornell
    calls = {"hit": [], "primary": []}

    def spy(name):
        def query(ro, rd, tmin, tmax):
            calls[name].append(ro.shape[0])
            return tr.intersect(ro, rd, tmin, tmax)
        return query

    opts = tdiff.diff_options(tr.options, tr.config)
    with torch.no_grad():
        tdiff.render_radiance(tr.dscene, tr.config, opts, tr.cam_arrays, RES,
                              RES, _pix(RES * RES), 0, intersector=Intersector(
                                  spy("hit"), spy("primary")))
    assert calls["primary"] == [RES * RES]
    assert calls["hit"] == [RES * RES] * opts.fixed_iterations


def test_diff_hit_forward_is_the_kernels():
    """make_diff_intersect returns the wrapped intersector's values bit
    for bit, and its gradient is that of the re-tested quad."""
    scene_rng = np.random.default_rng(0)
    r = tren.Renderer(cornell_scene(), tren.Params(resolution=8), device="cpu")
    n = 512
    ro = torch.tensor(np.tile([0.0, 1.0, 3.9], (n, 1)), dtype=torch.float32)
    rd = torch.tensor(scene_rng.normal(size=(n, 3)) * [0.08, 0.08, 0.02]
                      - [0.0, 0.0, 1.0], dtype=torch.float32)
    rd = (rd / rd.norm(dim=1, keepdim=True)).requires_grad_()
    tmin, tmax = torch.full((n,), 1e-4), torch.full((n,), 3.4e38)
    pv = r.dscene.prim_verts.clone().requires_grad_()
    got = make_diff_intersect(r.intersect, pv)(ro, rd, tmin, tmax)
    want = r.intersect(ro, rd.detach(), tmin, tmax)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a.detach(), b)
    assert got.hit.all()
    # the re-test's own values agree with the kernel's plain version
    u, v, t = retest_quad(pv[want.prim.long()], ro, rd, tmin, tmax,
                          want.u + want.v <= 1.0)
    for a, b in ((u, want.u), (v, want.v), (t, want.t)):
        np.testing.assert_allclose(a.detach(), b, rtol=1e-4, atol=1e-5)
    (got.t.sum() + got.position.sum()).backward()
    assert torch.isfinite(pv.grad).all() and pv.grad.abs().sum() > 0
    assert torch.isfinite(rd.grad).all() and rd.grad.abs().sum() > 0


def test_worklist_uv_follows_intersect_quad():
    """The worklist intersector's prim (best_tri // 2) and u, v (flipped
    on the second triangle) follow intersect_quad's convention, which the
    re-test relies on: u, v, t of its plain version against the re-test of
    the quad it reports, over the sphere grid."""
    r = tren.Renderer(sphere_grid_scene(2, 16), tren.Params(resolution=8),
                      device="cpu")
    assert isinstance(r.intersect.tables, wl.WorklistTables)
    g = np.random.default_rng(1)
    n = 2048
    ro = torch.tensor(np.tile([0.0, 1.0, 3.9], (n, 1)), dtype=torch.float32)
    # aimed at the four spheres (centres at x, z = +-0.72, y = 0.14)
    centre = np.array([[-0.72, 0.14, -0.72], [-0.72, 0.14, 0.72],
                       [0.72, 0.14, -0.72], [0.72, 0.14, 0.72]])
    aim = centre[np.arange(n) % 4] + g.uniform(-0.16, 0.16, (n, 3))
    rd = torch.tensor(aim, dtype=torch.float32) - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    tmin, tmax = torch.full((n,), 1e-4), torch.full((n,), 3.4e38)
    h = r.intersect(ro, rd, tmin, tmax)
    hit = h.hit
    assert hit.float().mean() > 0.9
    second = hit & (h.u + h.v > 1.0)
    assert second.any() and (hit & ~second).any()  # both triangles
    u, v, t = retest_quad(r.dscene.prim_verts[h.prim.clamp(min=0).long()],
                          ro, rd, tmin, tmax, h.u + h.v <= 1.0)
    for a, b in ((u, h.u), (v, h.v), (t, h.t)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-3, atol=2e-4)


# ---- the textured quad of tests/test_diff_extended.py ------------------


def _textured_quad_scene() -> SceneData:
    quad = ShapeData(
        quads=np.array([[0, 1, 2, 3]], np.int32),
        positions=np.array([[-2, -2, -2], [2, -2, -2], [2, 2, -2],
                            [-2, 2, -2]], np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
    )
    g = np.random.default_rng(3)
    tex = TextureData(width=4, height=4, linear=True, pixels=np.concatenate(
        [g.uniform(0.2, 0.9, (16, 3)).astype(np.float32),
         np.ones((16, 1), np.float32)], axis=1))
    return SceneData(
        cameras=[CameraData(aspect=1.0)], shapes=[quad], textures=[tex],
        materials=[MaterialData(color=np.array([0.8, 0.8, 0.8], np.float32),
                                color_tex=0)],
        instances=[InstanceData(shape=0, material=0)],
        environments=[EnvironmentData(
            emission=np.array([1.0, 0.8, 0.6], np.float32))],
    )


@pytest.fixture(scope="module")
def textured():
    scene = _textured_quad_scene()
    dscene, config = build_device_scene(scene, device="cpu")
    cam = tren.camera_arrays(scene.cameras[0], "cpu")
    opts = tdiff.diff_options(TraceOptions(sampler="path", bounces=3), config)
    jd, jc = j_build(to_jax_scene(scene))
    jcam = jren.camera_arrays(scene.cameras[0])
    jopts = jdiff.diff_options(jint.TraceOptions(sampler="path", bounces=3), jc)
    assert opts.fixed_iterations == jopts.fixed_iterations == 4
    np.testing.assert_array_equal(dscene.prim_verts.numpy(),
                                  np.asarray(jd.prim_verts))
    return (dscene, config, cam, opts), (jd, jc, jcam, jopts)


def _swap(which, scene, cam, leaves):
    """(scene, cam) with the named leaves replaced (a NamedTuple of either
    package)."""
    if which == "texels":
        scene = scene._replace(textures=scene.textures._replace(data=leaves[0]))
    elif which == "env":
        scene = scene._replace(env_emission=leaves[0])
    elif which == "camera":
        cam = cam._replace(frame=leaves[0], lens=leaves[1])
    else:
        scene = scene._replace(prim_verts=leaves[0])
    return scene, cam


def _leaves(which, scene, cam):
    return {"texels": [scene.textures.data], "env": [scene.env_emission],
            "camera": [cam.frame, cam.lens],
            "prim_verts": [scene.prim_verts]}[which]


def _port_loss(which, port):
    dscene, config, cam, opts = port

    def loss(*leaves):
        d, c = _swap(which, dscene, cam, leaves)
        rad = tdiff.render_radiance(d, config, opts, c, EXT_RES, EXT_RES,
                                    _pix(EXT_RES * EXT_RES), 0)
        return torch.mean(rad * rad)  # target 0

    return loss


LEAVES = ("texels", "env", "camera", "prim_verts")


@pytest.mark.parametrize("which", LEAVES)
def test_textured_quad_grads_match_jax(textured, which):
    """Gradients with respect to texels, environment emission, camera
    frame and lens, and the quad's corners (through the dense
    intersector's plain version and the straight-through re-test)
    against jax.grad of the JAX package's render_radiance."""
    port, (jd, jc, jcam, jopts) = textured

    def jloss(*leaves):
        d, c = _swap(which, jd, jcam, leaves)
        rad = jdiff.render_radiance(d, jc, jopts, c, EXT_RES, EXT_RES,
                                    _pix(EXT_RES * EXT_RES, jnp), jnp.int32(0))
        return jnp.mean(rad * rad)

    j_leaves = _leaves(which, jd, jcam)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(j_leaves)))))(
        *j_leaves)
    leaves = [x.clone().requires_grad_()
              for x in _leaves(which, port[0], port[2])]
    _port_loss(which, port)(*leaves).backward()
    for x, w in zip(leaves, want, strict=True):
        got = x.grad.numpy()
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-6
        np.testing.assert_allclose(got, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ("texels", "env", "camera"))
def test_textured_quad_grads_vs_finite_differences(textured, which):
    """The same gradients against the port's own central differences
    (tests/test_diff_extended.py, at its step sizes: 1e-2, the camera
    frame 5e-3 and lens 1e-4) on the largest entries."""
    port = textured[0]
    loss = _port_loss(which, port)
    leaves = [x.clone().requires_grad_()
              for x in _leaves(which, port[0], port[2])]
    loss(*leaves).backward()
    for k, x in enumerate(leaves):
        g = x.grad.numpy()
        flat = np.argsort(-np.abs(g).ravel())[:3]
        eps = (5e-3 if k == 0 else 1e-4) if which == "camera" else FD_EPS
        for i in flat:
            def at(delta):
                vals = [y.detach().clone() for y in leaves]
                vals[k].view(-1)[i] += delta
                with torch.no_grad():
                    return float(loss(*vals))

            fd = (at(eps) - at(-eps)) / (2 * eps)
            np.testing.assert_allclose(g.ravel()[i], fd, rtol=FD_RTOL,
                                       atol=1e-6)


# ---- the sphere grid: the worklist intersector's plain version ---------


def test_sphere_grid_vertex_grads_match_jax():
    """1,030 quads take the worklist intersector (its plain version on the
    CPU): the prim_verts gradient of the port's render_radiance against
    jax.grad of the JAX trace_wavefront over intersect_bruteforce on the
    same traced prim_verts, with the camera rays and RNG streams of the
    JAX render_radiance."""
    res, bounces = 16, 3
    scene = sphere_grid_scene(2, 16)
    r = tren.Renderer(scene, tren.Params(resolution=res, bounces=bounces),
                      device="cpu")
    assert isinstance(r.intersect.tables, wl.WorklistTables)
    jr = jren.Renderer(to_jax_scene(scene), jren.Params(
        resolution=res, samples=1, bounces=bounces, sampler="path"))
    np.testing.assert_array_equal(r.dscene.prim_verts.numpy(),
                                  np.asarray(jr.dscene.prim_verts))
    opts = tdiff.diff_options(r.options, r.config)
    jopts = jdiff.diff_options(jr.options, jr.config)
    n = res * res

    def jloss(pv):
        d = jr.dscene._replace(prim_verts=pv)
        pix = _pix(n, jnp)
        rng = j_rng.seed_state(pix, jnp.int32(0), 0)
        puv, rng = j_rng.rand2f(rng)
        luv, rng = j_rng.rand2f(rng)
        ij = jnp.stack([pix % res, pix // res], axis=-1)
        ro, rd = j_sample_camera(jr.cam_arrays, ij, (res, res), puv, luv, False)

        def isect(ro_, rd_, tn, tx):
            return j_bruteforce(d.prim_verts, ro_, rd_, tn, tx,
                                prim_instance=d.prim_instance)

        rad = jint.trace_wavefront(d, jr.config, jopts, ro, rd, rng,
                                   intersect=isect)[0]
        rad = jnp.where(jnp.all(jnp.isfinite(rad), axis=-1)[:, None], rad, 0.0)
        return jnp.mean(rad * rad)

    want = np.asarray(jax.jit(jax.grad(jloss))(jr.dscene.prim_verts))
    pv = r.dscene.prim_verts.clone().requires_grad_()
    rad = tdiff.render_radiance(r.dscene._replace(prim_verts=pv), r.config,
                                opts, r.cam_arrays, res, res, _pix(n), 0,
                                intersector=r.intersect)
    torch.mean(rad * rad).backward()
    got = pv.grad.numpy()
    assert np.isfinite(got).all()
    # some of the spheres' quads (corners within 0.3 of each other) take
    # a gradient, not only the room's
    live = np.abs(got).reshape(len(got), -1).max(axis=1) > 0
    small = np.ptp(r.dscene.prim_verts.numpy(), axis=1).max(axis=1) < 0.3
    assert (live & small).sum() >= 4
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
