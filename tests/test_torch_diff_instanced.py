"""The port's differentiable path on instanced and hybrid scenes (the
Intersector's differentiable form, ops/diff_hit.py
make_diff_intersect_instanced) against the JAX package's, on the CPU.

The scene is tests/test_instanced.py's (torch_parity.instanced_test_scene
with an emissive instance and an environment), built by each package's
own build_device_scene_instanced at hybrid_budget 0 (pure two-level: the
work-item intersector's plain version) and 60 (a 50-quad world soup
through the dense intersector's plain version, 3 work items after it);
every case runs on both builds:

  - the fixed-trip render equals the while loop's bit for bit;
  - make_param_loss's colour and emission gradients against jax.grad of
    the JAX package's make_param_loss (a camera at (0, 0, 8) looking down
    -z replaces the scene's default one, which sits inside an instance);
  - prim_verts gradients of the mean squared radiance of
    torch_parity.instanced_test_rays() turned towards the instances
    against jax.grad of the JAX
    trace_wavefront over jint.make_intersect(d, cfg), built inside the
    differentiated function from the replaced scene (the JAX
    make_intersect_instanced_ref reads prim_verts when it is built);
  - the work-item intersector's plain version reports intersect_quad's
    u and v (the second triangle's flipped), which the re-test relies on
    (on testing.py's UV spheres: the test scene's shapes are triangles);
  - make_diff_intersect_instanced's forward is the wrapped intersector's,
    bit for bit, and the gradient of its hit (t, u, v, position, normal)
    with respect to the vertices and the rays is jax.grad's of the JAX
    make_intersect's.

JAX parity: every entry within rtol 1e-3, atol 1e-6, as
tests/test_torch_diff.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.render import diff as jdiff
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu.render import scene_device as jsd
from julia_raytracer_tpu.utils import rng as j_rng
from julia_raytracer_tpu_torch.ops import diff_hit
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.ops.diff_hit import (
    make_diff_intersect_instanced, retest_quad,
)
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops.instanced_intersect import _to_shape_space
from julia_raytracer_tpu_torch.parallel import mesh as pm
from julia_raytracer_tpu_torch.render import diff as tdiff
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render import scene_device as tsd
from julia_raytracer_tpu_torch.testing import (
    GRAD_TOL, grads_close, hybrid_scene, instanced_scene,
)
from julia_raytracer_tpu_torch.utils import rng as t_rng
from torch_parity import (
    INSTANCED_N_RAYS as N_RAYS, instanced_test_camera, instanced_test_rays,
    instanced_test_scene, to_jax_scene,
)

RTOL, ATOL = 1e-3, 1e-6  # JAX parity, per entry
BOUNCES = 3
RES = 32  # make_param_loss's image
LIGHT = 1  # the emissive material
BUDGETS = (0, 60)
# vertex rows that must take a gradient: the work items' quads under the
# 2,048 aimed rays (50 and 32 rows live at budgets 0 and 60)
MIN_LIVE_ROWS = 20


def _scene():
    s = instanced_test_scene(emissive=True, env=True)
    s.cameras = [instanced_test_camera()]
    return s


@pytest.fixture(scope="module", params=BUDGETS, ids=lambda b: f"budget{b}")
def built(request):
    """(port, jax): each (dscene, config, camera arrays, fixed-trip
    options) of the same scene at one hybrid budget."""
    budget = request.param
    s = _scene()
    d, cfg = tsd.build_device_scene_instanced(s, hybrid_budget=budget,
                                              device="cpu")
    dj, cfg_j = jsd.build_device_scene_instanced(to_jax_scene(s),
                                                 hybrid_budget=budget)
    assert (cfg.hyb_world_verts is None) == (budget == 0)
    assert len(cfg.inst_tables.wi_inst) > 0
    np.testing.assert_array_equal(d.prim_verts.numpy(),
                                  np.asarray(dj.prim_verts))
    opts = tdiff.diff_options(tint.TraceOptions(sampler="path",
                                                bounces=BOUNCES), cfg)
    jopts = jdiff.diff_options(jint.TraceOptions(sampler="path",
                                                 bounces=BOUNCES), cfg_j)
    assert opts.fixed_iterations == jopts.fixed_iterations
    return ((d, cfg, tren.camera_arrays(s.cameras[0], "cpu"), opts),
            (dj, cfg_j, jren.camera_arrays(s.cameras[0]), jopts))


def _aimed_rays():
    """[ro, rd, tmin, tmax] of instanced_test_rays() turned towards the
    five instances: from (0, 0, 8) at points within 0.8 of each
    instance's origin (instanced_test_rays() leaves 46 of 2,048 on an
    instance). Every ninth lane stays dead (tmax = -1)."""
    ro, _, tmin, tmax = instanced_test_rays()
    centres = np.array([[0, 0, 0], [2.5, 0, 0], [-2.5, 0.5, 0], [0, 2.5, -1],
                        [1.5, -2.0, 1]], np.float32)
    g = np.random.default_rng(9)
    aim = (centres[np.arange(N_RAYS) % 5]
           + g.uniform(-0.8, 0.8, (N_RAYS, 3)).astype(np.float32))
    rd = aim - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return [torch.from_numpy(x) for x in (ro, rd, tmin, tmax)]


def _rays():
    ro, rd = _aimed_rays()[:2]
    rng = t_rng.seed_state(torch.arange(N_RAYS, dtype=torch.int32), 0, 0)
    return ro, rd, rng


def test_fixed_trip_equals_while_loop(built):
    """The fixed-trip loop over the wrapped intersector renders the while
    loop's radiance bit for bit, with no host sync."""
    d, cfg, _, opts = built[0]
    isect = tint.build_intersector(d, cfg)
    with torch.no_grad():
        want = tint.trace_wavefront(d, cfg, opts._replace(fixed_iterations=0),
                                    *_rays(), intersector=isect)
        syncs = tint.trace_wavefront.host_syncs
        got = tint.trace_wavefront(d, cfg, opts, *_rays(), intersector=isect)
    assert tint.trace_wavefront.host_syncs == syncs
    # radiance, hit, albedo, normal (the rng streams run on in the
    # fixed-trip loop's extra bodies)
    for a, b in zip(got[:4], want[:4], strict=True):
        assert torch.equal(a, b)
    assert want[0].mean() > 0


def test_param_loss_grads_match_jax(built):
    """Colour and emission gradients of the pixel loss against jax.grad of
    the JAX package's make_param_loss: same scene, seed and samples."""
    (d, cfg, cam, _), (dj, cfg_j, jcam, _) = built
    target = np.random.default_rng(4).uniform(
        0.0, 0.5, (RES * RES, 3)).astype(np.float32)
    jloss = jdiff.make_param_loss(dj, cfg_j, jint.TraceOptions(
        sampler="path", bounces=BOUNCES), jcam, RES, RES)
    lj, (gc_j, ge_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)),
                               static_argnums=(4,))(
        dj.materials.color, dj.materials.emission,
        jnp.arange(RES * RES, dtype=jnp.int32), jnp.asarray(target), 1)
    loss = tdiff.make_param_loss(d, cfg, tint.TraceOptions(
        sampler="path", bounces=BOUNCES), cam, RES, RES)
    c = d.materials.color.clone().requires_grad_()
    e = d.materials.emission.clone().requires_grad_()
    lt = loss(c, e, torch.arange(RES * RES, dtype=torch.int32),
              torch.as_tensor(target), 1)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=RTOL)
    for got, want in ((c.grad.numpy(), gc_j), (e.grad.numpy(), ge_j)):
        assert np.abs(got).max() > 1e-3
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    # the diffuse material's colour and the light's emission move
    assert np.abs(c.grad.numpy()[0]).sum() > 0
    assert np.abs(e.grad.numpy()[LIGHT]).sum() > 0


def test_vertex_grads_match_jax(built):
    """prim_verts gradients of the mean squared radiance of 2,048 rays
    through the work items (the instance transform) against jax.grad of
    the JAX trace_wavefront over its reference intersectors."""
    (d, cfg, _, opts), (dj, cfg_j, _, jopts) = built
    ro, rd, rng = _rays()

    def jloss(pv):
        dd = dj._replace(prim_verts=pv)
        jrng = j_rng.seed_state(jnp.arange(N_RAYS, dtype=jnp.int32),
                                jnp.int32(0), 0)
        rad = jint.trace_wavefront(dd, cfg_j, jopts, jnp.asarray(ro.numpy()),
                                   jnp.asarray(rd.numpy()), jrng,
                                   intersect=jint.make_intersect(dd, cfg_j))[0]
        rad = jnp.where(jnp.all(jnp.isfinite(rad), axis=-1)[:, None], rad, 0.0)
        return jnp.mean(rad * rad)

    want = np.asarray(jax.jit(jax.grad(jloss))(dj.prim_verts))
    pv = d.prim_verts.clone().requires_grad_()
    rad = tint.trace_wavefront(d._replace(prim_verts=pv), cfg, opts, ro, rd,
                               rng, intersector=tint.build_intersector(d, cfg))[0]
    rad = torch.where(torch.isfinite(rad).all(dim=-1)[:, None], rad, 0.0)
    torch.mean(rad * rad).backward()
    got = pv.grad.numpy()
    assert np.isfinite(got).all()
    live = np.abs(got).reshape(len(got), -1).max(axis=1) > 0
    assert live.sum() >= MIN_LIVE_ROWS
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _work_items(cfg):
    """The work-item intersector over the scene's work items: the whole of
    a pure two-level scene's route, the hybrid's instanced branch."""
    return ii.make_instanced_intersect(cfg.inst_tables, "cpu",
                                       diff_hit.instanced_diff)


@pytest.mark.parametrize("scene,budget", [
    (lambda: instanced_scene(3, (8, 6)), 0),
    (lambda: hybrid_scene(4, 4, 3, 12), 300)], ids=("pure", "hybrid"))
def test_work_item_uv_follows_intersect_quad(scene, budget):
    """The work-item intersector's plain version reports prim
    (best_tri // 2) and u, v (flipped on the second triangle) as
    intersect_quad does: its u, v, t against the re-test of the quad it
    reports, in the hit instance's shape space. The test scene's shapes
    are triangles, whose second triangle is degenerate, so this case
    takes testing.py's UV spheres (quads), pure and as a hybrid's work
    items, under 96 x 96 camera rays."""
    data = scene()
    d, cfg = tsd.build_device_scene_instanced(data, hybrid_budget=budget,
                                              device="cpu")
    items = _work_items(cfg)
    res = 96
    pix = torch.arange(res * res, dtype=torch.int32)
    ij = torch.stack([pix % res, pix // res], dim=-1)
    half = torch.full((res * res, 2), 0.5)
    ro, rd = sample_camera(tren.camera_arrays(data.cameras[0], "cpu"), ij,
                           (res, res), half, half, False)
    tmin, tmax = torch.full((res * res,), 1e-4), torch.full((res * res,), 3.4e38)
    h = items(ro, rd, tmin, tmax)
    hit = h.hit
    second = hit & (h.u + h.v > 1.0)
    assert second.sum() > 20 and (hit & ~second).sum() > 20  # both triangles
    rows = torch.as_tensor(cfg.inst_tables.inst_rows)
    so, sd = _to_shape_space(ro, rd, rows[h.instance.long()])
    u, v, t = retest_quad(d.prim_verts[h.prim.clamp(min=0).long()], so, sd,
                          tmin, tmax, h.u + h.v <= 1.0)
    for a, b in ((u, h.u), (v, h.v), (t, h.t)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-3, atol=2e-4)


def test_diff_intersect_forward_is_the_intersectors(built):
    """The wrapped intersector returns the intersector's values bit for
    bit (make_diff_intersect_instanced alone, and the route's
    differentiable form, the fixed-trip loop's: a hybrid's composition),
    and its gradient reaches the shape-space vertices and the rays."""
    d, cfg, _, _ = built[0]
    isect = tint.build_intersector(d, cfg)
    ro, rd, tmin, tmax = _aimed_rays()
    rd = rd.clone().requires_grad_()
    pv = d.prim_verts.clone().requires_grad_()
    rows = torch.as_tensor(cfg.inst_tables.inst_rows)
    items = _work_items(cfg)
    wrapped = [(make_diff_intersect_instanced(items, pv, rows), items),
               (isect.differentiable(d._replace(prim_verts=pv)), isect)]
    for diff_fn, fn in wrapped:
        got = diff_fn(ro, rd, tmin, tmax)
        want = fn(ro, rd.detach(), tmin, tmax)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a.detach(), b)
        assert got.hit.any()
        pv.grad = rd.grad = None
        (got.t.sum() + got.position.sum() + got.gnormal.sum()).backward()
        assert torch.isfinite(pv.grad).all() and pv.grad.abs().sum() > 0
        assert torch.isfinite(rd.grad).all() and rd.grad.abs().sum() > 0


def _hit_loss(h, hit, w, lib):
    """A weighted sum of a Hit's differentiable fields over `hit` lanes."""
    hit3 = hit[:, None]
    scalar = lib.where(hit, w[:, 0] * h.t + w[:, 1] * h.u + w[:, 2] * h.v, 0.0)
    vector = lib.where(hit3, w[:, 3:6] * h.position + w[:, 6:9] * h.gnormal,
                       0.0)
    return scalar.sum() + vector.sum()


def test_diff_hit_grads_match_jax(built):
    """The gradient of the wrapped intersector's hit (t, u, v, the world
    position and normal) with respect to the shape-space vertices and the
    rays against jax.grad of the JAX package's make_intersect over the
    same scene (make_intersect_instanced_ref, or the hybrid of
    intersect_bruteforce over the soup and it). The radiance takes the
    geometry's gradient through the normal alone here (no textures, no
    vertex normals), so t, u, v and the position are held here."""
    (d, cfg, _, _), (dj, cfg_j, _, _) = built
    ro, rd, tmin, tmax = _aimed_rays()
    w = np.random.default_rng(5).normal(size=(N_RAYS, 9)).astype(np.float32)
    pv = d.prim_verts.clone().requires_grad_()
    ro_g, rd_g = ro.clone().requires_grad_(), rd.clone().requires_grad_()
    isect = tint.build_intersector(d, cfg).differentiable(
        d._replace(prim_verts=pv))
    h = isect(ro_g, rd_g, tmin, tmax)
    _hit_loss(h, h.hit, torch.from_numpy(w), torch).backward()
    hit = h.hit.numpy()
    assert hit.sum() > 300

    def jloss(pv_, ro_, rd_):
        hj = jint.make_intersect(dj._replace(prim_verts=pv_), cfg_j)(
            ro_, rd_, jnp.asarray(tmin.numpy()), jnp.asarray(tmax.numpy()))
        return _hit_loss(hj, jnp.asarray(hit), jnp.asarray(w), jnp)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        dj.prim_verts, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()))
    for x, g in zip((ro_g, rd_g), want[1:], strict=True):
        got = x.grad.numpy()
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
        np.testing.assert_allclose(got, np.asarray(g), rtol=RTOL, atol=ATOL)
    # a vertex's entry sums the signed terms of every lane on its quad
    # (up to 54 in size, cancelling to 1e-4 in places), so it is held
    # to the largest entry, as the card is held to the CPU
    assert grads_close(pv.grad, want[0]) <= GRAD_TOL


def test_train_step_reaches_the_wrapped_intersector(built, monkeypatch):
    """shard_train_step (one process) and make_param_loss on the instanced
    scene build the scene's own intersector (the work items' tables, or
    the hybrid's branches) and trace through the instanced re-test: each
    render wraps the work items once, one query for the bounce and
    camera rays, under their instance rows."""
    d, cfg, cam, _ = built[0]
    calls = []
    real = diff_hit.make_diff_intersect_instanced

    def counting(*args):
        calls.append(args[2])  # the instance rows
        return real(*args)

    monkeypatch.setattr(diff_hit, "make_diff_intersect_instanced", counting)
    opts = tint.TraceOptions(sampler="path", bounces=BOUNCES)
    res = 8
    pix = torch.arange(res * res, dtype=torch.int32)
    target = torch.zeros((res * res, 3))
    step = pm.shard_train_step(pm.make_mesh("cpu"), d, cfg, opts, cam, res,
                               res)
    tables = step.intersect.tables
    items = tables if cfg.hyb_world_verts is None else tables[1]
    assert isinstance(items, ii.InstancedDeviceTables)
    _, color, _ = step(d.materials.color, d.materials.emission, pix, target, 1)
    assert len(calls) == 1 and calls[0] is items.inst_rows
    assert not torch.equal(color, d.materials.color)
    loss = tdiff.make_param_loss(d, cfg, opts, cam, res, res)
    c = d.materials.color.clone().requires_grad_()
    loss(c, d.materials.emission, pix, target, 1).backward()
    assert len(calls) == 2 and c.grad.abs().sum() > 0
