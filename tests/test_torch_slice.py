"""The slice end to end: the port's Renderer against the JAX package's at
32 x 32, 2 samples, 4 bounces, same seed, on two in-code scenes (one JAX
compile each, in a module fixture):
  - the Cornell box (18 quads): the dense intersector in both packages;
  - sphere_grid_scene(2, 16) (1,030 quads): the port's worklist cluster
    intersector (its plain version on the CPU) against the JAX package's
    CPU path, its BVH walk intersect_bvh;
  - the same grid on the heavy-scene path: the wavefront sort on in both
    (JRT_SORT=1 for the JAX package), and in the port the regroup
    intersector for bounce rays (regroup="on", regroup_min_prims=0; its
    plain versions on the CPU) with the worklist for camera rays.
test_torch_wavefront.py holds trace_wavefront to the same criterion.

Criterion: image mean within 1e-3 relative, and >= 99% of pixels within
1e-3 absolute. Exact equality is not required: the two frameworks' CPU
transcendentals (sin, cos, sqrt-based warps, pow) differ by an ulp here
and there, and a last-bit difference can flip a Russian-roulette or
edge decision and send one path elsewhere."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, image_close, sphere_grid_scene,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from torch_parity import (
    BOUNCES, RES, cornell_scene_jax, instanced_test_scene, sphere_grid_scene_jax,
)

SPP = 2
HEAVY_PATH = dict(sort_rays=True, regroup="on", regroup_min_prims=0)
SCENES = {  # name: port scene, JAX scene, port Params fields, JAX env
    "cornell": (cornell_scene, cornell_scene_jax, {}, {}),
    "spheres": (lambda: sphere_grid_scene(2, 16),
                lambda: sphere_grid_scene_jax(2, 16), {}, {}),
    "spheres_sorted_regroup": (lambda: sphere_grid_scene(2, 16),
                               lambda: sphere_grid_scene_jax(2, 16),
                               HEAVY_PATH, {"JRT_SORT": "1"}),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def renders(request):
    port_scene, jax_scene, port_fields, jax_env = SCENES[request.param]
    jp = jren.Params(resolution=RES, samples=SPP, batch=SPP, bounces=BOUNCES,
                     sampler="path", seed=5)
    js = jax_scene()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in jax_env.items():
            mp.setenv(k, v)
        jr = jren.Renderer(js, jp)
    assert jr.options.sort_rays == bool(jax_env)
    jst = jren.make_trace_state(js, jp)
    jr.trace_samples(jst)
    tp = tren.Params(resolution=RES, samples=SPP, batch=SPP, bounces=BOUNCES,
                     sampler="path", seed=5, **port_fields)
    ts = port_scene()
    tr = tren.Renderer(ts, tp, device="cpu")
    tst = tren.make_trace_state(ts, tp, device="cpu")
    syncs = rg.regroup_intersect.host_syncs
    tr.trace_samples(tst)
    if port_fields:  # the bounces went through the regroup intersector
        assert tr.options.sort_rays
        assert tr.intersect.primary is not tr.intersect.hit
        assert rg.regroup_intersect.host_syncs > syncs
    return jr, jst, tr, tst


def test_renderer_matches_jax(renders):
    jr, jst, tr, tst = renders
    assert tst.samples == jst.samples == SPP
    img = tr.get_image(tst)
    assert img.shape == (RES, RES, 4)
    image_close(img, jr.get_image(jst))
    ja, ta = jr.get_aovs(jst), tr.get_aovs(tst)
    np.testing.assert_array_equal(ta["hits"], ja["hits"])
    for k in ("albedo", "normal"):
        np.testing.assert_allclose(ta[k], ja[k], atol=1e-5)


def test_mid_size_scene_takes_the_worklist_intersector():
    r = tren.Renderer(sphere_grid_scene(2, 16), tren.Params(resolution=8),
                      device="cpu")
    assert r.config.n_prims == 4 * 16 * 16 + 6
    tables = r.intersect.tables
    assert isinstance(tables, wl.WorklistTables) and tables.sup == wl.WL_SUPER
    # make_intersect's plain worklist version gives the same hits
    ro = torch.tensor([[0.0, 1.0, 3.9]] * 3)
    rd = torch.tensor([[0.0, -0.3, -1.0], [0.3, -0.2, -1.0], [0.0, 0.0, -1.0]])
    rd = rd / rd.norm(dim=1, keepdim=True)
    tmin, tmax = torch.full((3,), 1e-4), torch.full((3,), 3.4e38)
    got = r.intersect(ro, rd, tmin, tmax)
    plain = tint.make_intersect(r.dscene, r.config)(ro, rd, tmin, tmax)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert got.hit.all()


def test_trace_wavefront_defaults_to_the_scenes_intersector(monkeypatch):
    """Without an `intersect`, trace_wavefront builds build_intersector's,
    which takes the kernels for a scene on the card; make_intersect, the
    plain reference, refuses a scene that is not on the CPU."""
    r = tren.Renderer(sphere_grid_scene(2, 8), tren.Params(resolution=8),
                      device="cpu")
    built, build = [], tint.build_intersector

    def spy(dscene, config):
        built.append(dscene)
        return build(dscene, config)

    monkeypatch.setattr(tint, "build_intersector", spy)
    ro = torch.tensor([[0.0, 1.0, 3.9]] * 4)
    rd = torch.tensor([[0.0, -0.2, -1.0]] * 4)
    rd = rd / rd.norm(dim=1, keepdim=True)
    tint.trace_wavefront(r.dscene, r.config, r.options, ro, rd,
                         torch.arange(4, dtype=torch.int32))
    assert built == [r.dscene]
    on_meta = r.dscene._replace(prim_verts=r.dscene.prim_verts.to("meta"))
    with pytest.raises(ValueError, match="build_intersector"):
        tint.make_intersect(on_meta, r.config)


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means the card: without one they raise, not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, params = cornell_scene(), tren.Params(resolution=8)
    for call in (lambda: tren.Renderer(scene, params),
                 lambda: tren.make_trace_state(scene, params),
                 lambda: tren.camera_arrays(scene.cameras[0])):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    r = tren.Renderer(scene, params, device="cpu")
    assert r.device == torch.device("cpu")


def test_renderer_rejects_unported_options():
    # adaptive sampling is ported: it builds, and refuses a uniform state
    r = tren.Renderer(cornell_scene(), tren.Params(adaptive=True, resolution=8),
                      device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        r.trace_samples(tren.make_trace_state(
            cornell_scene(), tren.Params(resolution=8), device="cpu"))
    with pytest.raises(ValueError):
        tren.Renderer(cornell_scene(), tren.Params(regroup="yes"), device="cpu")
    # the fixed-trip (differentiable) loop is ported for instanced scenes
    # too: it no longer raises, and renders the while loop's radiance
    dscene, config = build_device_scene(instanced_test_scene(),
                                        instancing=True, device="cpu")
    ro = torch.tensor([[0.0, 0.0, 8.0]]).expand(4, 3)
    rd = torch.nn.functional.normalize(torch.tensor(
        [[0.0, 0.0, -1.0], [0.3, 0.0, -1.0], [0.0, 0.3, -1.0],
         [2.0, 0.0, -1.0]]), dim=1)
    rng = torch.arange(4, dtype=torch.int32)
    with torch.no_grad():
        got, want = (tint.trace_wavefront(
            dscene, config, tint.TraceOptions(fixed_iterations=k), ro, rd,
            rng)[0] for k in (9, 0))
    assert torch.equal(got, want)


def test_heavy_scene_routing(capsys, monkeypatch):
    """regroup="on" / "off" / "auto" at or above regroup_min_prims, the
    default 150,000 below it, and the sort's 50,000-quad default."""
    scene = sphere_grid_scene(2, 8)

    def build(**fields):
        return tren.Renderer(scene, tren.Params(resolution=8, **fields),
                             device="cpu")

    default = build()
    assert not default.options.sort_rays
    # worklist: 262 < 150k
    assert default.intersect.primary is default.intersect.hit
    on = build(regroup="on", regroup_min_prims=0)
    assert on.intersect.livegate == rg.DEF_LIVEGATE
    assert on.intersect.primary is not on.intersect.hit
    assert isinstance(on.intersect.tables, wl.WorklistTables)
    off = build(regroup="off", regroup_min_prims=0)
    assert off.intersect.primary is off.intersect.hit
    assert build(sort_rays=True).options.sort_rays
    monkeypatch.setattr(tren, "SORT_MIN_PRIMS", 100)
    assert build().options.sort_rays
    # auto: the kernel_select decision, printed as the JAX package prints it
    for ratio, kernel in ((0.1, "regroup"), (0.3, "regroup"), (0.5, "worklist")):
        monkeypatch.setattr(
            tint.kernel_select, "select_bounce_kernel",
            lambda *a, ratio=ratio, kernel=kernel, **k: dict(
                kernel=kernel, ratio=ratio, threshold=0.35))
        auto = build(regroup_min_prims=0)
        line = capsys.readouterr().out
        assert line.startswith(f"bounce kernel: {kernel} (predicted "
                               f"regroup/worklist ratio {ratio}, threshold 0.35)")
        assert ((auto.intersect.primary is not auto.intersect.hit)
                == (kernel == "regroup"))
        if kernel == "regroup":
            assert auto.intersect.livegate == (0.2 if ratio < 0.25 else 0.45)
