"""The shading kernel's route and its plain version on the CPU
(ops/shade_path.py, render/integrator.py shade_route, shade_plain):

  - the route table: which scene configs and trace options take the
    kernel, over the in-code test scenes and the three benchmark scenes'
    configurations, and each condition of the route alone;
  - the plain shading (the eager bounce with the intersect stood in for)
    gives the bounce's own fields and next ray on one body, and a trace
    forced through the kernel's route on the CPU (shade_path's plain
    branch) equals the eager trace bit for bit on the Cornell box, a small
    SPD tree and lit_panels_scene, with every body span `shaded`;
  - the wrapper raises on a device and on a state it does not take;
  - `shade_path.launches` is a registered counter that CUDA-graph replays
    add back as eager bodies tick it, and the cost model's floor.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch
from test_torch_body_graphs import StandIn

from julia_raytracer_tpu_torch.ops import shade_path as sp
from julia_raytracer_tpu_torch.render import body_graphs as bg
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.lights import EXACT_ELEMS
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, hairball_scene, lit_panels_scene, many_lights_scene,
    sphere_grid_scene,
)
from julia_raytracer_tpu_torch.utils import kernel_flops as kf
from julia_raytracer_tpu_torch.utils import timing

CUDA = torch.device("cuda")


def _bench_config(name):
    from benchmark.modes import render_curves
    from benchmark.modes.common import build_scene, load_json, to_program_scene

    cfg = load_json("configs", name)
    make = (render_curves.to_program_scene if name == "spd_tree"
            else to_program_scene)
    return build_device_scene(make(build_scene(cfg)), device="cpu")[1]


SCENES = {
    "cornell": lambda: cornell_scene(),
    "lit_panels": lambda: lit_panels_scene(),
    "hairball": lambda: hairball_scene(64),
    "sphere_grid": lambda: sphere_grid_scene(2, 16),
    "many_lights": lambda: many_lights_scene(),
}


@pytest.mark.parametrize("scene,want", [
    ("cornell", True),  # matte, dense material rows
    ("lit_panels", True),  # vertex colours, glossy rows, 38 light elements
    ("hairball", True),  # matte and glossy, lines and points
    ("sphere_grid", False),  # a reflective sphere: a delta lobe
    ("many_lights", False),  # 5,120 light elements: the march
    ("bench:cornellbox", True),
    ("bench:sphereflake", True),  # 7,385 instances: eval_material's tables
    ("bench:spd_tree", True),
])
def test_route_over_scenes(scene, want):
    """The path sampler's while loop on the card takes the kernel on the
    scenes the route covers, and on no other."""
    if scene.startswith("bench:"):
        config = _bench_config(scene[6:])
    else:
        config = build_device_scene(SCENES[scene](), device="cpu")[1]
    assert tint.shade_route(CUDA, config, tint.TraceOptions()) == want


@pytest.mark.parametrize("change", [
    "cpu", "naive", "fixed", "sort", "nocaustics", "env", "volumes",
    "opacity", "textures", "normal_maps", "vertex_normals", "no_instances",
    "march", "delta", "refractive",
])
def test_each_condition_of_the_route(change):
    """Each condition alone turns the Cornell box's route back to the
    eager bounce; vertex texcoords and colours do not."""
    _, config = build_device_scene(cornell_scene(), device="cpu")
    options, device = tint.TraceOptions(), CUDA
    counts = config.light_counts
    assert tint.shade_route(device, config._replace(
        has_texcoords=True, has_colors=True), options)
    if change == "cpu":
        device = torch.device("cpu")
    elif change == "naive":
        options = options._replace(sampler="naive")
    elif change == "fixed":
        options = options._replace(fixed_iterations=9)
    elif change == "sort":
        options = options._replace(sort_rays=True)
    elif change == "nocaustics":
        options = options._replace(nocaustics=True)
    elif change == "march":
        config = config._replace(light_counts=type(counts)(
            counts.n_instance, counts.n_env, counts.max_inst_elems,
            counts.max_env_texels, EXACT_ELEMS + 1))
    elif change == "delta":
        config = config._replace(present_types=(0, 2))
    elif change == "refractive":
        config = config._replace(present_types=(0, 4), has_volumes=True)
    else:
        field, value = dict(
            env=("n_envs", 1), volumes=("has_volumes", True),
            opacity=("has_opacity", True), textures=("has_textures", True),
            normal_maps=("has_normal_maps", True),
            vertex_normals=("has_vertex_normals", True),
            no_instances=("n_instances", 0))[change]
        config = config._replace(**{field: value})
    assert not tint.shade_route(device, config, options)


def _first_state(scene, res=32, seed=3):
    """The Cornell-style first body's state of a trace at res², and its
    Bounce: the camera rays' hits through the scene's intersector, from a
    TraceVars whose every field comes from that trace."""
    p = Params(resolution=res, samples=1 << 20, batch=1, bounces=8,
               seed=seed)
    r = Renderer(scene, p, device="cpu")
    r.body_graphs = None
    kept = []
    real = tint.eager_bounce

    def keeping(b, s, query):
        kept.append((b, s))
        return real(b, s, query)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tint, "eager_bounce", keeping)
        r.trace_samples(make_trace_state(scene, p, device="cpu"))
    return r, kept


@pytest.mark.parametrize("scene", ["cornell", "lit_panels"])
def test_shade_plain_gives_the_bounce_fields(scene):
    """On the bodies of a trace, shade_plain's outputs are the eager
    bounce's radiance, weight, RNG state, bounce, alive, hit flag and
    AOVs, and the next ray, tmin and tmax it hands its intersect."""
    r, kept = _first_state(SCENES[scene]())
    assert len(kept) >= 3
    for b, s in kept[:3]:
        asked = []

        def query(ro, rd, tmin, tmax):
            asked.append((ro, rd, tmin, tmax))
            return r.intersect.hit(ro, rd, tmin, tmax)

        want = tint.eager_bounce(b, s, query)
        got = tint.shade_plain(b, s)
        for a, w in zip(got[:4], asked[0], strict=True):
            assert torch.equal(a, w)
        for f in sp.ShadeOut._fields[4:]:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def _frames(scene, forced: bool, res=48, frames=2, graphs=None):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tint, "SHADE_PATH_DEVICES", ("cpu",) if forced else ())
        p = Params(resolution=res, samples=1 << 20, batch=1, bounces=8,
                   seed=11)
        r = Renderer(scene, p, device="cpu")
        r.body_graphs = graphs
        st = make_trace_state(scene, p, device="cpu")
        t0 = timing._now()
        for _ in range(frames):
            r.trace_samples(st)
    rows = [row for u in timing.units() if u["start_ns"] >= t0
            for path, row in u["table"].items() if path.endswith("/body")]
    return [x.clone() for x in (st.image, st.albedo, st.normal, st.hits)], rows


def _small_tree():
    from benchmark.modes import render_curves
    from benchmark.scenes import spd_tree

    return render_curves.to_program_scene(spd_tree.build(3))


@pytest.mark.parametrize("scene", ["cornell", "tree", "lit_panels"])
def test_forced_route_equals_the_eager_trace(scene):
    """Two frames at 48², the route forced onto the CPU (the wrapper's
    plain branch, the bounce's fields put back together around the
    intersect) against the eager bounce: image, AOVs and hits bit for bit;
    every body span `shaded` on the forced route and none on the eager
    one."""
    make = _small_tree if scene == "tree" else SCENES[scene]
    got, got_rows = _frames(make(), True)
    want, want_rows = _frames(make(), False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    bodies = sum(row["n"] for row in got_rows)
    assert bodies == sum(row["n"] for row in want_rows) > 0
    assert sum(row["shaded"] for row in got_rows) == bodies
    assert sum(row["shaded"] for row in want_rows) == 0


def test_wrapper_raises_on_what_it_does_not_take():
    """A state on another device than the CPU or the card, and a state of
    another dtype, shape or layout, raise."""
    r, kept = _first_state(cornell_scene(), res=16)
    b, s = kept[0]
    tables = sp.make_tables(b.dscene, b.config, b.options)
    meta = type(s)(*(x.to("meta") for x in s))
    with pytest.raises(ValueError, match="unsupported device"):
        sp.shade_path(tables, meta, lambda s: None)
    n, dev = s.alive.shape[0], s.alive.device
    sp._check_state(s, n, dev)
    for bad in (s._replace(weight=s.weight.double()),
                s._replace(rng=s.rng.long()),
                s._replace(isec_hit=s.isec_hit.int()),
                s._replace(rd=s.rd[:-1]),
                s._replace(rd=s.rd.t().contiguous().t())):
        with pytest.raises(ValueError, match="shade_path"):
            sp._check_state(bad, n, dev)


def test_launches_registered_and_added_back_at_replay(monkeypatch):
    """shade_path.launches is in the counter registry; with the route
    forced onto the CPU and each plain shading standing in for a launch
    (a tick), frames from CUDA-graph stand-ins count what eager frames
    count, one a body."""
    assert (sp.shade_path, "launches") in [(h, n) for h, n, _ in
                                           timing.counters()]
    real = tint.shade_plain

    def launching(b, s):
        sp.shade_path.launches += 1
        return real(b, s)

    monkeypatch.setattr(tint, "shade_plain", launching)
    counts = []
    for graphs in (bg.BodyGraphs(StandIn()), None):
        sp.shade_path.launches = 0
        _, rows = _frames(cornell_scene(), True, res=32, frames=3,
                          graphs=graphs)
        counts.append((sp.shade_path.launches, sum(r["n"] for r in rows),
                       sum(r["shaded"] for r in rows),
                       sum(r["graphed"] for r in rows)))
    (got, bodies, shaded, graphed), want = counts
    assert got == bodies == shaded == want[0] == want[1] > 0
    assert graphed == bodies - 1 and want[3] == 0


def test_cost_model_floor():
    """201 bytes a lane; a matte lane's operations and two triangle tests
    a light element."""
    assert kf.shade_path_cost(1, 0) == dict(ops=125.0, bytes=201.0)
    assert kf.shade_path_cost(1 << 20, 3) == dict(
        ops=float((1 << 20) * (125 + 6 * 51)), bytes=float((1 << 20) * 201))
