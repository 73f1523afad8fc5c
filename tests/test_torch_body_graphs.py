"""The bookkeeping of render/body_graphs.py on the CPU: eligibility (and
the `graph_safe` and `primary` of each route's Intersector), the
sightings of a lane width, the cache key, states kept out of a graph's
buffers and the counters a replay adds. `StandIn` takes the place of the
CUDA capture, as a capture behaves: the body's Python runs once at the
capture and leaves the buffers as they were, and each replay does the
body's tensor work while the program's counters stay as they were."""

import types
from typing import NamedTuple

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.traversal import Intersector
from julia_raytracer_tpu_torch.render import body_graphs as bg
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.types import InstanceData
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, hairball_scene, hybrid_scene, instanced_scene,
    sphere_grid_scene,
)
from julia_raytracer_tpu_torch.utils import timing

# a module of kernel wrappers that no list in render/body_graphs.py names:
# its counter is known to the registry alone
STAND_IN = types.ModuleType("stand_in_kernels")
timing.counter(STAND_IN, "launches")


class StandIn:
    """A capture on the CPU (module docstring)."""

    device_type = "cpu"

    def __init__(self, fail=False):
        self.fail = fail

    def __call__(self, run, buffers):
        saved = [b.clone() for b in buffers]
        run()
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        for b, v in zip(buffers, saved):
            b.copy_(v)
        def replay():
            before = timing.counters()
            run()
            for holder, name, v in before:
                setattr(holder, name, v)

        return replay

    def reset(self):
        pass


class S(NamedTuple):
    alive: torch.Tensor
    x: torch.Tensor


def _state(width, value=0.0):
    return S(torch.ones(width, dtype=torch.bool),
             torch.full((width, 3), value))


def _step(calls, holder=di.dense_intersect):
    """A body that adds 1 to x and ticks holder.launches."""
    def step(s):
        calls.append(s.alive.shape[0])
        holder.launches += 1
        return S(s.alive, s.x + 1.0)

    return step


def _renderer(res, graphs=True, seed=3):
    scene = cornell_scene()
    p = Params(resolution=res, samples=1 << 20, batch=1, bounces=8,
               seed=seed)
    r = Renderer(scene, p, device="cpu")
    if graphs:
        r.body_graphs = bg.BodyGraphs(StandIn())
    return r, make_trace_state(scene, p, device="cpu")


def _frames(r, st, frames):
    t0 = timing._now()
    for _ in range(frames):
        r.trace_samples(st)
    rows = [row for u in timing.units() if u["start_ns"] >= t0
            for path, row in u["table"].items() if path.endswith("/body")]
    return (st.image, st.albedo, st.normal, st.hits), rows


@pytest.mark.parametrize("res", [32, 128])
def test_replayed_frames_equal_eager(res):
    """3 frames of the Cornell box, 8 bounces: 1,024 lanes (no compaction:
    the second body of the first frame is captured) and 16,384 (two
    widths, compaction and expansion), bit-equal to eager frames, with
    the same live lanes and widths in the body spans."""
    got, want = (_frames(*_renderer(res, graphs), 3) for graphs in (True,
                                                                     False))
    for a, b in zip(got[0], want[0], strict=True):
        assert torch.equal(a, b)
    for key in ("n", "live", "width"):
        assert sum(r[key] for r in got[1]) == sum(r[key] for r in want[1])
    assert sum(r["graphed"] for r in want[1]) == 0
    # only the first body at each width runs eagerly
    widths = {1024} if res == 32 else {16384, 4096}
    assert (sum(r["n"] - r["graphed"] for r in got[1])) == len(widths)


def _bodies_graphed(r, st):
    _, rows = _frames(r, st, 2)
    return sum(row["graphed"] for row in rows), r.body_graphs


class _PassThrough(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["cpu_capture", "fixed", "dispatch_mode",
                                  "undeclared"])
def test_ineligible_traces_run_eager(case):
    """Bodies run eagerly, and nothing is sighted, where the state is not
    on the capture's device, in the fixed-trip loop, under an active
    TorchDispatchMode, and with an Intersector that is not graph_safe."""
    r, st = _renderer(32)
    if case == "cpu_capture":
        r.body_graphs = bg.BodyGraphs()  # the CUDA capture
    if case == "undeclared":
        inner = r.intersect
        r.intersect = Intersector(lambda *a: inner(*a))
    if case == "fixed":
        graphs = r.body_graphs
        ro = torch.zeros((64, 3))
        rd = torch.nn.functional.normalize(torch.randn(64, 3), dim=1)
        opts = r.options._replace(fixed_iterations=9)
        with torch.no_grad():
            tint.trace_wavefront(r.dscene, r.config, opts, ro, rd,
                                 torch.zeros(64, dtype=torch.int32),
                                 intersector=r.intersect, graphs=graphs)
    elif case == "dispatch_mode":
        with _PassThrough():
            graphed, graphs = _bodies_graphed(r, st)
        assert graphed == 0
    else:
        graphed, graphs = _bodies_graphed(r, st)
        assert graphed == 0
    assert graphs.captures == graphs.replays == 0
    assert not graphs.seen and not graphs.graphs


def _curves_only():
    s = hairball_scene(60, 2, 12)
    s.shapes = s.shapes[-2:]
    s.instances = [InstanceData(shape=0, material=4),
                   InstanceData(shape=1, material=5)]
    return s


def _tables(*kinds):
    return lambda t: (isinstance(t, kinds[0]) if len(kinds) == 1 else
                      all(map(isinstance, t, kinds)))


# name: (scene, build_device_scene fields, build_intersector fields, a test
# of its tables, graph_safe)
ROUTES = {
    "dense": (cornell_scene, {}, {}, _tables(di.DenseTable), True),
    "curves_over_dense": (lambda: hairball_scene(60, 2, 12), {}, {},
                          _tables(di.DenseTable), True),
    "curves_only": (_curves_only, {}, {}, lambda t: t is None, False),
    "worklist": (lambda: sphere_grid_scene(2, 8), {}, {},
                 _tables(wl.WorklistTables), False),
    "regroup": (lambda: sphere_grid_scene(2, 8), {},
                dict(regroup="on", regroup_min_prims=0),
                _tables(wl.WorklistTables), False),
    "instanced": (lambda: instanced_scene(3, (8, 6)),
                  dict(instancing=True, hybrid_budget=0), {},
                  _tables(ii.InstancedDeviceTables), False),
    "hybrid": (lambda: hybrid_scene(4, 4, 3, 12),
               dict(instancing=True, hybrid_budget=300), {},
               _tables(wl.WorklistTables, ii.InstancedDeviceTables), False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_fields(route):
    """build_intersector's Intersector on each route that CPU scenes
    reach: only the dense kernel, and curves merged over it, are
    graph_safe; `primary` is `hit` except on regroup (the worklist over
    the same tables); only regroup has a livegate."""
    scene, build, fields, tables, safe = ROUTES[route]
    d, cfg = build_device_scene(scene(), device="cpu", **build)
    isect = tint.build_intersector(d, cfg, **fields)
    assert tables(isect.tables)
    assert isect.graph_safe is safe
    assert (isect.primary is isect.hit) == (route != "regroup")
    assert (isect.livegate is None) == (route != "regroup")


def test_first_sighting_eager_second_captures_then_replays():
    graphs = bg.BodyGraphs(StandIn())
    calls = []
    step = _step(calls)
    s = _state(8)
    flags = []
    for _ in range(4):
        s, graphed = graphs.run(step, s)
        flags.append(graphed)
    assert flags == [False, True, True, True]
    assert graphs.captures == 1 and graphs.replays == 3
    assert torch.equal(s.x, torch.full((8, 3), 4.0))
    # a new width starts over; the first keeps its graph
    t, graphed = graphs.run(step, _state(4))
    assert not graphed and set(graphs.graphs) == {8}
    assert graphs.run(step, _state(4))[1] and set(graphs.graphs) == {8, 4}
    # consecutive replays need no copy in: the state is the graph's own
    assert s is graphs.graphs[8].state


def test_cache_key_follows_scene_intersector_and_options():
    """for_trace keeps the graphs for the same scene tables, config,
    options and Intersector, and drops them when any of them changes."""
    r, _ = _renderer(32)
    graphs = r.body_graphs
    cpu = torch.device("cpu")
    args = [r.dscene, r.config, r.options, r.intersect]

    def bind(*a):
        assert graphs.for_trace(cpu, 0, *a) is graphs
        graphs.run(_step([]), _state(8))
        graphs.run(_step([]), _state(8))
        return set(graphs.graphs)

    assert bind(*args) == {8}
    assert bind(*args) == {8}  # the same trace keeps its graph

    colors = r.dscene.materials.color.clone()
    changed = [
        (0, r.dscene._replace(materials=r.dscene.materials._replace(
            color=colors))),
        (1, r.config._replace()),
        (2, r.options._replace(bounces=4)),
        (3, Intersector(r.intersect.hit, graph_safe=True)),
    ]
    for i, value in changed:
        a = list(args)
        a[i] = value
        assert graphs.for_trace(cpu, 0, *a) is graphs
        assert not graphs.graphs and not graphs.seen
        assert bind(*a) == {8}
        bind(*args)


def test_kept_state_is_copied_before_a_later_replay():
    graphs = bg.BodyGraphs(StandIn())
    step = _step([])
    s = graphs.run(step, graphs.run(step, _state(8))[0])[0]
    other = graphs.run(step, graphs.run(step, _state(4))[0])[0]
    kept, kept_other = graphs.keep(s), graphs.keep(other)
    assert kept.state.x is s.x
    snapshot = s.x.clone()
    graphs.run(step, _state(8, 10.0))  # copies in and replays at width 8
    assert kept.state.x is not s.x
    assert torch.equal(kept.state.x, snapshot)
    assert torch.equal(s.x, torch.full((8, 3), 11.0))
    assert kept_other.state.x is other.x  # another width's: not copied
    # the trace's outputs leave the buffers; others pass as they are
    fresh = torch.zeros(3)
    out = graphs.release([s.x, fresh, other.alive])
    assert out[1] is fresh
    assert out[0] is not s.x and torch.equal(out[0], s.x)
    assert out[2] is not other.alive


@pytest.mark.parametrize("holder", [di.dense_intersect, STAND_IN],
                         ids=["dense_intersect", "registered"])
def test_replays_add_the_counters_of_the_capture(holder):
    """A body ticks holder.launches once (the dense kernel's counter, or
    the one STAND_IN registered with utils/timing.py); over 5 bodies at
    one width (eager, capture and replay, 3 replays) it reads 5, as over
    5 eager bodies."""
    graphs = bg.BodyGraphs(StandIn())
    calls = []
    step = _step(calls, holder)
    counts = []
    for run in (lambda s: graphs.run(step, s)[0], step):
        holder.launches = 0
        s = _state(16)
        for _ in range(5):
            s = run(s)
        counts.append(holder.launches)
    assert counts == [5, 5]
    assert graphs.graphs[16].deltas == [(holder, "launches", 1)]
    # the stand-in runs the body's Python at the capture and at each of
    # the 4 replays too; the counters do not see the replays
    assert len(calls) == 1 + 1 + 4 + 5


def test_renderer_counters_equal_eager():
    """The intersector's calls, counted by a declared wrapper that ticks
    dense_intersect.launches, and the loop tests: the same per frame with
    graphs as eager."""
    counts = []
    for graphs in (True, False):
        r, st = _renderer(32, graphs)
        inner = r.intersect

        def intersect(*a):
            di.dense_intersect.launches += 1
            return inner(*a)

        r.intersect = Intersector(intersect, graph_safe=True)
        di.dense_intersect.launches = tint.trace_wavefront.host_syncs = 0
        _, rows = _frames(r, st, 3)
        counts.append((di.dense_intersect.launches,
                       tint.trace_wavefront.host_syncs))
        bodies = sum(row["n"] for row in rows)
        assert r.body_graphs.replays == (bodies - 1 if graphs else 0)
    assert counts[0] == counts[1]


def test_failed_capture_leaves_the_width_eager():
    graphs = bg.BodyGraphs(StandIn(fail=True))
    di.dense_intersect.launches = 0
    s = _state(8)
    flags = []
    for _ in range(4):
        s, graphed = graphs.run(_step([]), s)
        flags.append(graphed)
    assert flags == [False] * 4 and graphs.failed == {8}
    assert di.dense_intersect.launches == 4
    assert torch.equal(s.x, torch.full((8, 3), 4.0))


def test_sample_kernel_cost_same_after_capture():
    """Renderer.sample_kernel_cost runs under a TorchDispatchMode, so its
    bodies stay eager: the same counts before and after the graphs are
    captured."""
    r, st = _renderer(32)
    before = r.sample_kernel_cost(st)
    _frames(r, make_trace_state(cornell_scene(), r.params, device="cpu"), 2)
    assert r.body_graphs.captures == 1
    replays = r.body_graphs.replays
    after = r.sample_kernel_cost(st)
    assert r.body_graphs.replays == replays
    assert before["ops"] == after["ops"]
    assert before["kernels"] == after["kernels"]
