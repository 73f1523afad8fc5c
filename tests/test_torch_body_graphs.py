"""The bookkeeping of render/body_graphs.py on the CPU: eligibility (and
the `graph_safe` and `primary` of each route's Intersector), the
sightings of a lane width, the cache key, states kept out of a graph's
buffers, the counters a replay adds and the device_spans it files.
`StandIn` takes the place of the CUDA capture, as a capture behaves: the
body's Python runs once at the capture and leaves the buffers as they
were, and each replay does the body's tensor work while the program's
counters stay as they were and its spans only stamp the capture's
record."""

import copy
import types
from contextlib import contextmanager
from typing import NamedTuple

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from julia_raytracer_tpu_torch.ops import curve_intersect as cw
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


@contextmanager
def _replaying():
    """The capture's Python run again as a replay's tensor work (a replay
    runs no Python): no span opened inside the block is timed or counted,
    and the device_spans stamp the same slots of the capture's record
    through a copy of its CapturedSpans, whose notes are dropped."""
    st, local = timing._state, timing._state.local
    saved = (local.__dict__.get("stack"), st.unit, st.records)
    real = timing.capturing

    def again(spans):
        twin = copy.copy(spans)
        twin.spans, twin.used = [], 0
        return real(twin)

    local.stack, st.unit, st.records = [], None, None
    timing.capturing = again
    try:
        yield
    finally:
        timing.capturing = real
        st.unit, st.records = saved[1:]
        if saved[0] is None:
            del local.stack
        else:
            local.stack = saved[0]


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
            with _replaying():
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
                  _tables(ii.InstancedDeviceTables), True),
    "hybrid": (lambda: hybrid_scene(4, 4, 3, 12),
               dict(instancing=True, hybrid_budget=300), {},
               _tables(wl.WorklistTables, ii.InstancedDeviceTables), False),
    "hybrid_dense": (lambda: hybrid_scene(2, 4, 3, 12),
                     dict(instancing=True, hybrid_budget=100), {},
                     _tables(di.DenseTable, ii.InstancedDeviceTables), True),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_fields(route):
    """build_intersector's Intersector on each route that CPU scenes
    reach: the dense kernel, curves merged over it, the work items and a
    hybrid whose soup takes the dense kernel (70 quads) are graph_safe;
    the worklist, regroup, and a hybrid over a worklist soup (262 quads)
    are not; `primary` is `hit` except on regroup (the worklist over the
    same tables); only regroup has a livegate."""
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


def _span_step(holder=di.dense_intersect):
    """A body that ticks holder.launches and, inside `intersect`, opens a
    device_span `precull` with an integer count and two tensor counts of
    its state."""
    def step(s):
        holder.launches += 1
        with timing.span("intersect"):
            with timing.device_span("precull", s.x.device, groups=3) as sp:
                x = s.x + 1.0
                sp.add(candidates=(x > 2.0).sum(),
                       tested=x[:, 0].sum().to(torch.int32))
        return S(s.alive, x)

    return step


def _span_rows(bodies, graphs):
    """`bodies` bodies of _span_step at width 8 in one frame, each in a
    `body` span, from graphs or eager -> the frame's rows."""
    step = _span_step()
    s = _state(8)
    with timing.span("frame"):
        for _ in range(bodies):
            with timing.span("body"):
                s = graphs.run(step, s)[0] if graphs else step(s)
    return timing.units()[-1]["table"]


@pytest.mark.parametrize("replays", [1, 4])
def test_replays_file_the_device_spans_of_the_capture(replays):
    """After an eager body, the capture and `replays` more replays, the
    `precull` row holds what replays + 2 eager bodies leave: the same n,
    integer count and tensor counts, and a device_ns; the captured body
    adds nothing at the capture itself (its replay files it), and the
    plain `intersect` span counts the eager and captured bodies."""
    graphs = bg.BodyGraphs(StandIn())
    got = _span_rows(replays + 2, graphs)
    want = _span_rows(replays + 2, None)
    assert graphs.captures == 1 and graphs.replays == replays + 1
    key = "frame/body/intersect/precull"
    for field in ("n", "groups", "candidates", "tested"):
        assert got[key][field] == want[key][field]
    assert want[key]["n"] == replays + 2
    assert want[key]["candidates"] == 24 * replays  # x > 2 from body 3
    assert got[key]["device_ns"] > 0 and want[key]["device_ns"] > 0
    assert got["frame/body/intersect"]["n"] == 2
    # one record a graph: 1 clock slot and 2 count slots
    spans = graphs.graphs[8].spans
    assert spans.used == 3
    assert [(p, c) for p, c, *_ in spans.spans] == [("intersect/precull",
                                                     {"groups": 3})]


def test_body_without_device_span_keeps_no_record(monkeypatch):
    """A captured body that opens no device_span keeps no record, and its
    replays copy and file nothing."""
    filed = []
    monkeypatch.setattr(timing.CapturedSpans, "file",
                        lambda self, record: filed.append(record))
    graphs = bg.BodyGraphs(StandIn())
    s = _state(8)
    with timing.span("frame"):
        for _ in range(4):
            with timing.span("body"):
                s = graphs.run(_step([]), s)[0]
    assert graphs.replays == 3 and graphs.graphs[8].spans is None
    assert not filed
    assert set(timing.units()[-1]["table"]) == {"frame", "frame/body"}


def test_capture_outside_a_unit_keeps_its_spans():
    """A width captured where no unit is open (under a span that is not
    a unit, whose rows go nowhere) still notes its device_spans and keeps
    the record its stamps write: the replays in a later frame file them."""
    graphs = bg.BodyGraphs(StandIn())
    step = _span_step()
    s = _state(8)
    with timing.span("warm"):
        for _ in range(2):
            with timing.span("body"):
                s = graphs.run(step, s)[0]
    spans = graphs.graphs[8].spans
    assert spans is not None and spans.used == 3
    with timing.span("frame"):
        for _ in range(3):
            with timing.span("body"):
                s = graphs.run(step, s)[0]
    row = timing.units()[-1]["table"]["frame/body/intersect/precull"]
    assert row["n"] == 3 and row["groups"] == 9
    assert row["candidates"] == 72 and row["device_ns"] > 0


def test_capture_past_the_record_stays_eager(monkeypatch):
    """A body whose device_spans need more slots than the record holds
    cannot be captured: its width stays eager and its spans count."""
    monkeypatch.setattr(timing.CapturedSpans, "SLOTS", 2)
    graphs = bg.BodyGraphs(StandIn())
    rows = _span_rows(4, graphs)
    assert graphs.failed == {8} and graphs.captures == 0
    assert rows["frame/body/intersect/precull"]["n"] == 4


def _hybrid_frames(graphs, frames=3):
    """`frames` frames of the small hybrid whose soup takes the dense
    kernel (70 quads, 3 work items), from graphs or eager -> (image,
    AOVs and hits; the frames' precull rows summed by field; the body
    rows' n and graphed)."""
    from julia_raytracer_tpu_torch.render import scene_device

    real = scene_device._should_instance
    scene_device._should_instance = lambda s: True
    try:
        scene = hybrid_scene(2, 4, 3, 12)
        p = Params(resolution=32, samples=1 << 20, batch=1, bounces=8,
                   seed=4, hybrid_budget=100)
        r = Renderer(scene, p, device="cpu")
    finally:
        scene_device._should_instance = real
    assert r.intersect.graph_safe
    r.body_graphs = bg.BodyGraphs(StandIn()) if graphs else None
    st = make_trace_state(scene, p, device="cpu")
    t0 = timing._now()
    for _ in range(frames):
        r.trace_samples(st)
    tables = [u["table"] for u in timing.units() if u["start_ns"] >= t0]
    sums = {}
    for t in tables:
        for path, row in t.items():
            name = path.rsplit("/", 1)[-1]
            if name in ("precull", "inst_walk", "body"):
                for k, v in row.items():
                    sums[name, k] = sums.get((name, k), 0) + v
    return (st.image, st.albedo, st.normal, st.hits), sums, r.body_graphs


def test_hybrid_replays_equal_eager_with_their_spans():
    """The hybrid over a dense-kernel soup, 3 frames at 1,024 lanes: the
    graphed frames equal eager ones bit for bit, and the precull and
    inst_walk rows count what eager frames count (n, groups, items, keys,
    candidates, tested, spills), with a device_ns, though most bodies are
    replays."""
    got, got_sums, graphs = _hybrid_frames(True)
    want, want_sums, _ = _hybrid_frames(False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert graphs.captures == 1 and not graphs.failed
    assert got_sums["body", "n"] == want_sums["body", "n"]
    assert got_sums["body", "graphed"] == got_sums["body", "n"] - 1
    for k in ("n", "groups", "items", "keys", "candidates", "tested",
              "spills"):
        assert got_sums["precull", k] == want_sums["precull", k], k
    assert got_sums["inst_walk", "n"] == want_sums["inst_walk", "n"]
    for name in ("precull", "inst_walk"):
        assert got_sums[name, "device_ns"] > 0
        assert want_sums[name, "device_ns"] > 0


def _curve_frames(graphs, frames=3):
    """`frames` frames of the SPD tree at size factor 3 (15 lines and 15
    points over 4 quads, the dense kernel's route with the curve walk),
    from graphs or eager -> (image, AOVs and hits; the frames' precull,
    curve_walk and body rows summed by field; the curve kernel's launches
    over the frames; the graphs)."""
    from benchmark.modes.render_curves import to_program_scene
    from benchmark.scenes import spd_tree

    scene = to_program_scene(spd_tree.build(3))
    p = Params(resolution=32, samples=1 << 20, batch=1, bounces=8, seed=4)
    r = Renderer(scene, p, device="cpu")
    assert r.intersect.graph_safe and r.intersect.curves is not None
    r.body_graphs = bg.BodyGraphs(StandIn()) if graphs else None
    st = make_trace_state(scene, p, device="cpu")
    launches = cw.curve_intersect_kernel.launches
    t0 = timing._now()
    for _ in range(frames):
        r.trace_samples(st)
    sums = {}
    for u in timing.units():
        if u["start_ns"] < t0:
            continue
        for path, row in u["table"].items():
            name = path.rsplit("/", 1)[-1]
            if name in ("precull", "curve_walk", "body"):
                for k, v in row.items():
                    sums[name, k] = sums.get((name, k), 0) + v
    return ((st.image, st.albedo, st.normal, st.hits), sums,
            cw.curve_intersect_kernel.launches - launches, r.body_graphs)


def test_curve_replays_file_their_spans_and_counter(monkeypatch):
    """The culled curve route (forced onto the CPU, its kernel's launch
    stood in for by a tick of curve_intersect_kernel.launches around the
    plain walk) over 3 frames at 1,024 lanes: the graphed frames equal
    eager ones bit for bit; the replays file the `curve_walk` span (n,
    rays, elements, candidates, tested, a device_ns) and the `precull`
    span as eager bodies do, and add the kernel's counter as eager bodies
    tick it."""
    monkeypatch.setattr(tint, "CURVE_WALK_DEVICES", ("cpu",))
    plain = cw.curve_walk_plain

    def launching(*args, **kw):
        cw.curve_intersect_kernel.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(cw, "curve_walk_plain", launching)
    got, got_sums, got_launches, graphs = _curve_frames(True)
    want, want_sums, want_launches, _ = _curve_frames(False)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert graphs.captures == 1 and not graphs.failed
    assert got_sums["body", "graphed"] == got_sums["body", "n"] - 1
    for k in ("n", "rays", "elements", "candidates", "tested"):
        assert got_sums["curve_walk", k] == want_sums["curve_walk", k], k
    for k in ("n", "groups", "items", "keys", "candidates", "tested",
              "spills"):
        assert got_sums["precull", k] == want_sums["precull", k], k
    assert want_sums["curve_walk", "n"] == want_sums["body", "n"] + 3
    for name in ("precull", "curve_walk"):
        assert got_sums[name, "device_ns"] > 0
        assert want_sums[name, "device_ns"] > 0
    assert got_launches == want_launches == want_sums["curve_walk", "n"]
