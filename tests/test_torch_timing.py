"""The port's spans and counts (julia_raytracer_tpu_torch/utils/timing.py)
on the CPU: the registry on hand-built spans (path keys, self time,
summed counts, the bounded deque of units, the profiled flag, spans
from a second thread, recording against the profiler's clock, no span
in a profiler session that the caller does not own, idle time by span),
then the spans the program opens on the Cornell box: loop tests against
the host-sync counter, live lanes against a plain count, images with
recording on and off, and a train step's bodies forward and backward."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.parallel.mesh import make_mesh, shard_train_step
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, image_size_for, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import cornell_scene
from julia_raytracer_tpu_torch.utils import timing
from julia_raytracer_tpu_torch.utils.timing import span


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _counts(row):
    return {k: v for k, v in row.items() if k not in ("n", "ns", "self_ns")}


def test_paths_self_time_and_counts(monkeypatch):
    clock = iter([-9, -8, 0, 10, 20, 30, 40, 50, 52, 55, 60, 100])
    monkeypatch.setattr(timing, "_now", lambda: next(clock))
    with span("outside"):  # no unit open: counted nowhere
        pass
    with span("frame"):                          # 0 .. 100
        with span("chunk", live=3):              # 10 .. 60
            with span("body", live=2, width=4):  # 20 .. 30
                pass
            with span("body", live=1, width=4):  # 40 .. 50
                pass
            with span("lib_load", libs=1):       # 52 .. 55: set-up
                pass
    (unit,) = timing.units()
    assert unit["name"] == "frame" and unit["start_ns"] == 0
    assert unit["wall_ns"] == 100 and unit["profiled"] is False
    t = unit["table"]
    assert set(t) == {"frame", "frame/chunk", "frame/chunk/body"}
    assert (t["frame"]["n"], t["frame"]["ns"], t["frame"]["self_ns"]) == (1, 100, 50)
    assert (t["frame/chunk"]["ns"], t["frame/chunk"]["self_ns"]) == (50, 27)
    assert _counts(t["frame/chunk"]) == {"live": 3}
    body = t["frame/chunk/body"]
    assert (body["n"], body["ns"], body["self_ns"]) == (2, 20, 20)
    assert _counts(body) == {"live": 3, "width": 8}
    assert timing.setup() == {"lib_load": {"n": 1, "ns": 3, "self_ns": 3,
                                           "libs": 1}}


def test_units_bounded_and_profiled_flag():
    for _ in range(timing.MAX_UNITS + 6):
        with span("frame"):
            pass
    assert len(timing.units()) == timing.MAX_UNITS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("train_step"):
            with span("frame"):  # inside a unit: a plain child
                pass
    units = timing.units()
    assert len(units) == timing.MAX_UNITS
    assert [u["profiled"] for u in units[-2:]] == [False, True]
    assert units[-1]["name"] == "train_step"
    assert set(units[-1]["table"]) == {"train_step", "train_step/frame"}
    starts = [u["start_ns"] for u in units]
    assert starts == sorted(starts)


def test_other_thread_span_lands_under_unit_thread_span():
    def work():
        with span("body", live=1):
            with span("intersect"):
                time.sleep(0.002)

    with span("train_step"):
        with span("backward"):
            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    t = timing.units()[-1]["table"]
    assert t["train_step/backward/body"]["n"] == 1
    assert t["train_step/backward/body/intersect"]["ns"] >= 2_000_000
    # another thread's span is no child for the self time
    assert t["train_step/backward"]["self_ns"] == t["train_step/backward"]["ns"]


def test_many_threads_lose_no_span():
    """More threads than cores, switching often: every span is counted."""
    n_threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with span("train_step"):
            with span("backward"):
                def work():
                    for _ in range(per):
                        with span("body", live=1, width=2):
                            with span("intersect"):
                                pass

                ths = [threading.Thread(target=work) for _ in range(n_threads)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    t = timing.units()[-1]["table"]
    body = t["train_step/backward/body"]
    assert body["n"] == n_threads * per
    assert _counts(body) == {"live": n_threads * per, "width": 2 * n_threads * per}
    assert t["train_step/backward/body/intersect"]["n"] == n_threads * per


def _work():
    x = torch.ones(4096)
    for _ in range(3):
        x = x * 1.0001 + 1.0
    return x


def test_recording_lines_up_with_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with timing.recording() as records, \
            torch.profiler.profile(activities=acts) as prof:
        with span("frame"):
            with span("chunk"):
                _work()
                with span("body", live=5):
                    _work()
    names = [r["name"] for r in records]
    assert names == ["frame", "chunk", "body"]
    by_id = {r["id"]: r for r in records}
    assert records[0]["parent"] is None
    assert by_id[records[2]["parent"]]["name"] == "chunk"
    assert records[2]["path"] == "frame/chunk/body"
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    for r in records:
        e = events[r["name"]]
        assert e.is_user_annotation
        assert abs(t0 + e.time_range.start * 1000 - r["start_ns"]) < 1e6
        assert abs(t0 + e.time_range.end * 1000 - r["end_ns"]) < 1e6
        assert r["start_ns"] <= r["end_ns"]
    # the aggregate table is kept as ever
    assert timing.units()[-1]["table"]["frame/chunk/body"]["live"] == 5


def test_aggregate_mode_stays_out_of_the_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span("frame"):
            with span("chunk"):
                with span("body", live=5):
                    _work()
    names = {e.name for e in prof.events()}
    assert "aten::mul" in names
    assert not names & {"frame", "chunk", "body"}
    assert not any(e.is_user_annotation for e in prof.events())


def _rec(i, path, s, e):
    return {"id": i, "parent": None, "thread": 0, "name": path.rsplit("/")[-1],
            "path": path, "start_ns": s, "end_ns": e}


def test_idle_by_span_synthetic():
    records = [_rec(0, "frame", 0, 1000), _rec(1, "frame/body", 100, 500),
               _rec(2, "frame/body/intersect", 200, 300),
               _rec(3, "frame/fold", 600, 900)]
    device = [(50, 150), (120, 210), (290, 320), (350, 700, False),
              (0, 1000, True),  # a user annotation: not device work
              (950, 1200)]
    idle = timing.idle_by_span(device, records)
    # gaps: 0-50 frame, 210-290 intersect (mid 250), 320-350 body,
    # 700-950 fold (mid 825)
    assert idle == pytest.approx({"frame": 50e-9,
                                  "frame/body/intersect": 80e-9,
                                  "frame/body": 30e-9,
                                  "frame/fold": 250e-9})
    busy = 210 - 50 + 320 - 290 + 700 - 350 + 1000 - 950
    assert sum(idle.values()) == pytest.approx((1000 - busy) * 1e-9)
    # a gap past every span, and a window of its own
    assert timing.idle_by_span([(0, 10)], [_rec(0, "frame", 0, 10)],
                               (0, 30)) == pytest.approx(
        {timing.OUTSIDE: 20e-9})
    assert timing.idle_by_span([], []) == {}


# ---- the program's spans on the Cornell box ---------------------------------


def _render(res, samples=1, **fields):
    scene = cornell_scene()
    params = Params(resolution=res, samples=samples, batch=1, bounces=8,
                    **fields)
    r = Renderer(scene, params, device="cpu")
    st = make_trace_state(scene, params, device="cpu")
    return r, st


def _rows(table, leaf):
    return [row for path, row in table.items() if path.endswith("/" + leaf)]


@pytest.mark.parametrize("res", [32, 128])
def test_frame_spans_and_live_lanes(res, monkeypatch):
    """Each loop test is one host sync; each body's `live` is the count
    its test read, equal to a plain count of the lanes alive as each
    test reads them (128: through a compaction boundary)."""
    plain = []
    real = tint._live_lanes

    def counting(alive):
        plain.append(sum(1 for a in alive.tolist() if a))
        return real(alive)

    monkeypatch.setattr(tint, "_live_lanes", counting)
    r, st = _render(res)
    syncs = tint.trace_wavefront.host_syncs
    r.trace_samples(st)
    syncs = tint.trace_wavefront.host_syncs - syncs
    (unit,) = timing.units()
    t = unit["table"]
    assert unit["name"] == "frame"
    assert sum(row["n"] for row in _rows(t, "loop_test")) == syncs == len(plain)
    # every read goes to the body after it, or to a compaction boundary
    bodies = _rows(t, "body")
    compacts = _rows(t, "compact")
    assert (sum(row["live"] for row in bodies + compacts)
            == sum(plain))
    assert sum(row["width"] for row in bodies) >= sum(plain)
    assert all(row["n"] == 1 for row in (
        t["frame/chunk"], t["frame/chunk/camera"], t["frame/chunk/wavefront"],
        t["frame/chunk/wavefront/primary_hit"], t["frame/chunk/fold"]))
    assert (t["frame/chunk/wavefront/body/intersect"]["n"]
            == t["frame/chunk/wavefront/body"]["n"])
    if res == 128:  # 16,384 lanes: one compaction boundary, cap 4,096
        compact = t["frame/chunk/wavefront/compact"]
        assert (compact["n"], compact["width"], compact["cap"]) == (1, 16384, 4096)
        assert t["frame/chunk/wavefront/expand"]["n"] == 1
    # the spans account for the frame
    assert t["frame"]["self_ns"] <= 0.1 * unit["wall_ns"]


def test_images_equal_with_recording_on_and_off():
    images = []
    for rec in (False, True):
        r, st = _render(32, samples=2)
        if rec:
            with timing.recording() as records:
                r.trace_samples(st)
                r.trace_samples(st)
            assert [x["path"] for x in records].count("frame") == 2
        else:
            r.trace_samples(st)
            r.trace_samples(st)
        images.append(r.get_image(st))
    np.testing.assert_array_equal(images[0], images[1])


def test_train_step_bodies_forward_and_backward():
    scene = cornell_scene()
    params = Params(resolution=16, samples=1, bounces=8)
    r = Renderer(scene, params, device="cpu")
    w, h = image_size_for(r.camera, 16)
    step = shard_train_step(make_mesh("cpu"), r.dscene, r.config, r.options,
                            r.cam_arrays, w, h)
    mats = r.dscene.materials
    pixel_ids = torch.arange(w * h, dtype=torch.int32)
    step(mats.color, mats.emission, pixel_ids,
         torch.full((w * h, 3), 0.5), 1, seed=3)
    unit = timing.units()[-1]
    t = unit["table"]
    assert unit["name"] == "train_step"
    fwd = [row["n"] for path, row in t.items()
           if path.startswith("train_step/forward/") and path.endswith("/body")]
    bwd = [row["n"] for path, row in t.items()
           if path.startswith("train_step/backward/") and path.endswith("/body")]
    assert sum(fwd) == 9 and sum(bwd) == 9
    assert {"train_step/forward", "train_step/backward",
            "train_step/update"} <= set(t)
    assert t["train_step"]["self_ns"] <= 0.1 * unit["wall_ns"]


def test_device_span_defers_tensor_counts_to_units():
    """A device_span's tensor counts and its clock stay tensors until
    units() reads them; on the CPU its device_ns is the block's own
    time."""
    with span("frame"):
        with span("body"):
            with timing.device_span("precull", "cpu", groups=2) as sp:
                sp.add(candidates=torch.tensor(5))
            with timing.device_span("precull", "cpu", groups=3) as sp:
                sp.add(candidates=torch.tensor(7, dtype=torch.int32))
    raw = timing._state.units[-1]["table"]["frame/body/precull"]
    assert [k for k, _ in raw[4]] == ["candidates", "device_ns"] * 2
    (unit,) = timing.units()
    row = unit["table"]["frame/body/precull"]
    assert _counts(row)["groups"] == 5 and row["candidates"] == 12
    assert 0 < row["device_ns"] <= row["ns"]
    assert timing._state.units[-1]["table"]["frame/body/precull"][4] == []
    assert timing.units()[0]["table"]["frame/body/precull"]["candidates"] == 12


def _flake_renderer(monkeypatch, res=16):
    """The sphereflake at size factor 2, forced through the full cell's
    route (two levels, ground and lights in the soup, spheres as work
    items)."""
    from julia_raytracer_tpu_torch.render import scene_device
    from julia_raytracer_tpu_torch.testing import sphereflake_scene

    monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
    scene = sphereflake_scene(2, 4)
    params = Params(resolution=res, samples=4, batch=1, bounces=8,
                    hybrid_budget=8)
    r = Renderer(scene, params, device="cpu")
    assert len(r.config.inst_tables.wi_sup) == 91
    return r, make_trace_state(scene, params, device="cpu")


def test_instanced_spans_count_the_precull(monkeypatch):
    """`precull` and `inst_walk` sit under each body's `intersect`; the
    spans' `candidates` are the plain cull's finite keys, `groups` x
    `items` the keys' shape; their counts are read after the frame, and
    the loop's host syncs are those of a frame without the spans."""
    from julia_raytracer_tpu_torch.ops import instanced_intersect as ii

    calls = []
    real = ii.precull

    def recording_precull(ro, rd, tmin, tmax, items, group=ii.GROUP_RAYS):
        keys = ii.candidate_keys_plain(ro, rd, tmin, tmax, items.boxes, group)
        calls.append((keys.shape, int(torch.isfinite(keys).sum())))
        return real(ro, rd, tmin, tmax, items, group)

    monkeypatch.setattr(ii, "precull", recording_precull)
    r, st = _flake_renderer(monkeypatch)
    syncs = tint.trace_wavefront.host_syncs
    r.trace_samples(st)
    syncs = tint.trace_wavefront.host_syncs - syncs
    raw = timing._state.units[-1]["table"]
    assert any(row[4] for path, row in raw.items()
               if path.endswith("/precull"))  # not read inside the frame
    (unit,) = timing.units()
    t = unit["table"]
    body = "frame/chunk/wavefront/body/intersect/"
    assert {body + "precull", body + "inst_walk"} <= set(t)
    pre = _rows(t, "precull")
    walk = _rows(t, "inst_walk")
    assert sum(row["n"] for row in pre) == sum(row["n"] for row in walk) == len(calls)
    assert sum(row["candidates"] for row in pre) == sum(c for _, c in calls)
    assert sum(row["groups"] for row in pre) == sum(s[0] for s, _ in calls)
    assert sum(row["keys"] for row in pre) == sum(s[0] * s[1] for s, _ in calls)
    assert all(row["items"] == 91 * row["n"] for row in pre)
    assert all(0 < row["device_ns"] <= row["ns"] for row in pre + walk)

    # the same frame with plain spans in their place: the same host syncs
    monkeypatch.setattr(timing, "device_span",
                        lambda name, device, **counts: _PlainSpan(name))
    r2, st2 = _flake_renderer(monkeypatch)
    plain = tint.trace_wavefront.host_syncs
    r2.trace_samples(st2)
    assert tint.trace_wavefront.host_syncs - plain == syncs
    np.testing.assert_array_equal(r.get_image(st), r2.get_image(st2))


class _PlainSpan(span):
    __slots__ = ()

    def add(self, **counts):
        pass
