"""What both modes share: the run's context, the scene handed to the
program, the host-clock spans, and the profiler's reading of a span.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def build_scene(config: dict) -> dict:
    """The scene description of a configuration: its generator
    (benchmark/scenes/<scene>.py) called with its arguments."""
    import importlib

    mod = importlib.import_module("benchmark.scenes." + config["scene"])
    return mod.build(**config.get("scene_args", {}))


def to_program_scene(desc: dict):
    """The description as the program's SceneData."""
    from julia_raytracer_tpu_torch.scene.types import (
        MATERIAL_TYPES, CameraData, InstanceData, MaterialData, SceneData,
        ShapeData,
    )

    cam = desc["camera"]
    return SceneData(
        cameras=[CameraData(frame=np.asarray(cam["frame"], np.float32),
                            lens=cam["lens"], film=cam["film"],
                            aspect=cam["aspect"], focus=cam["focus"],
                            aperture=cam["aperture"], name="camera")],
        shapes=[ShapeData(quads=np.asarray(s["quads"], np.int32),
                          positions=np.asarray(s["positions"], np.float32))
                for s in desc["shapes"]],
        materials=[MaterialData(type=MATERIAL_TYPES[m["type"]],
                                color=np.asarray(m["color"], np.float32),
                                emission=np.asarray(m["emission"], np.float32),
                                roughness=m["roughness"], ior=m["ior"])
                   for m in desc["materials"]],
        instances=[InstanceData(frame=np.asarray(i["frame"], np.float32),
                                shape=i["shape"], material=i["material"])
                   for i in desc["instances"]],
    )


@dataclass
class Run:
    """One run: what run.py read and what the mode reports back."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter at process start
    limits: dict = field(default_factory=dict)  # benchmark/limits/<cell>.json
    spans: dict = field(default_factory=dict)  # host-clock spans, seconds
    counters: dict = field(default_factory=dict)
    profile: dict | None = None  # the profiler's reading of the traced span
    end_to_end: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)  # (name, value, limit, ok)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    sync: Callable[[], None] = lambda: None

    def check(self, name: str, value: float) -> None:
        """Hold `value` to the cell's limit of that name (value <= limit)."""
        limit = self.limits[name]
        self.checks.append((name, value, limit, bool(value <= limit)))

    def span(self, name: str):
        run = self

        class _Span:
            def __enter__(self):
                run.sync()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                run.sync()
                run.spans[name] = run.spans.get(name, 0.0) + (
                    time.perf_counter() - self.t0)

        return _Span()


# ---- the profiler's reading of a span ---------------------------------------

# the program's hand-written kernels: substrings of their device functions'
# names as the profiler reports them (a frozen copy of the table in the
# program's profile_path.py)
OWN_KERNELS = {
    "dense_intersect": ("::dense_intersect_kernel<",),
    "lane_compact": ("::count_kernel(", "::compact_kernel("),
    "lane_expand": ("::expand_kernel(",),
    "worklist_intersect": ("::worklist_intersect_kernel(",),
    "regroup_pack": ("::pack_kernel(",),
    "regroup_tritest": ("::tritest_kernel(",),
    "regroup_unpack": ("::unpack_kernel(",),
    "instanced_intersect": ("::instanced_intersect_kernel(",),
    "candidate_cull": ("::candidate_cull_kernel(",),
}


def own_kernel(name: str) -> bool:
    return any(part in name for parts in OWN_KERNELS.values() for part in parts)


def _merge(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(events, t0_us: float, t1_us: float, units: int,
                 wall_s: float) -> dict | None:
    """What a profiler session over `units` frames or steps recorded:
    device ms in all and in the program's own kernels, device launches,
    the union of device intervals (busy_s) against the traced window,
    the ten device ops that took most time, and the idle time between
    device ops by what the host was doing (the innermost host op at each
    gap's middle). `wall_s`: the same units unprofiled, for the idle
    share. None when the session recorded no device time."""
    import bisect
    from collections import defaultdict

    import torch

    dev_iv, cpu = [], []
    by_name = defaultdict(float)
    own_us = 0.0
    for e in events:
        s, d = e.time_range.start, e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_iv.append((s, s + d))
            by_name[e.name] += d
            if own_kernel(e.name):
                own_us += d
        else:
            cpu.append((s, s + d, e.name))
    device_us = sum(e - s for s, e in dev_iv)
    if not dev_iv or device_us <= 0:
        return None
    busy = _merge(dev_iv)
    busy_us = sum(e - s for s, e in busy)
    lo = min(t0_us, busy[0][0])
    hi = max(t1_us, busy[-1][1])
    gaps = [(lo, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps.append((busy[-1][1], hi))
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(starts, mid)
        best = None
        for j in range(k - 1, max(-1, k - 400), -1):
            s, e, name = cpu[j]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        idle[best[2] if best else "(no host op)"] += (g1 - g0) / 1e6
    return {
        "units": units,
        "device_ms": device_us / 1e3,
        "own_ms": own_us / 1e3,
        "launches": len(dev_iv),
        "wall_ms": wall_s * 1e3,
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": [[n[:200], us / 1e6] for n, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[:200], s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def profile_units(run: Run, one_unit: Callable[[], None], units: int,
                  counters: Callable[[], dict]) -> None:
    """The traced span: `units` frames or steps unprofiled (host clock,
    the program's counters), then as many under torch.profiler; an empty
    session is tried again, up to three times in all."""
    import torch

    before = counters()
    run.sync()
    t0 = time.perf_counter()
    for _ in range(units):
        one_unit()
    run.sync()
    wall_s = time.perf_counter() - t0
    after = counters()
    run.counters = {k: after[k] - before[k] for k in after}
    run.counters["units"] = units
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for _ in range(3 if run.device == "cuda" else 1):
        with torch.profiler.profile(activities=acts) as prof:
            t0_us = time.perf_counter()
            for _ in range(units):
                one_unit()
            run.sync()
            t1_us = time.perf_counter()
        events = prof.events()
        starts = [e.time_range.start for e in events]
        if not starts:
            continue
        # the profiler's clock: place the host-clock window on it
        span_us = (t1_us - t0_us) * 1e6
        first = min(starts)
        run.profile = read_profile(events, first, first + span_us, units,
                                   wall_s)
        if run.profile is not None:
            return
