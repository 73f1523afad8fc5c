"""Progressive rendering of a scene of quads, lines and points: the render
mode (benchmark/modes/render.py), with the scene handed to the program
with its lines, points and radii, and the output check against the plain
reference that traces them (benchmark/reference/curves.py).

Before the first frame it checks that the program's renderer on the card
merges the curves through the culled walk (its intersector's `curves`);
a program without that route would sweep every element of every frame,
so the run stops there, non-zero. The frames, the window, the traced
span and the output check are render.py's; on the card the traced span
ends with as many frames again under the profiler, in which the device
time of the walk kernel is read by its name (`walk_kernel_seconds`: the
profile that render.py's traced span keeps lists ten ops, and the walk
is shorter than those).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from benchmark.modes.common import Run, build_scene, profile_units
from benchmark.modes.render import check_pixels, compare


def to_program_scene(desc: dict):
    """The description as the program's SceneData: render.py's scene,
    each shape with its quads, lines, points and radii."""
    from julia_raytracer_tpu_torch.scene.types import (
        MATERIAL_TYPES, CameraData, InstanceData, MaterialData, SceneData,
        ShapeData,
    )

    def shape(s):
        kw = {k: np.asarray(s[k], np.int32) for k in ("quads", "lines", "points")
              if k in s}
        if "radius" in s:
            kw["radius"] = np.asarray(s["radius"], np.float32)
        return ShapeData(positions=np.asarray(s["positions"], np.float32), **kw)

    cam = desc["camera"]
    return SceneData(
        cameras=[CameraData(frame=np.asarray(cam["frame"], np.float32),
                            lens=cam["lens"], film=cam["film"],
                            aspect=cam["aspect"], focus=cam["focus"],
                            aperture=cam["aperture"], name="camera")],
        shapes=[shape(s) for s in desc["shapes"]],
        materials=[MaterialData(type=MATERIAL_TYPES[m["type"]],
                                color=np.asarray(m["color"], np.float32),
                                emission=np.asarray(m["emission"], np.float32),
                                roughness=m["roughness"], ior=m["ior"])
                   for m in desc["materials"]],
        instances=[InstanceData(frame=np.asarray(i["frame"], np.float32),
                                shape=i["shape"], material=i["material"])
                   for i in desc["instances"]],
    )


# the walk kernel (the program's csrc/curve_intersect.cu) in the device trace
WALK_KERNEL = "::curve_walk_kernel("


def walk_kernel_seconds(run: Run, one_unit, units: int) -> None:
    """`units` frames under torch.profiler (a session that records no
    device time is tried again, up to three in all): the device seconds
    of the ops named WALK_KERNEL go to run.counters["walk_kernel_s"], the
    frames to run.counters["walk_kernel_units"]."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(units):
                one_unit()
            run.sync()
        events = prof.events()
        if not any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in events):
            continue
        run.counters["walk_kernel_s"] = sum(
            e.time_range.elapsed_us() for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and WALK_KERNEL in e.name) / 1e6
        run.counters["walk_kernel_units"] = units
        return


def reference(desc, traffic, pixels, n_frames, seed, width, height, device,
              dtype=None):
    import torch

    from benchmark.reference import curves

    scene = curves.Scene(desc, device, dtype or torch.float32)
    mean, hits = curves.render_pixels(
        scene, desc["camera"], torch.as_tensor(pixels, device=device),
        n_frames, seed, width, height, traffic["bounces"], traffic["clamp"])
    return mean.cpu().numpy(), hits.cpu().numpy()


def run(r: Run) -> None:
    import torch

    from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
    from julia_raytracer_tpu_torch.render.integrator import trace_wavefront
    from julia_raytracer_tpu_torch.render.renderer import (
        Params, Renderer, make_trace_state,
    )

    tr = r.traffic
    cuda = r.device == "cuda"
    if cuda:
        r.sync = torch.cuda.synchronize
    with r.span("scene_gen"):
        desc = build_scene(r.config)
        scene = to_program_scene(desc)
    params = Params(resolution=tr["resolution"], samples=1 << 30,
                    batch=tr["batch"], bounces=tr["bounces"],
                    sampler=tr["sampler"], clamp=tr["clamp"], seed=r.seed)
    with r.span("scene_build"):
        renderer = Renderer(scene, params, device=r.device)
    if cuda and getattr(renderer.intersect, "curves", None) is None:
        raise SystemExit("render_curves: the program's renderer has no "
                         "culled curve route on the card")
    state = make_trace_state(scene, params, device=r.device)

    calls = [0]

    def frame():
        renderer.trace_samples(state)
        r.sync()
        calls[0] += 1

    with r.span("warm"):
        for _ in range(tr["warm_frames"]):
            frame()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    times = []
    while True:
        f0 = time.perf_counter()
        frame()
        f1 = time.perf_counter()
        times.append(f1 - f0)
        if f1 - t0 >= r.seconds:
            break
    window_s = f1 - t0
    n_pixels = state.width * state.height
    frames = len(times)
    p90 = sorted(times)[math.ceil(0.9 * frames) - 1]
    r.end_to_end = {
        "mpaths_per_s": n_pixels * frames / window_s / 1e6,
        "frame_ms_p90": p90 * 1e3,
        "setup_s": setup_s,
    }
    if r.trace:
        def counters():
            return {"host_syncs": trace_wavefront.host_syncs
                    + rg.regroup_intersect.host_syncs}

        profile_units(r, frame, tr["trace_frames"], counters)
        if cuda:
            walk_kernel_seconds(r, frame, tr["trace_frames"])
    if cuda:
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # ---- output check: the program's state, then the reference
    n_frames = state.samples
    expected = calls[0]
    pixels = check_pixels(r.seed, n_pixels, tr["check_pixels"])
    idx = torch.as_tensor(pixels, device=r.device)
    prog = {k: getattr(state, k)[idx].double().cpu().numpy()
            for k in ("image", "albedo", "normal")}
    prog["hits"] = state.hits[idx].long().cpu().numpy()
    width, height = state.width, state.height
    del renderer, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.attempted = len(pixels)
    r.check("frames_gap", abs(n_frames - expected))
    if r.checks[-1][3]:
        # the program's samples are the frames run: follow them
        ref_mean, ref_hits = reference(desc, tr, pixels, expected, r.seed,
                                       width, height, r.device)
        for name, value in compare(prog, ref_mean, ref_hits, expected).items():
            r.check(name, value)
    r.failed = 0 if all(c[3] for c in r.checks) else len(pixels)
