"""Progressive rendering of a scene lit by many emissive quads: the render
mode (benchmark/modes/render.py), with the output check against the
plain reference whose light pdf works in blocks
(benchmark/reference/lights.py).

Before the first frame it checks that the program's renderer on the card
takes the route this mode measures: the worklist kernel, no sort, and a
light pdf that marches (more emissive elements than the exact sweep
takes) with a budget of MARCH_STEPS; a program that routes otherwise
would measure something else, so the run stops there, non-zero. The
frames, the window, the traced span and the output check are render.py's;
on the card the traced span ends with as many frames again under the
profiler and under the program's cost count
(benchmark/metrics/_worklist_cost.py `measure`), in which the worklist
kernel's device time is read by its name, beside the least time its
calls could take.

The reference lists each light's quads for sampling in the program's
order (`light_order`), so that a lane of the reference and the program's
lane of the same (pixel, sample, seed) take the same quad.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from benchmark.metrics import _worklist_cost
from benchmark.modes.common import Run, build_scene, profile_units, to_program_scene
from benchmark.modes.render import check_pixels, compare

# the march's budget this mode measures (lights.auto_light_pdf_steps for
# more than four lights)
MARCH_STEPS = 8


def check_route(renderer) -> None:
    """Stop the run unless the renderer takes the worklist kernel, no
    sort, and a march of MARCH_STEPS extra steps."""
    from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
    from julia_raytracer_tpu_torch.render import lights

    opts = renderer.options
    elems = renderer.config.light_counts.total_inst_elems
    route = {"worklist": isinstance(renderer.intersect.tables,
                                    wl.WorklistTables),
             "no sort": not opts.sort_rays,
             "march": elems > lights.EXACT_ELEMS,
             f"{MARCH_STEPS} steps": opts.light_pdf_extra_steps == MARCH_STEPS}
    missing = [k for k, ok in route.items() if not ok]
    if missing:
        raise SystemExit("render_lights: the program's renderer does not "
                         f"take the route this mode measures: {missing}")


def light_order(renderer) -> list[np.ndarray]:
    """Each light's quads' centroids [count, 3] in the order the program's
    light table lists them for sampling."""
    lt = renderer.dscene.lights
    n = renderer.config.light_counts.n_instance
    cen = lt.elem_verts.view(-1, 4, 3).double().mean(1).cpu().numpy()
    off = lt.inst_cdf_offset.cpu().numpy()[:n]
    cnt = lt.inst_cdf_count.cpu().numpy()[:n]
    return [cen[o:o + c] for o, c in zip(off, cnt)]


def reference(desc, traffic, pixels, n_frames, seed, width, height, device,
              order, dtype=None):
    import torch

    from benchmark.reference import lights, tracer

    scene = lights.Scene(desc, device, dtype or torch.float32, order)
    mean, hits = tracer.render_pixels(
        scene, desc["camera"], torch.as_tensor(pixels, device=device),
        n_frames, seed, width, height, traffic["bounces"], traffic["clamp"])
    return mean.cpu().numpy(), hits.cpu().numpy()


def params(traffic, seed, **overrides):
    """The program's Params at the traffic's numbers; `overrides` set
    other fields."""
    from julia_raytracer_tpu_torch.render.renderer import Params

    return Params(resolution=traffic["resolution"], samples=1 << 30,
                  batch=traffic["batch"], bounces=traffic["bounces"],
                  sampler=traffic["sampler"], clamp=traffic["clamp"],
                  seed=seed, **overrides)


def program_pixels(state, pixels) -> dict:
    """The program's running means and hit counts at pixel ids `pixels`."""
    import torch

    idx = torch.as_tensor(pixels, device=state.image.device)
    prog = {k: getattr(state, k)[idx].double().cpu().numpy()
            for k in ("image", "albedo", "normal")}
    prog["hits"] = state.hits[idx].long().cpu().numpy()
    return prog


def run(r: Run) -> None:
    import torch

    from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
    from julia_raytracer_tpu_torch.render.integrator import trace_wavefront
    from julia_raytracer_tpu_torch.render.renderer import (
        Renderer, make_trace_state,
    )

    tr = r.traffic
    cuda = r.device == "cuda"
    if cuda:
        r.sync = torch.cuda.synchronize
    with r.span("scene_gen"):
        desc = build_scene(r.config)
        scene = to_program_scene(desc)
    p = params(tr, r.seed)
    with r.span("scene_build"):
        renderer = Renderer(scene, p, device=r.device)
    check_route(renderer)
    state = make_trace_state(scene, p, device=r.device)

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
            _worklist_cost.measure(r, frame, tr["trace_frames"])
    if cuda:
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # ---- output check: the program's state, then the reference
    n_frames = state.samples
    expected = calls[0]
    pixels = check_pixels(r.seed, n_pixels, tr["check_pixels"])
    prog = program_pixels(state, pixels)
    order = light_order(renderer)
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
                                       width, height, r.device, order)
        for name, value in compare(prog, ref_mean, ref_hits, expected).items():
            r.check(name, value)
    r.failed = 0 if all(c[3] for c in r.checks) else len(pixels)
