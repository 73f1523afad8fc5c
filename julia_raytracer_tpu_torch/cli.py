"""Command-line entry point of the port: the JAX package's flags (the
reference's and its extras) and progress/ETC lines, rendering on the card
(port of julia_raytracer_tpu/cli.py).

Usage:  python -m julia_raytracer_tpu_torch.cli --scene scene.json \\
            --output out.png --sampler path --samples 64 --resolution 512

`--device` (default `cuda`) is the one flag the JAX CLI lacks: the port
runs on the card and raises without one; `--device cpu` runs the plain
versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, TraceState, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import resolve_device
from julia_raytracer_tpu_torch.scene.loader import load_scene
from julia_raytracer_tpu_torch.utils.imgio import save_png
from julia_raytracer_tpu_torch.utils import timing
from julia_raytracer_tpu_torch.utils.timing import fence, format_seconds

SAMPLERS = ("path", "naive")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jtrace-torch",
        description="Yocto-style path tracer on PyTorch and CUDA",
    )
    p.add_argument("--scene", default="tests/scene.json", help="scene filename")
    p.add_argument("--output", default="tests/test_scene.png", help="output image")
    p.add_argument("--camera", default="", help="camera name")
    p.add_argument("--addsky", action="store_true", help="add a procedural sun-sky environment")
    p.add_argument("--envname", default="", help="add an environment light from this HDR/PNG panorama")
    p.add_argument("--resolution", type=int, default=1280, help="image resolution")
    p.add_argument("--samples", type=int, default=512, help="number of samples")
    p.add_argument("--bounces", type=int, default=8, help="number of bounces")
    p.add_argument("--denoise", action="store_true",
                   help="denoise image (AOV-guided à-trous)")
    p.add_argument("--noparallel", action="store_true", help="disable threading")
    p.add_argument("--highqualitybvh", action="store_true", help="use SAH BVH build")
    p.add_argument("--envhidden", action="store_true", help="hide environment")
    p.add_argument("--tentfilter", action="store_true", help="tent image filter")
    p.add_argument("--sampler", default="path", choices=SAMPLERS, help="integrator")
    p.add_argument("--clamp", type=float, default=10.0, help="radiance clamp")
    p.add_argument("--nocaustics", action="store_true", help="disable caustics")
    p.add_argument("--batch", type=int, default=1, help="samples per batch")
    p.add_argument("--bvhstacksize", type=int, default=128,
                   help="kept for reference parity; nothing reads it")
    p.add_argument("--seed", type=int, default=0, help="RNG seed (deterministic)")
    p.add_argument("--resume", default="", help="resume from checkpoint .npz")
    p.add_argument("--checkpoint", default="", help="write checkpoint .npz per batch")
    p.add_argument("--aov-prefix", default="", help="also save albedo/normal AOV PNGs")
    p.add_argument(
        "--adaptive", action="store_true",
        help="variance-adaptive sample allocation: after a uniform warmup, "
        "each batch's lanes are drawn from the per-pixel "
        "luminance-variance distribution",
    )
    p.add_argument("--adaptive-warmup", type=int, default=4,
                   help="uniform samples before adaptive allocation starts")
    p.add_argument(
        "--trace-profile", default="",
        help="write a torch.profiler Chrome trace (trace.json) of one "
        "steady-state sample batch, and its spans and the device's idle "
        "time by span (spans.json), to this directory",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cpu for the CPU)")
    return p


def parse_cli_args(argv) -> tuple[Params, argparse.Namespace]:
    a = build_parser().parse_args(argv)
    return Params(
        scene=a.scene, output=a.output, camera=a.camera, addsky=a.addsky,
        envname=a.envname, resolution=a.resolution, samples=a.samples,
        bounces=a.bounces, denoise=a.denoise, noparallel=a.noparallel,
        highqualitybvh=a.highqualitybvh, envhidden=a.envhidden,
        tentfilter=a.tentfilter, sampler=a.sampler, clamp=a.clamp,
        nocaustics=a.nocaustics, batch=a.batch, bvhstacksize=a.bvhstacksize,
        seed=a.seed, adaptive=a.adaptive, adaptive_warmup=a.adaptive_warmup,
    ), a


def _profiled_batch(renderer, state, directory: str, device) -> TraceState:
    """One batch under torch.profiler with the program's spans recorded
    (utils/timing.py): the Chrome trace, spans included, written to
    directory/trace.json, and directory/spans.json: the span records on
    the profiler's clock (time.time_ns ns), the device's idle seconds by
    span (`idle_by_span` over the trace's device events, within the
    batch's frame), and the frame's aggregate table. Prints the three
    spans that hold the most idle time."""
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    with timing.recording() as records, \
            tp.profile(activities=activities) as prof:
        state = renderer.trace_samples(state)
        fence(state.image)
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    frame = [r for r in records if r["path"] == "frame"][-1]
    window = (frame["start_ns"], frame["end_ns"])
    idle = timing.idle_by_span(timing.device_intervals(prof), records, window)
    idle_s = sum(idle.values())
    with open(os.path.join(directory, "spans.json"), "w") as f:
        json.dump({"clock": "time.time_ns", "window_ns": list(window),
                   "idle_s": idle_s, "idle_by_span_s": idle,
                   "table": timing.units()[-1]["table"], "records": records},
                  f)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:3]
    print(f"idle {idle_s * 1e3:.3f} ms of the {(window[1] - window[0]) / 1e6:.3f} "
          "ms frame, by span: " + ", ".join(
              f"{k} {100 * v / max(idle_s, 1e-30):.1f}%" for k, v in top))
    return state


def main(argv=None) -> int:
    params, a = parse_cli_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(a.device)

    render_start = time.monotonic()
    print(f"loading scene {params.scene}...")
    t0 = time.monotonic()
    scene = load_scene(params.scene, parallel=not params.noparallel)
    print(f"loaded scene in {format_seconds(time.monotonic() - t0)}")
    if params.addsky:
        from julia_raytracer_tpu_torch.scene.augment import add_sky

        add_sky(scene)
        print("added procedural sun-sky environment")
    if params.envname:
        from julia_raytracer_tpu_torch.scene.augment import add_environment

        add_environment(scene, params.envname)
        print(f"added environment {params.envname}")

    print("finding camera...")
    print("building bvh...")
    t0 = time.monotonic()
    renderer = Renderer(scene, params, device=device)
    print(f"built bvh in {format_seconds(time.monotonic() - t0)}")
    print("making lights...")
    print("making state...")
    if a.resume:
        state = TraceState.load(a.resume, device=device)
        print(f"resumed at sample {state.samples} from {a.resume}")
    else:
        state = make_trace_state(scene, params, device=device)
    print("tracing samples...")

    sampling_start = time.monotonic()
    profiled = not a.trace_profile
    batch_i = 0
    while state.samples < params.samples:
        batch_start = time.monotonic()
        # profile the 2nd batch of this process (the 1st warms up), or
        # the 1st when it is the only one
        last_batch = state.samples + params.batch >= params.samples
        if not profiled and (batch_i >= 1 or last_batch):
            state = _profiled_batch(renderer, state, a.trace_profile, device)
            profiled = True
            print(f"profiler trace written to {a.trace_profile}")
        else:
            state = renderer.trace_samples(state)
            fence(state.image)
        batch_i += 1
        now = time.monotonic()
        etc = (now - sampling_start) / max(state.samples, 1) * (
            params.samples - state.samples
        )
        print(
            f"sample {state.samples:3d}/{params.samples:3d} in "
            f"{format_seconds(now - batch_start)} ETC: {format_seconds(etc)}"
        )
        if a.checkpoint:
            state.save(a.checkpoint)
    render_s = time.monotonic() - sampling_start
    print(f"rendered in {format_seconds(render_s)} ({render_s:.3f}s)")

    if params.denoise:
        from julia_raytracer_tpu_torch.render.denoise import denoise_image

        print("denoising...")
        t0 = time.monotonic()
        state.denoised = fence(denoise_image(
            state.image, state.albedo, state.normal, state.width, state.height
        ))
        print(f"denoised in {format_seconds(time.monotonic() - t0)}")

    print("saving image...")
    image = renderer.get_image(state)
    save_png(params.output, image, linear=True)
    print("saved image to", params.output)
    if a.aov_prefix:
        aovs = renderer.get_aovs(state)
        alb = np.concatenate([aovs["albedo"], np.ones_like(aovs["albedo"][..., :1])], -1)
        nrm = np.concatenate(
            [aovs["normal"] * 0.5 + 0.5, np.ones_like(aovs["normal"][..., :1])], -1
        )
        save_png(a.aov_prefix + "_albedo.png", alb, linear=True)
        save_png(a.aov_prefix + "_normal.png", nrm, linear=False)
    print(f"total time: {format_seconds(time.monotonic() - render_start)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
