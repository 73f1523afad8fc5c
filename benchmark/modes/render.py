"""Progressive rendering, a closed loop with one client: one frame is one
`Renderer.trace_samples(state)` (one sample of every pixel, batch 1)
ended by a device synchronisation, and the next frame starts when one
ends, as in a progressive viewer.

Set-up: the scene generated from the configuration, the program's
`Renderer` built on it (span `scene_build`), the traffic's warm-up
frames (span `warm`). The window runs frames until `seconds` have
passed and closes at the end of the frame then in flight. With --trace 1, the traced span
follows: frames unprofiled, then as many under the profiler.

Output check, once the window has closed and the program's state is
freed: a sample of pixels drawn from the seed, every frame the state
holds of each (the warm-up's, the window's and the traced span's), the
program's running mean against the plain reference's mean of the same
(pixel, sample) paths (benchmark/reference/tracer.py) in rgb, and in
alpha, albedo and normal, and the count of samples that hit.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np

from benchmark.modes.common import Run, build_scene, profile_units, to_program_scene


def check_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    """k distinct pixel ids drawn from the seed, sorted."""
    g = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF)
    return np.sort(g.choice(n_pixels, size=min(k, n_pixels), replace=False))


def rel_l1(got, want) -> float:
    den = float(np.abs(want).sum())
    return float(np.abs(got - want).sum()) / max(den, 1e-30)


def compare(prog: dict, ref_mean: np.ndarray, ref_hits: np.ndarray,
            n_frames: int) -> dict:
    """The numbers the output check holds to its limits."""
    got = np.concatenate([prog["image"], prog["albedo"], prog["normal"]], 1)
    return {
        "rgb_err": rel_l1(got[:, :3], ref_mean[:, :3]),
        "aov_err": rel_l1(got[:, 3:], ref_mean[:, 3:]),
        "hits_err": float(np.abs(prog["hits"] - ref_hits).sum())
        / max(1, ref_hits.size * n_frames),
    }


def reference(desc, traffic, pixels, n_frames, seed, width, height, device,
              dtype=None):
    import torch

    from benchmark.reference import tracer

    scene = tracer.Scene(desc, device, dtype or torch.float32)
    mean, hits = tracer.render_pixels(
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
