"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from julia_raytracer_tpu_torch/csrc
with nvcc, checks each kernel against its plain PyTorch version on the card
at the main path's shapes and times both, renders the main path (the
512 x 512, 8-bounce path-traced Cornell box) through the kernels, and holds
a 128 x 128 render on the card against the same render on the CPU.

Exits non-zero, printing no result, when no CUDA device is available or any
phase fails. On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build, dense_intersect as di
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.render.integrator import trace_wavefront
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import (
    check_hits, cornell_scene, image_close, require,
)
from julia_raytracer_tpu_torch.utils import rng as rng_mod

MAIN_RES, MAIN_BOUNCES, WARM_SPP, TIMED_SPP = 512, 8, 8, 32
CHECK_RES, CHECK_SPP = 128, 4
N_RAYS = MAIN_RES * MAIN_RES  # lanes per main-path dispatch (262,144)
COMPACT_CAP = N_RAYS // 4  # first two-phase boundary of the main path
STATE_PLANES = 45  # int32 planes of the integrator state (TraceVars)
OUTPUT_PLANES = 11  # radiance 3, hit 1, albedo 3, normal 3, rng 1
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn) -> float:
    """Median device time of one call of fn, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def int_max_abs_err(a, b) -> float:
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_intersect(dev, table) -> dict:
    """262,144 rays (camera rays and bounce-like rays from inside the box)
    against the Cornell quads: kernel vs plain version on the card."""
    g = np.random.default_rng(0)
    half = N_RAYS // 2
    ro = np.empty((N_RAYS, 3), np.float32)
    ro[:half] = [0.0, 1.0, 3.9]
    ro[half:] = g.uniform([-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], (half, 3))
    rd = g.normal(size=(N_RAYS, 3)).astype(np.float32)
    rd[:half, 2] = -np.abs(rd[:half, 2]) - 2.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 3.4e38, np.float32)
    tmax[::5] = -1.0  # dead lanes, as the integrator sends them
    args = [torch.from_numpy(x).to(dev) for x in
            (ro, rd, np.full(N_RAYS, 1e-4, np.float32), tmax)]
    got = di.dense_intersect(table, *args)
    ref = di.dense_intersect_plain(table, *args)
    torch.cuda.synchronize()
    err = check_hits(ref, got)
    require(got.hit.float().mean() > 0.5, "too few intersect hits")
    plain_ms = median_ms(lambda: di.dense_intersect_plain(table, *args))
    ms = median_ms(lambda: di.dense_intersect(table, *args))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _adversarial_planes(g, p, n, dev):
    bits = g.integers(-(2**31), 2**31, size=(p, n), dtype=np.int64)
    return torch.from_numpy(bits.astype(np.int32)).to(dev)


def _alive(g, dev):
    alive = g.random(N_RAYS) < 0.22
    alive[: 4 * lc.TILE] = True  # fully alive tiles
    alive[8 * lc.TILE: 12 * lc.TILE] = False  # fully dead tiles
    alive &= np.cumsum(alive) <= COMPACT_CAP
    return torch.from_numpy(alive).to(dev)


def phase_compact(dev) -> dict:
    """Bit-exact pack of 45 adversarial planes, n=262,144 -> cap=65,536."""
    g = np.random.default_rng(1)
    vals = _adversarial_planes(g, STATE_PLANES, N_RAYS, dev)
    alive = _alive(g, dev)
    total = int(alive.sum())
    got = lc.compact_planes(vals, alive, COMPACT_CAP)
    ref = lc.compact_planes_plain(vals, alive, COMPACT_CAP)
    torch.cuda.synchronize()
    require(torch.equal(got[:, :total], ref[:, :total]), "compact not bit-exact")
    plain_ms = median_ms(lambda: lc.compact_planes_plain(vals, alive, COMPACT_CAP))
    ms = median_ms(lambda: lc.compact_planes(vals, alive, COMPACT_CAP))
    return dict(max_abs_err=int_max_abs_err(got[:, :total], ref[:, :total]),
                ms=ms, plain_ms=plain_ms)


def phase_expand(dev) -> dict:
    """Bit-exact scatter of 11 output planes from cap=65,536 to n=262,144."""
    g = np.random.default_rng(2)
    narrow = _adversarial_planes(g, OUTPUT_PLANES, COMPACT_CAP, dev)
    fallback = _adversarial_planes(g, OUTPUT_PLANES, N_RAYS, dev)
    alive = _alive(g, dev)
    got = lc.expand_planes(narrow, alive, fallback)
    ref = lc.expand_planes_plain(narrow, alive, fallback)
    torch.cuda.synchronize()
    require(torch.equal(got, ref), "expand not bit-exact")
    plain_ms = median_ms(lambda: lc.expand_planes_plain(narrow, alive, fallback))
    ms = median_ms(lambda: lc.expand_planes(narrow, alive, fallback))
    return dict(max_abs_err=int_max_abs_err(got, ref), ms=ms, plain_ms=plain_ms)


def main_path(dev) -> tuple[dict, dict]:
    """The 512 x 512, 8-bounce path-traced Cornell box through Renderer."""
    scene = cornell_scene()
    params = Params(resolution=MAIN_RES, samples=WARM_SPP + TIMED_SPP,
                    batch=WARM_SPP, bounces=MAIN_BOUNCES, sampler="path")
    renderer = Renderer(scene, params, device=dev)
    state = make_trace_state(scene, params, device=dev)
    di.dense_intersect.launches = 0
    lc.compact_planes.launches = 0
    lc.expand_planes.launches = 0
    renderer.trace_samples(state)  # warm-up
    torch.cuda.synchronize()
    syncs0 = trace_wavefront.host_syncs
    t0 = time.perf_counter()
    while state.samples < params.samples:
        renderer.trace_samples(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "dense_intersect": di.dense_intersect.launches,
        "lane_compact": lc.compact_planes.launches,
        "lane_expand": lc.expand_planes.launches,
    }
    syncs = trace_wavefront.host_syncs - syncs0
    img = renderer.get_image(state)
    require(img.shape == (MAIN_RES, MAIN_RES, 4), f"image shape {img.shape}")
    require(np.isfinite(img).all(), "non-finite pixels in the main-path image")
    require(img[..., :3].mean() > 0.0, "black main-path image")
    for name, count in launches.items():
        require(count > 0, f"the main path never launched {name}")
    stats = dict(
        seconds=seconds,
        mpaths_per_s=N_RAYS * TIMED_SPP / seconds / 1e6,
        ms_per_sample=1e3 * seconds / TIMED_SPP,
        host_syncs_per_sample=syncs / TIMED_SPP,
        image_mean=float(img[..., :3].mean()),
    )
    return stats, launches


def agreement(dev) -> dict:
    """128 x 128 at 4 spp: kernels on the card vs plain versions on the
    CPU, same seed. Image mean within 1e-3 relative, >= 99% of pixels
    within 1e-3 absolute (testing.image_close, as in the CPU tests)."""
    scene = cornell_scene()
    params = Params(resolution=CHECK_RES, samples=CHECK_SPP, batch=CHECK_SPP,
                    bounces=MAIN_BOUNCES, sampler="path", seed=3)
    images = []
    for device in (dev, "cpu"):
        r = Renderer(scene, params, device=device)
        st = make_trace_state(scene, params, device=device)
        r.trace_samples(st)
        images.append(r.get_image(st))
    rel, frac = image_close(*images)
    return dict(mean_rel_err=rel, frac_pixels_within_1e3=frac)


def rng_agrees(dev) -> None:
    """The rng streams on the card equal the CPU's bit for bit (the int64
    wraparound the port's PCG relies on)."""
    pix = torch.arange(1 << 16, dtype=torch.int32) * 32771
    s_cpu = rng_mod.seed_state(pix, 2**31 - 1, 7)
    s_gpu = rng_mod.seed_state(pix.to(dev), 2**31 - 1, 7)
    require(torch.equal(s_gpu.cpu(), s_cpu), "rng states differ on the card")
    v_cpu, s_cpu = rng_mod.rand3f(s_cpu)
    v_gpu, s_gpu = rng_mod.rand3f(s_gpu)
    require(torch.equal(v_gpu.cpu(), v_cpu) and torch.equal(s_gpu.cpu(), s_cpu),
            "rng draws differ on the card")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    di._lib()
    lc._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")

    scene_table = Renderer(cornell_scene(), Params(resolution=8),
                           device=dev).intersect.table
    rng_agrees(dev)
    phases = {
        "dense_intersect": phase_intersect(dev, scene_table),
        "lane_compact": phase_compact(dev),
        "lane_expand": phase_expand(dev),
    }
    for name, p in phases.items():
        log(f"phase {name}: ok, max_abs_err {p['max_abs_err']}, kernel "
            f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms (median of {REPS})")

    stats, launches = main_path(dev)
    log(f"main path: {MAIN_RES}x{MAIN_RES}, {MAIN_BOUNCES} bounces, "
        f"{TIMED_SPP} timed samples after {WARM_SPP} warm: "
        f"{stats['mpaths_per_s']:.3f} Mpaths/s, {stats['ms_per_sample']:.2f} "
        f"ms/sample, {stats['host_syncs_per_sample']:.1f} host syncs/sample, "
        f"image mean {stats['image_mean']:.5f}, launches {launches}")
    agree = agreement(dev)
    log(f"agreement {CHECK_RES}x{CHECK_RES} {CHECK_SPP} spp card vs cpu: {agree}")

    sources = {
        "dense_intersect": ("julia_raytracer_tpu_torch/csrc/dense_intersect.cu",
                            "julia_raytracer_tpu/ops/pallas_intersect.py:82"),
        "lane_compact": ("julia_raytracer_tpu_torch/csrc/lane_compact.cu",
                         "julia_raytracer_tpu/ops/pallas_compact.py:105"),
        "lane_expand": ("julia_raytracer_tpu_torch/csrc/lane_compact.cu",
                        "julia_raytracer_tpu/ops/pallas_compact.py:174"),
    }
    kernels = [
        dict(name=name, route="cuda", source=sources[name][0],
             replaces=sources[name][1], launches=launches[name],
             max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"])
        for name, p in phases.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
