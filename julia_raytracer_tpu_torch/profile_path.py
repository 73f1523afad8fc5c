"""Where the time goes on a main path: device time per sample by kernel,
launches per sample and the device's idle share, on one CUDA card.

    python -m julia_raytracer_tpu_torch.profile_path --scene spheres
    python -m julia_raytracer_tpu_torch.profile_path --scene cornell
    python -m julia_raytracer_tpu_torch.profile_path --scene heavy
    python -m julia_raytracer_tpu_torch.profile_path --scene heavy --regroup on
    python -m julia_raytracer_tpu_torch.profile_path --scene spheres --sort off
    python -m julia_raytracer_tpu_torch.profile_path --scene instanced
    python -m julia_raytracer_tpu_torch.profile_path --scene hybrid

Renders the scene at 512 x 512, 8 bounces, path sampler, through Renderer
on the card with its default configuration (the sphere grid, the heavy
scene and the two instanced scenes sort their wavefronts; regroup="auto"
chooses the heavy scene's and the hybrid soup's bounce kernel; the
instanced scene takes the two-level build, the hybrid scene the hybrid
build); `--sort` and `--regroup` override those. 2 warm-up
samples, then `--samples` samples timed by the host clock (ending in
torch.cuda.synchronize()), then as many again under torch.profiler. Each
hand-written kernel is reported apart, the regroup intersector's three
stages among them. Device time is the sum of the CUDA kernel, memcpy and
memset intervals the profiler records (one stream, so they do not
overlap); idle share = 1 - device ms / unprofiled wall ms per sample.
Prints a table of the largest kernels and, last, one JSON object.
Exits non-zero without a card, or if the profiler records no device time
or more device time than the wall time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch

from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.render.integrator import trace_wavefront
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, heavy_scene, hybrid_scene, instanced_scene,
    sphere_grid_scene,
)

SCENES = {"cornell": cornell_scene, "spheres": sphere_grid_scene,
          "heavy": heavy_scene, "instanced": instanced_scene,
          "hybrid": hybrid_scene}
# the hand-written kernels: substrings of their device functions' names as
# the profiler reports them (the compactor launches a count and a pack)
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
    "curve_intersect": ("::curve_walk_kernel(",),
}


def _samples(renderer, state, count) -> None:
    target = state.samples + count
    while state.samples < target:
        renderer.trace_samples(state)
    torch.cuda.synchronize()


def _syncs() -> int:
    return trace_wavefront.host_syncs + rg.regroup_intersect.host_syncs


def profile(scene_name: str, samples: int, res: int = 512, bounces: int = 8,
            sort_rays: bool | None = None, regroup: str = "auto"):
    scene = SCENES[scene_name]()
    params = Params(resolution=res, samples=2 + 2 * samples, batch=1,
                    bounces=bounces, sampler="path", sort_rays=sort_rays,
                    regroup=regroup)
    renderer = Renderer(scene, params, device="cuda")
    state = make_trace_state(scene, params, device="cuda")
    _samples(renderer, state, 2)  # warm-up
    syncs0, fb0 = _syncs(), rg.regroup_intersect.fallbacks
    t0 = time.perf_counter()
    _samples(renderer, state, samples)
    wall_ms = 1e3 * (time.perf_counter() - t0) / samples
    syncs = (_syncs() - syncs0) / samples
    fallbacks = (rg.regroup_intersect.fallbacks - fb0) / samples
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _samples(renderer, state, samples)
    per_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            per_name[e.name][1] += 1
    if not per_name:
        raise RuntimeError("the profiler recorded no device time")
    device_ms = sum(v[0] for v in per_name.values()) / samples
    if device_ms > wall_ms:
        raise RuntimeError(
            f"device time {device_ms:.3f} ms/sample exceeds the wall time "
            f"{wall_ms:.3f} ms/sample: the profile's device intervals overlap "
            "or were counted twice")
    launches = sum(v[1] for v in per_name.values()) / samples
    own = {k: [0.0, 0] for k in OWN_KERNELS}
    for name, (ms, count) in per_name.items():
        for k, parts in OWN_KERNELS.items():
            if any(part in name for part in parts):
                own[k][0] += ms / samples
                own[k][1] += count / samples
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        scene=scene_name, quads=renderer.config.n_prims, resolution=res,
        bounces=bounces, sorted=renderer.options.sort_rays, regroup=regroup,
        livegate=renderer.intersect.livegate, samples=samples,
        wall_ms_per_sample=wall_ms, regroup_fallbacks_per_sample=fallbacks,
        device_ms_per_sample=device_ms,
        idle_share=1.0 - device_ms / wall_ms,
        device_launches_per_sample=launches, host_syncs_per_sample=syncs,
        own_kernels={k: dict(ms_per_sample=v[0], launches_per_sample=v[1])
                     for k, v in own.items()},
        top=[dict(name=n[:90], ms_per_sample=v[0] / samples,
                  launches_per_sample=v[1] / samples) for n, v in top],
        device=torch.cuda.get_device_name(0),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="spheres")
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--sort", choices=("default", "on", "off"),
                    default="default")
    ap.add_argument("--regroup", choices=("auto", "on", "off"), default="auto")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_path: no CUDA device is available", file=sys.stderr)
        return 1
    sort_rays = {"default": None, "on": True, "off": False}[args.sort]
    r = profile(args.scene, args.samples, sort_rays=sort_rays,
                regroup=args.regroup)
    print(f"{r['scene']} ({r['quads']} quads, sorted {r['sorted']}, regroup="
          f"{r['regroup']!r}, livegate {r['livegate']}) on "
          f"{r['device']}: wall "
          f"{r['wall_ms_per_sample']:.2f} ms/sample, device "
          f"{r['device_ms_per_sample']:.2f} ms/sample, idle share "
          f"{r['idle_share']:.3f}, {r['device_launches_per_sample']:.0f} "
          f"device launches/sample, {r['host_syncs_per_sample']:.1f} host "
          f"syncs/sample, {r['regroup_fallbacks_per_sample']:.1f} regroup "
          f"fallbacks/sample")
    for k, v in r["own_kernels"].items():
        print(f"  {k}: {v['ms_per_sample']:.3f} ms/sample in "
              f"{v['launches_per_sample']:.1f} device launches")
    for t in r["top"]:
        print(f"  {t['ms_per_sample']:9.3f} ms {t['launches_per_sample']:8.1f} x "
              f"{t['name']}")
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
