"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's hand-written CUDA kernels from julia_raytracer_tpu_torch/csrc
with nvcc (one process per source, all at once), checks each kernel against
its plain PyTorch version on the card at the main paths' shapes and times
both beside the card's bound and, where one exists, a single PyTorch call
computing the same function (a kernel's `ms` is its device time, launches
replayed from a CUDA graph; `call_ms` counts the host's launch too). The
shares of the dense kernel's tests that reach the reciprocal are counted
by its pre-test's plain mirror. It holds the whole regroup intersector against
the worklist intersector on the heavy scene's rays and fits the H100's
kernel-selection costs from their stage times. The candidate-cull kernel and
the work-item kernel of the instanced path run on the instanced scene's
sorted bounce rays (with a sweep of the candidate lists' group size), and
the whole work-item intersector meets the worklist intersector over the same
scene flattened; the two cluster kernels
without a work list (reached only through their factories, as in the JAX
package) run on the sphere grid's bounce rays. The precull's device_span
runs eager and captured in a CUDA graph at the sphereflake's body shapes
(1280², 22,143 work items): the counts its clock stamps copy equal the
cull kernel's and span_stamp's plain version's, and its clock lies
within CUDA events around the call (a `span_stamp:` line). The culled
curve walk meets its plain version and the sweep at the SPD tree's body
shapes (a `curve_walk:` line). The shading kernel (csrc/shade_path.cu)
meets the eager shading on every lane of every body of a 1280² frame of
the Cornell box, the SPD sphereflake and the SPD tree, and on a
1,048,576-lane body of each its device ms, the eager shading's and its
share of its bound are timed, with ptxas's registers and spills (a
`shade_path:` line; under SHADE_MIN_SHARE of the bound, or a spill,
fails). Then it drives
the five main paths through the kernels, each with the launch counters
zeroed just before it:
  - the 512 x 512, 8-bounce path-traced Cornell box (18 quads: the dense
    intersector, the lane compactor);
  - the 512 x 512, 8-bounce sphere grid (102,406 quads: the wavefront sort,
    the worklist cluster intersector);
  - the 512 x 512, 8-bounce heavy scene (1,537,606 quads: the wavefront
    sort, the worklist intersector for camera rays and the regroup
    intersector's three kernels for bounce rays), with regroup="on" and
    then again with the Renderer's default regroup="auto";
  - the 512 x 512, 8-bounce instanced scene (576 sphere instances over four
    shared meshes, 7,817,478 world quads: the two-level build, the
    work-item kernel);
  - the 512 x 512, 8-bounce hybrid scene (1,052 instances, 26,214,406 world
    quads: a flattened soup of 1,048,582 quads through kernel_select's
    choice, 24 big spheres as 12,288 work items);
and holds small renders of the paths on the card against the same renders
on the CPU. Last, the cli phase drives the command-line entry point
(julia_raytracer_tpu_torch.cli.main, in process) on scenes it writes with
testing.write_yocto_scene, at 512 x 512 and 8 bounces, each run with the
launch counters zeroed just before it: the Cornell box uniform (its PNG
held to the Renderer's), checkpointed and resumed (byte-equal), adaptive
with the denoiser twice (bit-equal), against a 64-sample reference (the
JAX package's adaptive and denoiser quality gates), and the sphere grid
under --addsky; it prints a `cli:` line of their times and launches.
Then the diff phase drives the differentiable path (render/diff.py, the
fixed-trip loop under torch.utils.checkpoint, parallel/mesh.py): at 512 x
512 and 8 bounces the fixed-trip render equals the while loop's (with its
lane compaction) bit for bit; colour and emission gradients of the pixel
loss on the card meet the CPU's (64 x 64, within testing.GRAD_TOL); five
shard_train_step steps at 512 x 512, 8 bounces, on a one-process NCCL
group (a file:// store in a temporary directory), start from perturbed
colours against a target rendered at the true ones and must lower the
loss, each step launching the dense kernel once for the camera rays, once
a bounce and once more in each bounce's recompute, the material gathers'
backward (ops/row_gather.py, bit-equal across two calls, timed against
ATen's index backward and index_add_) absent from the backward's largest
device activities; one gradient on the sphere grid (102,406 quads, the
worklist kernel) at 128 x 128 meets the CPU's. It prints a `diff:` line.
Then the diff_instanced phase drives the differentiable path on the
instanced and hybrid scenes (the instanced re-test over the cull and the
work-item kernel, the hybrid's soup over the worklist kernel): their
fixed-trip renders at 512 x 512, 8 bounces, equal the unsorted while
loop's bit for bit; colour, emission and shape-space vertex gradients
on two reduced scenes on the card meet the CPU's; five train steps on
instanced_scene() lower the loss, each launching the work-item kernel
and the cull once for the camera rays, once a bounce and once more in
each recompute, with the kernels' device ms a launch on these unsorted
rays; one step on hybrid_scene(); and the instanced intersector returns
the same bits twice on unsorted bounce rays. It prints a
`diff_instanced:` line.
Then the scene_content phase renders the scene content the earlier paths
do not reach, each at 512 x 512 and 8 bounces with the launch counters
zeroed just before: (a) testing.hairball_scene() (the Cornell box with
4,096 hair lines and 256 points: render/integrator.py curve_wrap's plain
PyTorch sweep around the dense kernel, the lane compactor), with its
device ms a sample, the sweep's device ms a sample and its extra peak
memory; (b) testing.many_lights_scene() (5,120 emissive quads, over the
exact light pdf's 4,096: the truncated-march pdf, whose steps go through
the worklist kernel), whose worklist launches must equal one a sample
for the camera rays plus 1 + the march's steps a loop body; (c) a written
scene whose cube shape's PLY is empty and whose Catmull-Clark cage asks
for 4 levels (1,536 quads, the worklist kernel) through cli.main, its PNG
byte-equal to the Renderer's on the scene the loader gives. (a) and (b)
are held card against CPU at 64 x 64. It prints a `scene_content:` line.
Then the host_build phase times the scene set-up on the host: the heavy
scene written with write_yocto_scene (JRT_CACHE_DIR a fresh temporary
directory), load_scene + Renderer cold and then warm, by step (load, BVH,
lights, cluster tables, kernel select, cache reads and writes); the warm
build reads the products "geom", "clusters" and "kernel_select" and calls
no builder, and its 512 x 512 sample is bit-equal to the cold build's; the
cold build's tables come from the C++ builder (ops/native.py); the heavy
tables and the hybrid scene's world soup are built natively and in numpy
(JRT_NO_NATIVE=1), timed and held together. It prints a `host_build:`
line. Last, the cost phase counts one 512 x 512, 8-bounce sample of each
of the five main paths (Cornell, spheres, heavy "auto" from the warm
build, instanced, hybrid) with Renderer.sample_kernel_cost (utils/
roofline.py count_cost: the ATen ops by name, each kernel's
utils/kernel_flops.py model), gives roofline() over the path's timed wall
ms a sample and over its device ms a sample, and holds the Cornell box's
count on the card within 1% of the CPU's at 64 x 64. It prints a `cost:`
line. Every bound in the kernels line comes from utils/kernel_flops.py's
model of its kernel and utils/roofline.py's `bound`.

`--parent DIR`: DIR holds an earlier checkout of the repository (`git
archive` of a commit). The inputs of the dense kernel, of the two cluster
kernels without a work list and of the three regroup kernels (pack,
tri-test, unpack) are saved, and child processes time the six through
each tree's own wrappers (`make_dense_intersect`,
`cluster_intersect_kernel`, `cluster_intersect_streamed_kernel`,
`regroup_pack`, `regroup_tritest`, `regroup_unpack`) on them, in turns
(parent, this, this, parent), each child checking its results against
this tree's plain versions bit for bit.

Exits non-zero, printing no result, when no CUDA device is available or any
phase fails. On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import inspect
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from julia_raytracer_tpu_torch import cli

from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import cluster_tables, native
from julia_raytracer_tpu_torch.ops import cuda_build, dense_intersect as di
from julia_raytracer_tpu_torch.ops import curve_intersect as cw
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.ops.dense_intersect import _moller
from julia_raytracer_tpu_torch.parallel.distributed import init_distributed
from julia_raytracer_tpu_torch.parallel.mesh import make_mesh, shard_train_step
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import row_gather as rgat
from julia_raytracer_tpu_torch.ops import shade_path as sp
from julia_raytracer_tpu_torch.ops import span_stamp
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.traversal import Intersector
from julia_raytracer_tpu_torch.render.integrator import (
    _host_prims, _sort_key, merge_curves, sort_bounds, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.lights import (
    EXACT_ELEMS, auto_light_pdf_steps,
)
from julia_raytracer_tpu_torch.render.denoise import denoise_image
from julia_raytracer_tpu_torch.render.diff import (
    diff_options, make_param_loss, render_radiance,
)
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, TraceState, adaptive_cdf, adaptive_draw,
    inclusive_scan, make_trace_state, pixel_sums,
)
from julia_raytracer_tpu_torch.render import body_graphs as bg
from julia_raytracer_tpu_torch.render import scene_device
from julia_raytracer_tpu_torch.render.scene_device import (
    auto_hybrid_budget, build_device_scene,
)
from julia_raytracer_tpu_torch.scene.flatten import flatten_scene
from julia_raytracer_tpu_torch.scene.instanced import (
    build_world_flat, select_flatten_shapes,
)
from julia_raytracer_tpu_torch.scene.loader import load_scene
from julia_raytracer_tpu_torch.testing import (
    GRAD_TOL, HYBRID_COUNTS, INSTANCED_COUNTS, check_hits, check_vs_flat,
    cornell_scene, grads_close, hairball_scene, heavy_scene, hybrid_scene,
    image_close, instanced_scene, many_lights_scene, param_grads,
    render_instanced, require, same_lists, sphere_grid_scene,
    sphereflake_scene,
    subdiv_cube_scene, vertex_grads, write_cube_cage, write_yocto_scene,
)
from julia_raytracer_tpu_torch.utils import diskcache, kernel_flops as kf
from julia_raytracer_tpu_torch.utils import kernel_select as ks
from julia_raytracer_tpu_torch.utils import rng as rng_mod, timing
from julia_raytracer_tpu_torch.utils.imgio import save_png
from julia_raytracer_tpu_torch.utils.roofline import bound, roofline
from julia_raytracer_tpu_torch.utils.vecmath import normalize

MAIN_RES, MAIN_BOUNCES, WARM_SPP, TIMED_SPP = 512, 8, 8, 32
SPHERE_WARM_SPP, SPHERE_TIMED_SPP = 2, 8
HEAVY_WARM_SPP, HEAVY_TIMED_SPP = 1, 2
HEAVY_CHECK_GRID, HEAVY_CHECK_RES, HEAVY_CHECK_SPP = 4, 64, 2
INST_WARM_SPP, INST_TIMED_SPP = 1, 2
INST_CHECK_RES, INST_CHECK_SPP = 64, 2
# the share of hits whose t the work-item intersector may place beyond
# check_vs_flat's rtol from the flattened scene's: 15 and 6 of the
# camera's and bounce rays' hits on the H100 (PERF.md section 6), each
# re-intersected in float64 by f64_witness
INST_T_MISMATCH = 1e-4
CLUSTER_REPS = 5  # the cluster kernels test every cluster a ray's box path meets
CHECK_RES, CHECK_SPP = 128, 4
# the cli phase: julia_raytracer_tpu_torch.cli.main on written scenes at
# the main paths' width (512 x 512, 8 bounces)
CLI_SPP, CLI_BATCH, CLI_CKPT_SPP = 16, 4, 8
CLI_WARMUP, CLI_REF_SPP, CLI_REF_SEED, CLI_GRID_SPP = 4, 64, 3, 8
CLI_NOISY_SPP = 4  # the denoiser's input in tests/test_denoise.py
CLI_CHECK_RES, CLI_CHECK_SPP = 32, 2
SPHERE_CHECK_RES, SPHERE_CHECK_SPP, SPHERE_CHECK_SEGMENTS = 64, 2, 16
# the diff phase: train steps at the main path's width, the gradient
# checks card against CPU at 64 x 64 (Cornell) and at 128 x 128 on every
# DIFF_SPHERE_STEP-th pixel (the sphere grid: the worklist's plain version
# is the CPU's cost)
DIFF_STEPS, DIFF_SEED, DIFF_COLOR_OFFSET = 5, 7, 0.15
DIFF_CHECK_RES, DIFF_SPHERE_RES, DIFF_SPHERE_STEP = 64, 128, 2
# the scene_content phase: samples of its two renders (the first a
# warm-up), their card-vs-CPU checks, the hairball's size and the
# subdivided cube's levels and CLI samples
CONTENT_WARM_SPP, CONTENT_TIMED_SPP = 1, 2
CONTENT_CHECK_RES, HAIR_CHECK_SPP, LIGHTS_CHECK_SPP = 64, 2, 1
HAIR_HAIRS, HAIR_SEGMENTS, HAIR_POINTS = 1024, 4, 256
SUBDIV_LEVELS, SUBDIV_SPP = 4, 4
# the host_build phase: native tables against numpy's within the JAX
# package's tolerance (tests/test_pallas_kernels.py), the world soup's
# float32 sums (another order) within 4 ulps of its largest coordinate
HOST_TABLE_TOL = 2e-6
HOST_WORLD_RTOL = 4 * float(np.finfo(np.float32).eps)
# the cost phase: ops listed a path, and the Cornell box's card-vs-CPU
# count check at 64 x 64 within 1%
COST_TOP_OPS, COST_CHECK_RES, COST_CPU_RTOL = 10, 64, 0.01
CORNELL_QUADS = 18
N_RAYS = MAIN_RES * MAIN_RES  # lanes per main-path dispatch (262,144)
FLAKE_RES = 1280  # the flake-path8 cell's frame: 1,638,400 lanes a body
COMPACT_CAP = N_RAYS // 4  # first two-phase boundary of the main path
STATE_PLANES = 45  # int32 planes of the integrator state (TraceVars)
OUTPUT_PLANES = 11  # radiance 3, hit 1, albedo 3, normal 3, rng 1
REPS = 20
PLAIN_WORKLIST_REPS = 3  # its plain version reads counts back every step
PLAIN_REPS = 5  # the regroup kernels' and the cull's plain versions
# rays per candidate list or work list swept on the main path's rays (the
# measurement behind ii.GROUP_RAYS and wl.GROUP_RAYS)
GROUP_SWEEP = (32, 64, 128, 256)
# live shares of the regroup-vs-worklist sweep (the JAX package's gates
# are 0.45 and 0.2)
LIVE_SHARES = (0.45, 0.2, 0.1, 0.03)
PRETEST_SUBSET = 16384  # rays of the labelled subset of the pre-test share

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "dense_intersect": ("julia_raytracer_tpu_torch/csrc/dense_intersect.cu",
                        "julia_raytracer_tpu/ops/pallas_intersect.py:82"),
    "lane_compact": ("julia_raytracer_tpu_torch/csrc/lane_compact.cu",
                     "julia_raytracer_tpu/ops/pallas_compact.py:105"),
    "lane_expand": ("julia_raytracer_tpu_torch/csrc/lane_compact.cu",
                    "julia_raytracer_tpu/ops/pallas_compact.py:174"),
    "worklist_intersect": ("julia_raytracer_tpu_torch/csrc/worklist_intersect.cu",
                           "julia_raytracer_tpu/ops/pallas_cluster.py:823"),
    "regroup_pack": ("julia_raytracer_tpu_torch/csrc/regroup_intersect.cu",
                     "julia_raytracer_tpu/ops/pallas_regroup.py:87"),
    "regroup_tritest": ("julia_raytracer_tpu_torch/csrc/regroup_intersect.cu",
                        "julia_raytracer_tpu/ops/pallas_regroup.py:387"),
    "regroup_unpack": ("julia_raytracer_tpu_torch/csrc/regroup_intersect.cu",
                       "julia_raytracer_tpu/ops/pallas_regroup.py:274"),
    "instanced_intersect": ("julia_raytracer_tpu_torch/csrc/instanced_intersect.cu",
                            "julia_raytracer_tpu/ops/pallas_cluster.py:1398"),
    # not a pallas_call: the fused jnp candidate cull (beam_precull)
    "candidate_cull": ("julia_raytracer_tpu_torch/csrc/candidate_cull.cu",
                       "julia_raytracer_tpu/ops/pallas_cluster.py:1786"),
    "cluster_intersect": ("julia_raytracer_tpu_torch/csrc/cluster_intersect.cu",
                          "julia_raytracer_tpu/ops/pallas_cluster.py:192"),
    "cluster_intersect_streamed": (
        "julia_raytracer_tpu_torch/csrc/cluster_intersect.cu",
        "julia_raytracer_tpu/ops/pallas_cluster.py:424"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of fn, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of fn, without the host's launch: `reps`
    calls captured in a CUDA graph, the graph replayed three times, the
    median replay over reps. A kernel of a few tens of microseconds takes
    as long as its host-side launch, which median_ms counts."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


# profiler sessions a measurement may take: now and then a session
# records no device activity at all (seen once on an H100, on a call whose
# other sessions record it), and the measurement is taken again
PROFILE_TRIES = 3


def _device_activities(fn, reps: int) -> dict:
    """{name: [ms, count]} of the device activities (kernels, copies,
    sets) torch.profiler records over `reps` calls of fn, in a new session
    while the profiler records none, at most PROFILE_TRIES sessions."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms_count = by_name.setdefault(e.name, [0.0, 0])
                ms_count[0] += e.time_range.elapsed_us() / 1e3
                ms_count[1] += 1
        if sum(ms for ms, _ in by_name.values()) > 0:
            return by_name
    raise AssertionError(f"the profiler recorded no device time in "
                         f"{PROFILE_TRIES} sessions")


def profiled_ms(fn, reps: int = 5) -> float:
    """Device time of one call of fn: the durations of the device
    activities (kernels, copies, sets) that torch.profiler records over
    `reps` calls, summed and divided by reps. Unlike device_ms it takes a
    call that reads back to the host, and unlike median_ms it leaves out
    the host's time."""
    fn()
    by_name = _device_activities(fn, reps)
    return sum(ms for ms, _ in by_name.values()) / reps


def kernel_ms(fn, reps: int = REPS) -> dict:
    """A kernel's `ms` (device time, device_ms) and `call_ms` (one call
    between CUDA events, the host's launch included)."""
    return dict(ms=device_ms(fn, reps), call_ms=median_ms(fn, reps))


def cost_bound(cost: dict) -> dict:
    """roofline.bound of a kernel_flops cost."""
    return bound(cost["bytes"], cost["ops"])


def int_max_abs_err(a, b) -> float:
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def event_ms(fn) -> tuple[float, object]:
    """Device time of one call of fn by CUDA events, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _bit_equal(got, ref) -> bool:
    """Every field of two Hit tuples equal, bit for bit: the intersect
    kernels repeat their plain versions' arithmetic in the same order
    (built with -fmad=false), so they must agree exactly."""
    return all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))


def _pretest_counts(table, ro, rd) -> dict:
    """The plain mirror of the dense kernel's pre-test (pretest_pass) on
    these rays: the tests the kernel runs (second triangles of quads with
    p3 == p4 are skipped) and those that pass the pre-test and reach the
    reciprocal, the same on the first PRETEST_SUBSET rays, and the (warp
    of 32 rays, test) pairs in which some lane reaches it (a warp runs the
    reciprocal's path if any lane does)."""
    quads = torch.from_numpy(table.quads).to(ro.device)
    tested = quads[:, 18] == 0.0
    c = dict(tests=0, reach=0, sub_tests=0, sub_reach=0, warp_tests=0,
             warp_reach=0)
    n = ro.shape[0] // 32 * 32
    for second in (False, True):
        reach = di.pretest_pass(ro, rd, quads, second)
        if second:
            reach = reach[:, tested]
        c["tests"] += reach.numel()
        c["reach"] += int(reach.sum())
        c["sub_tests"] += reach[:PRETEST_SUBSET].numel()
        c["sub_reach"] += int(reach[:PRETEST_SUBSET].sum())
        warp = reach[:n].view(n // 32, 32, -1).any(dim=1)
        c["warp_tests"] += warp.numel()
        c["warp_reach"] += int(warp.sum())
    return c


def phase_intersect(dev, table, turn_inputs: dict | None) -> dict:
    """262,144 rays (camera rays and bounce-like rays from inside the box)
    against the Cornell quads: kernel vs plain version on the card, the
    pre-test's reach counted by its plain mirror; the rays and the plain
    version's result go into `turn_inputs` when it is a dict."""
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
    ref = di.dense_intersect_plain(table.prims, *args)
    torch.cuda.synchronize()
    err = check_hits(ref, got)
    require(_bit_equal(got, ref), "dense kernel and plain version differ")
    require(got.hit.float().mean() > 0.5, "too few intersect hits")
    plain_ms = median_ms(lambda: di.dense_intersect_plain(table.prims, *args))
    t = kernel_ms(lambda: di.dense_intersect(table, *args))
    c = _pretest_counts(table, args[0], args[1])
    cost = kf.dense_intersect_cost(
        N_RAYS, table.quads.nbytes + table.prims.numel() * 4, c["tests"],
        c["reach"])
    out = dict(max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
               pretest=c, **cost_bound(cost))
    old_bound = bound(cost["bytes"],
                      c["tests"] * kf.DENSE_OPS_PER_TRI_TEST)["bound_ms"]
    if turn_inputs is not None:
        turn_inputs.update(dense_args=[x.cpu() for x in args],
                           dense_ref=[x.cpu() for x in ref])
    log(f"dense_intersect: {N_RAYS} rays x {c['tests'] // N_RAYS} triangle "
        f"tests; share of tests that pass the pre-test and reach the "
        f"reciprocal (plain mirror): {c['sub_reach'] / c['sub_tests']:.4f} on "
        f"a subset, the first {PRETEST_SUBSET} rays; "
        f"{c['reach'] / c['tests']:.4f} on all; (warp, test) pairs with a "
        f"lane that reaches it {c['warp_reach'] / c['warp_tests']:.4f}; kernel "
        f"{out['ms']:.4f} ms (device; {out['call_ms']:.4f} ms with the "
        f"host's launch), bound {out['bound_ms']:.4f} ms ({out['bound_by']}; "
        f"{old_bound:.4f} ms at {kf.DENSE_OPS_PER_TRI_TEST} operations a test, "
        f"the count before the pre-test)")
    return out


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
    """Bit-exact pack of 45 adversarial planes, n=262,144 -> cap=65,536.
    Library call: boolean-mask indexing vals[:, alive]."""
    g = np.random.default_rng(1)
    vals = _adversarial_planes(g, STATE_PLANES, N_RAYS, dev)
    alive = _alive(g, dev)
    total = int(alive.sum())
    got = lc.compact_planes(vals, alive, COMPACT_CAP)
    ref = lc.compact_planes_plain(vals, alive, COMPACT_CAP)
    lib = vals[:, alive]
    torch.cuda.synchronize()
    require(torch.equal(got[:, :total], ref[:, :total]), "compact not bit-exact")
    require(torch.equal(lib, ref[:, :total]), "vals[:, alive] differs")
    plain_ms = median_ms(lambda: lc.compact_planes_plain(vals, alive, COMPACT_CAP))
    t = kernel_ms(lambda: lc.compact_planes(vals, alive, COMPACT_CAP))
    library_ms = median_ms(lambda: vals[:, alive])
    return dict(max_abs_err=int_max_abs_err(got[:, :total], ref[:, :total]),
                **t, plain_ms=plain_ms, library_ms=library_ms,
                **cost_bound(kf.lane_compact_cost(STATE_PLANES, N_RAYS,
                                                  COMPACT_CAP)))


def phase_expand(dev) -> dict:
    """Bit-exact scatter of 11 output planes from cap=65,536 to n=262,144.
    Library call: fallback.masked_scatter(alive, narrow[:, :survivors])."""
    g = np.random.default_rng(2)
    narrow = _adversarial_planes(g, OUTPUT_PLANES, COMPACT_CAP, dev)
    fallback = _adversarial_planes(g, OUTPUT_PLANES, N_RAYS, dev)
    alive = _alive(g, dev)
    total = int(alive.sum())
    got = lc.expand_planes(narrow, alive, fallback)
    ref = lc.expand_planes_plain(narrow, alive, fallback)

    def library():
        return fallback.masked_scatter(alive[None, :], narrow[:, :total])

    lib = library()
    torch.cuda.synchronize()
    require(torch.equal(got, ref), "expand not bit-exact")
    require(torch.equal(lib, ref), "masked_scatter differs")
    plain_ms = median_ms(lambda: lc.expand_planes_plain(narrow, alive, fallback))
    t = kernel_ms(lambda: lc.expand_planes(narrow, alive, fallback))
    library_ms = median_ms(library)
    return dict(max_abs_err=int_max_abs_err(got, ref), **t,
                plain_ms=plain_ms, library_ms=library_ms,
                **cost_bound(kf.lane_expand_cost(OUTPUT_PLANES, COMPACT_CAP,
                                                 N_RAYS)))


def _primary_rays(renderer, dev, res=MAIN_RES):
    """The camera rays of sample 0 of the res x res frame (default 512 x
    512)."""
    pix = torch.arange(res * res, dtype=torch.int32, device=dev)
    rng = rng_mod.seed_state(pix, 0, 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = torch.stack([pix % res, pix // res], dim=-1)
    ro, rd = sample_camera(renderer.cam_arrays, ij, (res, res),
                           puv, luv, False)
    n = ro.shape[0]
    return (ro.contiguous(), rd.contiguous(),
            torch.full((n,), 1e-4, device=dev),
            torch.full((n,), 3.4e38, device=dev))


def _sorted(rays, renderer):
    """Rays in the order trace_wavefront sorts them: by the wavefront key
    over the scene's bounds, dead lanes (tmax < 0) last."""
    key = _sort_key(rays[0], rays[1],
                    *sort_bounds(renderer.dscene, renderer.config))
    key = torch.where(rays[3] > 0, key, 0x7FFFFFFF)
    perm = torch.argsort(key, stable=True)
    return tuple(x[perm].contiguous() for x in rays)


def _bounce_rays(hit, rd, dev):
    """Cosine-distributed rays from the primary hits about the normal that
    faces the incoming ray; lanes that missed are dead (tmax = -1)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = rd.shape[0]
    nrm = torch.where(((hit.gnormal * rd).sum(-1) > 0)[:, None],
                      -hit.gnormal, hit.gnormal)
    d = normalize(nrm + normalize(torch.randn((n, 3), generator=gen, device=dev)))
    tmax = torch.where(hit.hit, 3.4e38, -1.0)
    return (hit.position.contiguous(), d.contiguous(),
            torch.full((n,), 1e-4, device=dev), tmax.contiguous())


def _walk_counters(work) -> str:
    """The warp walk's work counters as one log fragment."""
    return (f"warps walking {work['groups']}, (warp, list entry) steps "
            f"{work['steps']}, mask votes {work['votes']} (one per step a ray "
            f"enters, none per cluster), (warp, cluster) table loads "
            f"{work['warp_pairs']}, (ray, cluster) pairs walked "
            f"{work['pairs']} (needed, the bound's: {work['bound_pairs']}), "
            f"rays per table load "
            f"{work['pairs'] / max(work['warp_pairs'], 1):.3f}, lanes busy in "
            f"the triangle loop "
            f"{work['tri_slots'] / max(work['pairs'] * wl.TRIS, 1):.4f} (of "
            f"each pair's 32 lanes x 4 test slots, those that hold a real "
            f"triangle)")


def _worklist_case(tables, rays) -> dict:
    order, cnt = wl.precull(*rays, tables.sbbox)
    got = wl.worklist_intersect_kernel(tables, *rays, order, cnt)
    t0 = time.perf_counter()
    ref, work = wl.worklist_intersect_plain(tables, *rays, order, cnt)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    err = check_hits(ref, got)
    bit_equal = _bit_equal(got, ref)
    same_prim = float((got.prim == ref.prim).float().mean())
    require(bit_equal, f"worklist kernel and plain version differ (same prim "
            f"{same_prim:.6f}, max |dt| {err})")
    t = kernel_ms(lambda: wl.worklist_intersect_kernel(tables, *rays, order, cnt))
    plain_ms = median_ms(
        lambda: wl.worklist_intersect_plain(tables, *rays, order, cnt),
        PLAIN_WORKLIST_REPS)
    precull_ms = median_ms(lambda: wl.precull(*rays, tables.sbbox))
    # the bound counts what the call needs (wl.call_cost, as the
    # dispatcher reports it): the pairs entered before the closest hit
    bound_pairs, _ = wl.needed_pairs(tables, *rays[:3], got.t, order, cnt)
    return dict(
        max_abs_err=err, bit_equal=bit_equal, same_prim=same_prim, **t,
        plain_ms=plain_ms, plain_wall_s=plain_wall, precull_ms=precull_ms,
        library_ms=None, hit_rate=float(got.hit.float().mean()),
        mean_list=float(cnt.float().mean()), **work, bound_pairs=bound_pairs,
        **cost_bound(wl.call_cost(tables, *rays[:3], got.t, order, cnt)),
    )


def phase_worklist(dev, renderer, primary, bounce) -> dict:
    """The sphere grid (102,406 quads, 13 superclusters of 128 clusters) at
    262,144 rays, twice: the 512 x 512 camera rays, then cosine bounce rays
    from their hits (divergent, long work lists), both in pixel order.
    Kernel vs plain version on the card; no PyTorch
    call computes this function (library_ms null). Then the kernel alone
    on the same rays in the wavefront sort's order, as the sorted main
    path sends them."""
    tables = renderer.intersect.tables
    p = _worklist_case(tables, primary)
    b = _worklist_case(tables, bounce)
    for name, c in (("primary", p), ("bounce", b)):
        log(f"worklist {name}: {N_RAYS} rays, hit rate {c['hit_rate']:.4f}, "
            f"bit-equal {c['bit_equal']}, same prim {c['same_prim']:.6f}, "
            f"max |dt| {c['max_abs_err']}, mean work list {c['mean_list']:.3f} "
            f"of {tables.sbbox.shape[0]} per {wl.GROUP_RAYS} rays, "
            f"{_walk_counters(c)}, kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} "
            f"ms (one call {c['plain_wall_s']:.2f} s wall), precull "
            f"{c['precull_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), library call: none")
    require(p["hit_rate"] > 0.5, "too few primary hits on the sphere grid")
    sorted_ms = {}
    for name, rays in (("primary", primary), ("bounce", bounce)):
        rays = _sorted(rays, renderer)
        order, cnt = wl.precull(*rays, tables.sbbox)
        sorted_ms[name] = median_ms(
            lambda: wl.worklist_intersect_kernel(tables, *rays, order, cnt))
        log(f"worklist {name}, sorted rays: kernel {sorted_ms[name]:.4f} ms "
            f"(pixel order: {(p if name == 'primary' else b)['ms']:.4f} ms), "
            f"mean work list {float(cnt.float().mean()):.3f}")
    sweep = {}
    for g in GROUP_SWEEP:
        order, cnt = wl.precull(*bounce, tables.sbbox, g)
        sweep[g] = dict(
            precull_ms=median_ms(lambda: wl.precull(*bounce, tables.sbbox, g), 5),
            kernel_ms=median_ms(lambda: wl.worklist_intersect_kernel(
                tables, *bounce, order, cnt, g), 5),
            mean_list=float(cnt.float().mean()))
        log(f"worklist bounce rays, work lists per {g} rays: precull "
            f"{sweep[g]['precull_ms']:.4f} ms, kernel {sweep[g]['kernel_ms']:.4f} "
            f"ms, mean work list {sweep[g]['mean_list']:.3f}")
    return dict(b, primary={k: p[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "pairs",
        "bound_pairs", "warp_pairs", "groups", "steps", "votes", "mean_list", "precull_ms")},
        sorted_rays_ms=sorted_ms, group_sweep=sweep)


def _heavy_rays(renderer, dev):
    """The heavy scene's 512 x 512 camera rays and cosine bounce rays from
    their hits (dead where the camera ray missed), each in the wavefront
    sort's order, as the sorted main path sends them."""
    primary = _sorted(_primary_rays(renderer, dev), renderer)
    hit = wl.worklist_intersect(renderer.intersect.tables, *primary)
    return primary, _sorted(_bounce_rays(hit, primary[1], dev), renderer)


def _rays8(rays):
    ro, rd, tmin, tmax = rays
    return torch.cat([ro, rd, tmin[:, None], tmax[:, None]], dim=1).contiguous()


def _plan(tables, rays8):
    """The count stage, the group count read back, the group -> super map."""
    plan = rg.count_stage(rays8, tables.sbbox)
    n_groups = int(plan.groups_s.sum())
    grp_super = torch.repeat_interleave(
        torch.arange(len(plan.groups_s), dtype=torch.int32, device=rays8.device),
        plan.groups_s.long(), output_size=n_groups)
    return plan, n_groups, grp_super


def _float_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_regroup(dev, renderer, bounce, turn_inputs: dict | None) -> dict:
    """The three regroup kernels on the heavy scene's 262,144 bounce rays:
    each against its plain version on the card, bit for bit, with its
    bound and, for pack, the library gather of the rays in the stable
    (super, tile, lane) order; the tri-test's walk counters and what the
    pair walks meet. The three kernels' inputs and their plain versions'
    results go into `turn_inputs` when it is a dict."""
    tables = renderer.intersect.tables
    rays8 = _rays8(bounce)
    plan, n_groups, grp_super = _plan(tables, rays8)
    n_slots = n_groups * rg.TILE
    nb, n_super, _ = plan.bits.shape
    set_bits = int(plan.cnt_s.sum())
    live_pairs = int((plan.cnt_ts > 0).sum())
    live_lanes = int(plan.bits.any(dim=1).sum())
    # the plan as pack and unpack must read it: every pair's count (to skip
    # the empty pairs), and the bits and slot base of the live pairs only
    plan_bytes = kf.regroup_plan_bytes(plan.cnt_ts.numel(), live_pairs)
    # what the pair walks of pack and unpack meet: the words (32 lanes) of
    # the live pairs that hold a set bit, each one step of a walk, and how
    # unevenly the tiles (one unpack CTA pair each) hold them
    tile_words = plan.bits.view(nb, n_super, 32, 32).any(dim=-1).sum(dim=(1, 2))
    words = int(tile_words.sum())
    tile_pairs = (plan.cnt_ts > 0).sum(dim=1)
    log(f"regroup plan: {nb} tiles x {n_super} supers, {set_bits} set bits "
        f"of {live_lanes} lanes in {live_pairs} live (tile, super) pairs, "
        f"{n_groups} groups of 1024 slots; pair walks (pack, unpack): "
        f"{live_pairs} live pairs of {nb * n_super} "
        f"({live_pairs / (nb * n_super):.4f}), {words} non-empty words "
        f"({words / max(live_pairs, 1):.2f} a live pair), {set_bits} set bits "
        f"({set_bits / max(live_pairs, 1):.2f} a live pair, "
        f"{set_bits / max(words, 1):.2f} a word); a tile's live pairs mean "
        f"{live_pairs / nb:.2f}, max {int(tile_pairs.max())}, its non-empty "
        f"words mean {words / nb:.2f}, max {int(tile_words.max())}")

    # ---- pack
    packed = rg.regroup_pack(plan, rays8, n_slots)
    ref = rg.regroup_pack_plain(plan, rays8, n_slots)
    s_i, t_i, lane = torch.nonzero(plan.bits.permute(1, 0, 2), as_tuple=True)
    order = t_i * rg.TILE + lane
    lib = rays8[order]
    torch.cuda.synchronize()
    require(torch.equal(packed.view(torch.int32), ref.view(torch.int32)),
            "regroup_pack kernel and plain version differ")
    require(torch.equal(packed[packed[:, 7] != -1.0], lib),
            "the gather rays[stable nonzero order] differs from pack")
    pack = dict(
        max_abs_err=_float_err(packed, ref),
        **kernel_ms(lambda: rg.regroup_pack(plan, rays8, n_slots)),
        plain_ms=median_ms(lambda: rg.regroup_pack_plain(plan, rays8, n_slots),
                           PLAIN_REPS),
        library_ms=median_ms(lambda: rays8[order]),
        # + seg_base and cnt_s, each lane that enters a super read once,
        # every slot (padding included) written once
        **cost_bound(kf.regroup_pack_cost(plan_bytes, n_super, live_lanes,
                                          packed.numel())))

    # ---- tri-test
    tri = rg.regroup_tritest(packed, tables, grp_super)
    plain_ms, (tri_ref, work) = event_ms(
        lambda: rg.regroup_tritest_plain(packed, tables, grp_super))
    require(torch.equal(tri, tri_ref),
            "regroup_tritest kernel and plain version differ")
    if turn_inputs is not None:
        turn_inputs.update(
            packed=packed.cpu(), grp_super=grp_super.cpu(), tri_ref=tri_ref.cpu(),
            tables={k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in tables._asdict().items()},
            plan={k: v.cpu() for k, v in plan._asdict().items()},
            rays8=rays8.cpu(), pack_ref=ref.cpu())
    tritest = dict(
        max_abs_err=int_max_abs_err(tri, tri_ref),
        **kernel_ms(lambda: rg.regroup_tritest(packed, tables, grp_super)),
        plain_ms=plain_ms, library_ms=None, **work,
        **cost_bound(kf.regroup_tritest_cost(
            packed.numel(), work["clusters"], torch.unique(grp_super).numel(),
            tables.sup, grp_super.numel(), tri.numel(), work["passes"])))
    log(f"regroup_tritest: {packed.shape[0]} slots in {n_groups} groups, "
        f"{work['warps']} warps, {work['votes']} of them vote (the rest hold "
        f"only padding and leave), (warp, cluster) table loads "
        f"{work['warp_pairs']} ((group, cluster) pairs {work['group_passes']}, "
        f"distinct clusters {work['clusters']}), (slot, cluster) passes in "
        f"the bound {work['passes']}, slots per table load "
        f"{work['passes'] / max(work['warp_pairs'], 1):.3f}, lanes busy in the "
        f"triangle loop {work['tri_slots'] / max(work['passes'] * wl.TRIS, 1):.4f}"
        f" (of each pass's 32 lanes x 4 test slots, those that hold a real "
        f"triangle), kernel {tritest['ms']:.4f} ms, bound "
        f"{tritest['bound_ms']:.4f} ms, plain version {plain_ms / 1e3:.2f} s")

    # ---- unpack
    res = rg.regroup_unpack(plan, tri)
    res_ref = rg.regroup_unpack_plain(plan, tri)
    torch.cuda.synchronize()
    require(torch.equal(res, res_ref), "regroup_unpack kernel and plain version differ")
    if turn_inputs is not None:
        turn_inputs.update(unpack_ref=res_ref.cpu())
    unpack = dict(
        max_abs_err=int_max_abs_err(res, res_ref),
        **kernel_ms(lambda: rg.regroup_unpack(plan, tri)),
        plain_ms=median_ms(lambda: rg.regroup_unpack_plain(plan, tri), PLAIN_REPS),
        library_ms=None,
        **cost_bound(kf.regroup_unpack_cost(plan_bytes, set_bits,
                                            res.numel())))
    stages = dict(rays8=rays8, res=res, plan=plan, packed=packed, tri=tri,
                  grp_super=grp_super)
    return dict(regroup_pack=pack, regroup_tritest=tritest,
                regroup_unpack=unpack), stages


def phase_regroup_vs_worklist(dev, renderer, primary, bounce, stages, soups):
    """The whole regroup intersector (count, three kernels, merge) against
    the worklist intersector (precull, kernel) on the heavy scene's camera
    and bounce rays: check_hits, both times, the fallbacks; both again on
    the bounce rays with fewer of them live; then the H100's SelectCosts
    fitted from the stage times on the bounce rays and kernel_select's
    pass counts of the same rays, and regroup="auto"'s choice with the
    module's and the fitted costs on each of `soups` ({name: (verts,
    instances)}: the heavy scene and the hybrid's flattened soup)."""
    tables = renderer.intersect.tables
    out = {}
    for name, rays in (("camera", primary), ("bounce", bounce)):
        fb0 = rg.regroup_intersect.fallbacks
        h_rg = rg.regroup_intersect(tables, *rays)
        fb = rg.regroup_intersect.fallbacks - fb0
        h_wl = wl.worklist_intersect(tables, *rays)
        torch.cuda.synchronize()
        err = check_hits(h_wl, h_rg)
        rg_ms = median_ms(lambda: rg.regroup_intersect(tables, *rays), 5)
        wl_ms = median_ms(lambda: wl.worklist_intersect(tables, *rays), 5)
        rg_dev = profiled_ms(lambda: rg.regroup_intersect(tables, *rays))
        wl_dev = profiled_ms(lambda: wl.worklist_intersect(tables, *rays))
        out[name] = dict(
            regroup_ms=rg_ms, worklist_ms=wl_ms, ratio=rg_ms / wl_ms,
            regroup_device_ms=rg_dev, worklist_device_ms=wl_dev,
            device_ratio=rg_dev / wl_dev,
            fallbacks=fb, max_abs_dt=err,
            same_prim=float((h_rg.prim == h_wl.prim).float().mean()),
            hit_rate=float(h_wl.hit.float().mean()),
            live=float((rays[3] > 0).float().mean()))
        log(f"regroup vs worklist, {name} rays ({N_RAYS}, live share "
            f"{out[name]['live']:.4f}): within check_hits (same prim "
            f"{out[name]['same_prim']:.6f}, max |dt| {err}), regroup "
            f"{rg_ms:.4f} ms (fallbacks in the first call: {fb}), worklist "
            f"{wl_ms:.4f} ms, measured ratio {rg_ms / wl_ms:.4f} (one call "
            f"between CUDA events); device time (profiler) regroup "
            f"{rg_dev:.4f} ms, worklist {wl_dev:.4f} ms, ratio "
            f"{rg_dev / wl_dev:.4f}")

    # ---- the liveness gate's crossover on this card: the bounce rays with
    # a seeded share of them dead (tmax = -1, sorted last), regroup with no
    # gate against the worklist
    g = torch.Generator(device=dev).manual_seed(7)
    out["live_sweep"] = []
    for share in LIVE_SHARES:
        dead = torch.rand(N_RAYS, generator=g, device=dev) >= share
        rays = _sorted((*bounce[:3], torch.where(dead, -1.0, bounce[3])),
                       renderer)
        rg_ms = median_ms(lambda: rg.regroup_intersect(tables, *rays,
                                                       livegate=0.0), 5)
        wl_ms = median_ms(lambda: wl.worklist_intersect(tables, *rays), 5)
        live = float((rays[3] > 0).float().mean())
        out["live_sweep"].append(dict(live=live, regroup_ms=rg_ms,
                                      worklist_ms=wl_ms))
        log(f"bounce rays at live share {live:.4f}: regroup (no gate) "
            f"{rg_ms:.4f} ms, worklist {wl_ms:.4f} ms, ratio "
            f"{rg_ms / wl_ms:.4f}")

    # ---- stage times on the bounce rays and the cost fit, every term in
    # device time by the profiler (profiled_ms), the whole calls included
    rays8, plan, packed = stages["rays8"], stages["plan"], stages["packed"]
    t_plan = median_ms(lambda: _plan(tables, rays8))
    t_count = profiled_ms(lambda: rg.count_stage(rays8, tables.sbbox))
    t_pack = profiled_ms(lambda: rg.regroup_pack(plan, rays8, packed.shape[0]))
    t_tri = profiled_ms(lambda: rg.regroup_tritest(packed, tables,
                                                   stages["grp_super"]))
    t_unpack = profiled_ms(lambda: rg.regroup_unpack(plan, stages["tri"]))
    t_merge = profiled_ms(lambda: rg.merge(tables, rays8, stages["res"]))
    n_clusters = -(-renderer.config.n_prims // 64)
    np_rays = [x.cpu().numpy() for x in bounce]
    counts = ks.count_passes(*np_rays, tables.bbox[:n_clusters, :6].cpu().numpy(),
                             device=dev)
    t_rg = out["bounce"]["regroup_device_ms"]
    t_wl = out["bounce"]["worklist_device_ms"]
    # the signed remainder (the live count, the group map, the copies):
    # negative when the stages timed one by one add up to more than the
    # whole call, and then the fit is flagged
    fixed = t_rg - (t_count + t_pack + t_tri + t_unpack + t_merge)
    costs = ks.SelectCosts(
        us_wl_pass=t_wl * 1e3 / counts["passes_wl"],
        us_rg_pass=t_tri * 1e3 / counts["passes_rg"],
        us_rg_pair=(t_pack + t_unpack) * 1e3 / counts["pairs"],
        us_rg_ray=(t_count + t_merge) * 1e3 / N_RAYS,
        ms_rg_fixed=fixed)
    log(f"regroup stages on the bounce rays (device times by the profiler): "
        f"count stage {t_count:.4f} ms ({t_plan:.4f} ms with the group count "
        f"read back and the group map, _plan, between CUDA events), pack "
        f"{t_pack:.4f}, tri-test {t_tri:.4f}, unpack {t_unpack:.4f}, merge "
        f"{t_merge:.4f}, rest {fixed:.4f} (whole {t_rg:.4f}; worklist "
        f"{t_wl:.4f}); kernel_select counts on these rays {counts}")
    log(f"fitted H100 SelectCosts: {costs._asdict()}"
        + ("" if fixed >= 0.0 else " FLAGGED: the stages timed apart sum to "
           f"{-fixed:.4f} ms more than the whole, so ms_rg_fixed < 0"))
    out["fit_flagged"] = fixed < 0.0
    out["auto"] = {}
    for scene, (verts, inst) in soups.items():
        for order in ("sorted", "as sampled"):
            t0 = time.perf_counter()
            sc = ks.bounce_counts(verts, inst, device=dev,
                                  sort_rays=order == "sorted")
            probe_s = time.perf_counter() - t0
            # the renderer's decision counts the rays sorted
            for label, c in (("module", ks.H100_COSTS), ("fitted", costs)):
                sel = ks.decide(ks.ratio_from_counts(sc, c))
                log(f"regroup='auto' on {scene} ({len(verts)} quads) with the "
                    f"{label} costs: predicted ratio {sel['ratio']} on "
                    f"{sel['n_rays']} synthetic bounce rays counted {order} -> "
                    f"{sel['kernel']} (threshold {sel['threshold']}, passes wl "
                    f"{sel['passes_wl']} rg {sel['passes_rg']}, pairs "
                    f"{sel['pairs']}, probe {probe_s:.1f} s)"
                    + (f"; measured on this run's heavy bounce rays "
                       f"{t_rg / t_wl:.4f} in device time"
                       if scene == "heavy" else ""))
                out["auto"].setdefault(scene, {})[f"{label}, {order}"] = {
                    k: sel[k] for k in ("ratio", "kernel", "passes_wl",
                                        "passes_rg", "pairs")}
    out["fitted_costs"] = costs._asdict()
    out["stages_ms"] = dict(plan=t_plan, count=t_count, pack=t_pack,
                            tritest=t_tri, unpack=t_unpack, merge=t_merge,
                            rest=fixed)
    out["counts"] = counts
    return out


def _box_culls(work, n: int, n_clusters: int) -> float:
    """The slab tests a lane of a walking warp makes, on average: the
    sweep culls every cluster box; the streamed kernel culls each
    supercluster box and, in the (warp, supercluster) steps some ray
    enters (`steps`), its 64 cluster boxes."""
    if "steps" not in work:
        return float(n_clusters)
    n_warps = -(-n // wl.WARP)
    return (n_warps * -(-n_clusters // ci.SUPER)
            + work["steps"] * ci.SUPER) / n_warps


def phase_cluster(dev, renderer, rays, turn_inputs: dict | None) -> dict:
    """Rows 4 and 5 (ops/cluster_intersect.py: each warp of 32 rays sweeps
    every cluster, or every supercluster of 64 and then its clusters, each
    ray culling against its tmax) on the sphere grid's 262,144 pixel-order
    bounce rays: each kernel against its plain version on the card, bit for
    bit, and within check_hits of the worklist intersector on the same rays
    (both pack the BVH-ordered quads, so prim ids agree); the walks' table
    loads (`loads`, counted by the plain versions). The bound counts
    what the function needs (ci.call_cost, as the dispatcher reports it):
    the (ray, cluster) pairs whose box the ray enters before its closest
    hit, `bound_pairs`, and the tables of their clusters; the kernels' own
    cull against tmax passes more. No PyTorch call
    computes this function (library_ms null). The tables, the rays and the
    plain versions' results go into `turn_inputs` when it is a dict."""
    cfg = renderer.config
    tables = ci.pack_tables(cfg.host_prim_verts, cfg.host_prim_instance, dev)
    ref = wl.worklist_intersect(renderer.intersect.tables, *rays)
    n = rays[0].shape[0]
    out = {}
    if turn_inputs is not None:
        turn_inputs.update(
            cluster_tables={k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in tables._asdict().items()},
            cluster_rays=[x.cpu() for x in rays])
    for name, kernel, plain, box_bytes in (
            ("cluster_intersect", ci.cluster_intersect_kernel,
             ci.cluster_intersect_plain, ci.n_clusters(tables) * 32),
            ("cluster_intersect_streamed", ci.cluster_intersect_streamed_kernel,
             ci.cluster_intersect_streamed_plain,
             (tables.bbox.numel() + tables.sbbox.numel()) * 4)):
        got = kernel(tables, *rays)
        plain_ms, (want, work) = event_ms(lambda: plain(tables, *rays))
        require(_bit_equal(got, want), f"{name} kernel and plain version differ")
        err = check_hits(want, got)
        wl_dt = check_hits(ref, got)
        if turn_inputs is not None:
            turn_inputs[name + "_ref"] = [x.cpu() for x in want]
        t = kernel_ms(lambda: kernel(tables, *rays), CLUSTER_REPS)
        ms = t["ms"]
        need_pairs, need_clusters = ci.needed_pairs(tables, *rays[:3], got.t)
        out[name] = dict(
            max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
            bound_pairs=need_pairs, bound_clusters=need_clusters, **work,
            **cost_bound(ci.call_cost(tables, *rays[:3], got.t, box_bytes)))
        log(f"{name}: {n} sphere-grid bounce rays, {ci.n_clusters(tables)} "
            f"clusters in {tables.sbbox.shape[0]} supers of {ci.SUPER}, "
            f"bit-equal to its plain version, within check_hits of the "
            f"worklist (max |dt| {wl_dt}), (ray, cluster) pairs culled against "
            f"tmax {work['pairs']}, needed (entered before the closest hit) "
            f"{need_pairs} in {need_clusters} clusters, clusters tested "
            f"{work['clusters']}, (warp, "
            f"cluster) table loads {work['loads']}, rays per table load "
            f"{work['pairs'] / max(work['loads'], 1):.3f}, box culls a lane "
            f"{_box_culls(work, n, ci.n_clusters(tables)):.1f}, kernel "
            f"{ms:.4f} ms "
            f"({t['call_ms']:.4f} ms with the host's launch), plain "
            f"{plain_ms:.4f} ms, bound {out[name]['bound_ms']:.4f} ms "
            f"({out[name]['bound_by']})")
    return out


def f64_witness(scene, rays, lanes, t_inst, t_flat, dev) -> list[dict]:
    """The rays at `lanes` re-intersected in float64 against every world
    quad of `scene`, each transformed from its shape's float32 corners by
    its instance's float32 frame in float64 (so with neither float32
    side's rounding of the geometry or of the ray's transform), each quad
    split as the kernels split it. Per ray: the two float32 answers, the
    float64 closest t, which answers it agrees with (rtol 2e-4), the
    margin min(u, v, 1 - u - v) in float64 of the triangle that comes
    nearest to being hit at the nearer float32 answer (< 0: the ray passes
    outside it; near 0: through an edge), that triangle's |cos| to the
    ray, and the order of float32 rounding in its barycentrics: the ray's
    length to it over the triangle's size (sqrt of twice its area; the
    same in shape space, as instances only rotate, scale uniformly and
    move), times 2^-24, over |cos|."""
    geo = flatten_scene(scene, expand_prims=False).geometry
    idx = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
    ro, rd, tmin, tmax = (x[idx].double() for x in rays)
    ti, tf = t_inst[idx].double(), t_flat[idx].double()
    t_near = torch.minimum(ti, tf)[:, None]
    ro3 = [ro[:, k:k + 1] for k in range(3)]
    rd3 = [rd[:, k:k + 1] for k in range(3)]
    best = torch.full_like(tmin, math.inf)
    margin = torch.full_like(tmin, -math.inf)
    cosine = torch.full_like(tmin, math.nan)
    size = torch.full_like(tmin, math.nan)
    off = geo.shape_prim_offset
    for i, inst in enumerate(scene.instances):
        corners = geo.prim_verts[off[inst.shape]:off[inst.shape + 1]]
        if len(corners) == 0:
            continue
        frame = torch.as_tensor(inst.frame, dtype=torch.float64, device=dev)
        w = (torch.as_tensor(corners, dtype=torch.float64, device=dev)
             @ frame[:3] + frame[3])
        p = [[w[:, c, k] for k in range(3)] for c in range(4)]
        for a, b, c in ((p[0], p[1], p[3]), (p[2], p[3], p[1])):
            hit, u, v, t = _moller(ro3, rd3, tmin[:, None], tmax[:, None],
                                   a, b, c)
            best = torch.minimum(best, torch.where(hit, t, math.inf).amin(1))
            near = torch.isclose(t, t_near, rtol=2e-4, atol=2e-4)
            m = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
            m, arg = torch.where(near, m, -math.inf).max(1)
            e1 = torch.stack([b[k] - a[k] for k in range(3)], dim=1)
            e2 = torch.stack([c[k] - a[k] for k in range(3)], dim=1)
            n = torch.linalg.cross(e1, e2)[arg]
            cos = ((n * rd).sum(1).abs()
                   / (n.norm(dim=1) * rd.norm(dim=1)).clamp(min=1e-300))
            better = m > margin
            margin = torch.where(better, m, margin)
            cosine = torch.where(better, cos, cosine)
            size = torch.where(better, n.norm(dim=1).sqrt(), size)
    rounding = (t_near[:, 0] * rd.norm(dim=1) / size * 2.0**-24
                / cosine.clamp(min=1e-300))
    out = []
    for k in range(len(lanes)):
        t64 = float(best[k])
        agree = [name for name, t in (("instanced", ti[k]), ("flat", tf[k]))
                 if math.isclose(float(t), t64, rel_tol=2e-4, abs_tol=2e-4)]
        out.append(dict(lane=int(lanes[k]), t_instanced=float(ti[k]),
                        t_flat=float(tf[k]), t_f64=t64, agrees=agree,
                        near_margin=float(margin[k]),
                        near_cos=float(cosine[k]),
                        near_rounding=float(rounding[k])))
    return out


def phase_instanced(dev, renderer, scene) -> tuple[dict, dict]:
    """Row 7 (ops/instanced_intersect.py) on the instanced scene's 262,144
    bounce rays in the wavefront sort's order: the candidate cull
    (phase_cull), then the kernel against its plain version on the card,
    bit for bit, with its walk's counters; the precull and the kernel per
    candidate-list size of GROUP_SWEEP on the camera and bounce rays; the
    whole intersector (precull,
    kernel, normalised normals) within the check_vs_flat contract of the
    worklist intersector over the same scene flattened (7.8M quads), on
    the camera and the bounce rays, with at most INST_T_MISMATCH of the
    hits' t outside the tolerance; those rays re-intersected in float64
    (f64_witness). No PyTorch call computes this function (library_ms
    null)."""
    tables = renderer.intersect.tables
    primary = _sorted(_primary_rays(renderer, dev), renderer)
    hit = renderer.intersect(*primary)
    bounce = _sorted(_bounce_rays(hit, primary[1], dev), renderer)
    cull = phase_cull(tables, bounce)
    lists = ii.precull(*bounce, tables.clusters)
    got = ii.instanced_intersect_kernel(tables, *bounce, *lists)
    plain_ms, (want, work) = event_ms(
        lambda: ii.instanced_intersect_plain(tables, *bounce, *lists))
    require(_bit_equal(got, want),
            "instanced_intersect kernel and plain version differ")
    err = check_hits(want, got)
    t = kernel_ms(lambda: ii.instanced_intersect_kernel(tables, *bounce, *lists),
                  CLUSTER_REPS)
    ms = t["ms"]
    precull_ms = median_ms(lambda: ii.precull(*bounce, tables.clusters),
                           CLUSTER_REPS)
    n = bounce[0].shape[0]
    out = dict(max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
               precull_ms=precull_ms, **work,
               candidates=int(lists[2].sum()),
               bound_pairs=ii.needed_work(tables, *bounce[:3], got.t, lists[0],
                                          lists[2])["pairs"],
               # what the call needs (ii.call_cost, as the dispatcher
               # reports it): the walk bounded by each ray's closest hit
               **cost_bound(ii.call_cost(tables, *bounce[:3], got.t, lists[0],
                                         lists[2])))
    log(f"instanced_intersect: {n} sorted bounce rays, {len(tables.wi_sup)} "
        f"work items, candidates per {ii.GROUP_RAYS} rays "
        f"{float(lists[2].float().mean()):.1f} ({out['candidates']} in all), "
        f"{_walk_counters(out)}, clusters {work['clusters']}, bit-equal to "
        f"its plain version, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"precull (the cull kernel) {precull_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    out["group_sweep"] = _item_group_sweep(
        "instanced", tables, (("camera", primary), ("bounce", bounce)))
    t0 = time.perf_counter()
    _, flat_cfg = build_device_scene(scene, instancing=False, device="cpu")
    flat = wl.make_worklist_intersect(flat_cfg.host_prim_verts,
                                      flat_cfg.host_prim_instance, dev)
    out["flat_setup_s"] = time.perf_counter() - t0
    out["flat_quads"] = flat_cfg.n_prims
    del flat_cfg
    for name, rays in (("camera", primary), ("bounce", bounce)):
        ref = flat(*rays)
        got = ii.instanced_intersect(tables, *rays)
        res = check_vs_flat(ref, got, max_t_mismatch=INST_T_MISMATCH)
        res["f64"] = f64_witness(scene, rays, res["t_mismatch_lanes"], got.t,
                                 ref.t, dev)
        out[f"vs_flat_{name}"] = res
        sides = [",".join(w["agrees"]) or "neither" for w in res["f64"]]
        nearer = sum(math.isclose(min(w["t_instanced"], w["t_flat"]),
                                  w["t_f64"], rel_tol=2e-4, abs_tol=2e-4)
                     for w in res["f64"])
        margins = [w["near_margin"] for w in res["f64"]]
        cosines = [w["near_cos"] for w in res["f64"]]
        units = [w["near_margin"] / w["near_rounding"] for w in res["f64"]]
        log(f"instanced vs worklist over the scene flattened "
            f"({out['flat_quads']} quads, set-up {out['flat_setup_s']:.2f} s), "
            f"{name} rays: within check_vs_flat, t beyond rtol 2e-4 on "
            f"{res['t_mismatch']} of {int(ref.hit.sum())} hits "
            f"({res['t_mismatch_other_instance']} of them on another "
            f"instance; at most {INST_T_MISMATCH:g} of the hits allowed), "
            f"max |dt| elsewhere {res['max_dt']}, hit rate "
            f"{float(ref.hit.float().mean()):.4f}; float64 agrees with "
            f"{ {k: sides.count(k) for k in sorted(set(sides))} } (the nearer "
            f"answer on {nearer}), margins at the nearer t "
            f"{min(margins, default=0.0):.3g} to {max(margins, default=0.0):.3g}, "
            f"|cos| there {min(cosines, default=0.0):.3g} to "
            f"{max(cosines, default=0.0):.3g}, margins over the float32 "
            f"rounding scale {min(units, default=0.0):.3g} to "
            f"{max(units, default=0.0):.3g}")
    out["flat_worklist_ms"] = median_ms(lambda: flat(*bounce), 3)
    out["instanced_whole_ms"] = median_ms(
        lambda: ii.instanced_intersect(tables, *bounce), 3)
    log(f"instanced bounce rays: whole work-item intersector "
        f"{out['instanced_whole_ms']:.4f} ms, worklist over the flattened "
        f"scene {out['flat_worklist_ms']:.4f} ms")
    return out, cull


def _item_group_sweep(label, tables, named_rays) -> dict:
    """The work-item intersector's precull and kernel per candidate-list
    size of GROUP_SWEEP on each (name, rays), with the device memory of
    the lists at that size: order (i32) and t_low (f32), each [groups,
    items]."""
    sweep = {}
    items = tables.wi_sup.shape[0]
    for g in GROUP_SWEEP:
        row = {}
        for name, rays in named_rays:
            lg = ii.precull(*rays, tables.clusters, g)
            row[name] = dict(
                precull_ms=median_ms(
                    lambda: ii.precull(*rays, tables.clusters, g), 5),
                kernel_ms=median_ms(lambda: ii.instanced_intersect_kernel(
                    tables, *rays, *lg, group=g), 5),
                mean_list=float(lg[2].float().mean()),
                list_bytes=lg[0].shape[0] * items * (4 + 4))
            row[name]["sum_ms"] = row[name]["precull_ms"] + row[name]["kernel_ms"]
            del lg
        sweep[g] = row
        log(f"{label}, candidate lists per {g} rays: " + ", ".join(
            f"{k} rays precull {v['precull_ms']:.4f} ms + kernel "
            f"{v['kernel_ms']:.4f} ms = {v['sum_ms']:.4f} ms (mean list "
            f"{v['mean_list']:.1f} of {items}, lists {v['list_bytes'] / 1e9:.3f} "
            f"GB)" for k, v in row.items()))
    return sweep


def phase_hybrid_sweep(dev, renderer) -> dict:
    """The candidate-list size sweep on the hybrid scene's work items: the
    rays the hybrid intersector hands the work-item intersector (tmax cut
    at the soup's hit), captured from the arguments of instanced_intersect
    (which the hybrid's work-item part calls), for the sorted camera rays
    and their bounce rays."""
    captured = []
    intersect = ii.instanced_intersect

    def capture(*args):
        captured.append(args)
        return intersect(*args)

    ii.instanced_intersect = capture
    try:
        primary = _sorted(_primary_rays(renderer, dev), renderer)
        hit = renderer.intersect(*primary)
        bounce = _sorted(_bounce_rays(hit, primary[1], dev), renderer)
        renderer.intersect(*bounce)
    finally:
        ii.instanced_intersect = intersect
    require(len(captured) == 2, "the hybrid intersector did not call the "
            "work-item kernel once per ray set")
    tables = captured[0][0]
    named = (("camera", captured[0][1:]), ("bounce", captured[1][1:]))
    return _item_group_sweep("hybrid", tables, named)


def phase_cull(tables, rays) -> dict:
    """The candidate cull (ops/instanced_intersect.py
    candidate_lists_kernel) on the instanced scene's sorted bounce rays
    against its work items: the kernel's lists against the plain lists
    (candidate_lists_plain: the plain keys and a stable argsort) on the
    card, bit for bit where they are read, its counters against
    cluster_pass_plain's. Bound: the slab tests it makes
    (kf.candidate_cull_cost over its counters) against the rays, the
    boxes and the lists. No single PyTorch call computes it (library_ms
    null)."""
    cl = tables.clusters
    *got, counts = ii.candidate_lists_kernel(*rays, cl)
    want = ii.candidate_lists_plain(*rays, cl.boxes)
    require(same_lists(got, want), "candidate_cull kernel and plain differ")
    _, plain = ii.cluster_pass_plain(*rays, cl)
    require(all(int(counts[k]) == int(plain[k]) for k in plain),
            "candidate_cull counters and cluster_pass_plain differ")
    t = kernel_ms(lambda: ii.candidate_lists_kernel(*rays, cl))
    ms = t["ms"]
    plain_ms = median_ms(lambda: ii.candidate_lists_plain(*rays, cl.boxes),
                         PLAIN_REPS)
    ng, items = got[0].shape
    counts = {k: int(v) for k, v in counts.items()}
    out = dict(max_abs_err=0.0, **t, plain_ms=plain_ms, library_ms=None,
               candidates=int(got[2].sum()), **counts,
               **cost_bound(kf.candidate_cull_cost(
                   rays[0].shape[0], ng, ii.GROUP_RAYS, items,
                   cl.cluster_boxes.shape[0], counts["cluster_tests"],
                   counts["item_tests"], int(got[2].sum()))))
    log(f"candidate_cull: {rays[0].shape[0]} sorted bounce rays in {ng} "
        f"groups of {ii.GROUP_RAYS} x {items} items "
        f"({cl.cluster_boxes.shape[0]} clusters), lists bit-equal to the "
        f"plain lists ({out['candidates']} candidates), tested "
        f"{counts['tested']} of {ng * items} (group, item) pairs, "
        f"{counts['cluster_tests']} cluster and {counts['item_tests']} item "
        f"tests, {counts['spills']} spills, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}), library call: none")
    return out


def phase_span_stamp(dev) -> dict:
    """The `precull` device_span (utils/timing.py, its clock stamps from
    ops/span_stamp.py) at the sphereflake's body shapes: FLAKE_RES² sorted
    bounce rays against its 22,143 work items. Eager, the span's
    device_ns is > 0 and at most the CUDA events' time around the call,
    and its counts are the cull kernel's. Captured into a CUDA graph under
    timing.capturing (render/body_graphs.py CudaCapture, as a body is)
    and replayed twice: the record's copied counts (candidates, tested,
    spills) equal the eager tensors and stamp's CPU plain version on
    them, bit for bit, and its clock slot is > 0 and at most the CUDA
    events' time around the same replay."""
    scene = sphereflake_scene()
    flake = Renderer(scene, Params(
        resolution=FLAKE_RES, samples=1, batch=1, bounces=MAIN_BOUNCES,
        sampler="path"), device=dev)
    cl = flake.intersect.tables[1].clusters
    primary = _sorted(_primary_rays(flake, dev, FLAKE_RES), flake)
    bounce = _sorted(_bounce_rays(flake.intersect(*primary), primary[1],
                                  dev), flake)
    del primary
    _, _, cnt, counts = ii.candidate_lists_kernel(*bounce, cl)
    eager = torch.stack([cnt.sum(dtype=torch.int64), counts["tested"],
                         counts["spills"]]).cpu()
    plain = torch.zeros(3, dtype=torch.int64)
    span_stamp.stamp(torch.zeros((), dtype=torch.int64), True,
                     list(eager.unbind()), plain)
    require(torch.equal(plain, eager), "span_stamp's plain copy differs")

    def eager_span():
        with timing.span("frame"):
            ii.precull(*bounce, cl)

    eager_ms = event_ms(eager_span)[0]
    row = timing.units()[-1]["table"]["frame/precull"]
    require(torch.equal(torch.tensor([row["candidates"], row["tested"],
                                      row["spills"]]), eager),
            "the eager precull span's counts differ from the kernel's")
    require(0 < row["device_ns"] <= eager_ms * 1e6,
            f"the eager precull span's clock reads {row['device_ns']} ns "
            f"against {eager_ms * 1e6:.0f} ns of CUDA events")

    spans = timing.CapturedSpans(dev)
    static = [x.clone() for x in bounce]

    def run():
        with timing.capturing(spans):
            ii.precull(*static, cl)

    replay = bg.CudaCapture()(run, static)
    (path, _, slot, slots), = spans.spans
    require(path == "precull" and spans.used == 4,
            f"the captured precull noted {spans.spans}, {spans.used} slots")
    replays = []
    for _ in range(2):
        ms = event_ms(replay)[0]
        rec = spans.record.cpu()
        got = rec[[slots[k] for k in ("candidates", "tested", "spills")]]
        require(torch.equal(got, eager) and torch.equal(got, plain),
                f"the replayed precull's counts {got.tolist()} differ from "
                f"the eager {eager.tolist()}")
        require(0 < int(rec[slot]) <= ms * 1e6,
                f"the replayed precull's clock reads {int(rec[slot])} ns "
                f"against {ms * 1e6:.0f} ns of CUDA events")
        replays.append((int(rec[slot]) / 1e6, ms))
    out = dict(rays=bounce[0].shape[0], items=cl.boxes.shape[0],
               **dict(zip(("candidates", "tested", "spills"),
                          eager.tolist())),
               eager_span_ms=row["device_ns"] / 1e6, eager_event_ms=eager_ms,
               replay_span_ms=[r[0] for r in replays],
               replay_event_ms=[r[1] for r in replays])
    del flake, bounce, static, replay
    return out


def phase_curve_walk(dev) -> dict:
    """The culled curve walk (ops/curve_intersect.py) at the tree-path8
    cell's body shapes: the SPD tree (benchmark/scenes/spd_tree.py, 4,095
    lines and 4,095 points over 4 quads) at FLAKE_RES², on camera rays
    and on bounce rays, each at 1,048,576 and 262,144 lanes. On each set
    the kernel equals curve_walk_plain bit for bit (closest line and
    point, and the pairs tested) on the same lists, and the route's hits
    equal the plain sweep's (merge_curves without tables) in every field.
    Then three frames replayed from CUDA graphs equal three eager ones bit
    for bit, and every `body` span after a width's first two is
    `graphed`. Returns the cull's and the walk's counts and times."""
    from benchmark.modes.render_curves import to_program_scene
    from benchmark.scenes import spd_tree

    from julia_raytracer_tpu_torch.render import integrator as tint

    scene = to_program_scene(spd_tree.build())
    params = Params(resolution=FLAKE_RES, samples=1 << 20, batch=1,
                    bounces=MAIN_BOUNCES, sampler="path", seed=9)
    tree = Renderer(scene, params, device=dev)
    tables = tree.intersect.curves
    require(tables is not None, "the tree's route has no culled curve walk")
    with mock.patch.object(tint, "CURVE_WALK_DEVICES", ()):
        sweep = tint.build_intersector(tree.dscene, tree.config)
    with mock.patch.object(tint, "curve_wrap", lambda q, d, c: q):
        quads = tint.build_intersector(tree.dscene, tree.config)
    require(sweep.curves is None and quads.curves is None,
            "the sweep's and the quads' routes took the walk")
    q = tree.config.n_prims
    primary = _primary_rays(tree, dev, FLAKE_RES)
    camera_hit = tree.intersect(*primary)
    bounce = _bounce_rays(camera_hit, primary[1], dev)
    out = dict(camera_curve_share=float(
        (camera_hit.hit & (camera_hit.prim >= q)).float().mean()),
        camera_hit_share=float(camera_hit.hit.float().mean()))
    del camera_hit
    for label, rays in (("camera", primary), ("bounce", bounce)):
        for n in (1 << 20, 1 << 18):
            ro, rd, tmin, tmax = (x[:n].contiguous() for x in rays)
            qh = quads(ro, rd, tmin, tmax)
            bt = torch.where(qh.hit, qh.t, tmax)
            lists = ii.precull(ro, rd, tmin, bt, tables.clusters)
            got, tested = cw.curve_intersect_kernel(tables, ro, rd, tmin, bt,
                                                    *lists)
            t0 = time.perf_counter()
            ref, ref_tested = cw.curve_walk_plain(tables, ro, rd, tmin, bt,
                                                  *lists)
            plain_s = time.perf_counter() - t0
            require(_bit_equal(got, ref) and int(tested) == int(ref_tested),
                    f"the curve walk kernel differs from its plain version "
                    f"on {label} rays at {n} lanes")
            walk_hit = tree.intersect(ro, rd, tmin, tmax)
            sweep_hit = sweep(ro, rd, tmin, tmax)
            require(_bit_equal(walk_hit, sweep_hit),
                    f"the culled curve route's hits differ from the sweep's "
                    f"on {label} rays at {n} lanes: " + ", ".join(
                        f"{f} {int((a != b).reshape(n, -1).any(1).sum())}"
                        for f, a, b in zip(walk_hit._fields, walk_hit,
                                           sweep_hit)))
            _, _, cnt, counts = ii.candidate_lists_kernel(ro, rd, tmin, bt,
                                                          tables.clusters)
            out[f"{label}_{n}"] = dict(
                candidates=int(cnt.sum()), max_list=int(cnt.max()),
                cull_tested=int(counts["tested"]),
                spills=int(counts["spills"]), walk_tested=int(tested),
                tested_share=int(tested) / (n * tables.elems.shape[0]),
                cull_ms=device_ms(lambda: ii.precull(ro, rd, tmin, bt,
                                                     tables.clusters), 5),
                walk_ms=device_ms(lambda: cw.curve_intersect_kernel(
                    tables, ro, rd, tmin, bt, *lists), 5),
                bound_ms=cost_bound(kf.curve_walk_cost(
                    n, tables.elems.shape[0]))["bound_ms"],
                sweep_ms=profiled_ms(lambda: sweep(ro, rd, tmin, tmax), 1),
                plain_s=plain_s,
                curve_hits=int((walk_hit.hit & (walk_hit.prim >= q)).sum()))
            log(f"curve walk {label} {n}: {json.dumps(out[f'{label}_{n}'])}")
            del lists, qh, bt, got, ref, walk_hit, sweep_hit
    del primary, bounce

    def frames(graphs: bool):
        r = Renderer(scene, params, device=dev)
        if not graphs:
            r.body_graphs = None
        st = make_trace_state(scene, params, device=dev)
        for _ in range(3):
            r.trace_samples(st)
        torch.cuda.synchronize()
        # the third frame: every width seen twice before
        rows = [row for path, row in timing.units()[-1]["table"].items()
                if path.endswith("/body")]
        return (st.image, st.albedo, st.normal, st.hits), rows, r

    got, rows, r = frames(True)
    want, _, _ = frames(False)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "the tree's frames from CUDA graphs differ from eager frames")
    bodies, graphed = sum(x["n"] for x in rows), sum(x["graphed"] for x in rows)
    require(not r.body_graphs.failed and graphed == bodies,
            f"{graphed} of the third frame's {bodies} tree bodies graphed, "
            f"failed {r.body_graphs.failed}")
    out["frames"] = dict(bodies=bodies, graphed=graphed,
                         captures=r.body_graphs.captures)
    del got, want, r, tree
    return out


# the least share of its bytes bound the shading kernel must reach at
# 1,048,576 lanes of each render cell's scene
SHADE_MIN_SHARE = 0.30


def _ptxas_counts(info: str) -> dict:
    """Registers and spill bytes from a ptxas report."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", info)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill", info)]
    return dict(registers=max(regs), spill_bytes=sum(spills))


def phase_shade_path(dev) -> dict:
    """The shading kernel (ops/shade_path.py, csrc/shade_path.cu) at the
    render cells' body shapes: one FLAKE_RES² frame, 8 bounces, of the
    Cornell box, the SPD sphereflake (benchmark/scenes/sphereflake.py,
    size factor 4) and the SPD tree (benchmark/scenes/spd_tree.py) with
    eager bodies, each body's kernel shading held to the eager shading
    (integrator.shade_plain) on the same state, bit for bit on every
    lane. On each frame's second body of 1,048,576 lanes: the kernel's
    device ms and the eager shading's, by CUDA-graph replay (device_ms),
    the kernel's bound (kernel_flops.shade_path_cost) and its share.
    ptxas's registers and spills. Fails on a differing lane, a spill, or a
    scene below SHADE_MIN_SHARE of the bound."""
    from benchmark.modes import render_curves
    from benchmark.modes.common import build_scene, load_json, to_program_scene

    info = cuda_build.ptxas_info.get("shade_path", "")
    require("registers" in info, "no ptxas report for the shading kernel")
    out = dict(ptxas=_ptxas_counts(info))
    require(out["ptxas"]["spill_bytes"] == 0, "the shading kernel spills")
    params = Params(resolution=FLAKE_RES, samples=1 << 20, batch=1,
                    bounces=MAIN_BOUNCES, sampler="path", seed=23)
    scenes = dict(
        cornell=cornell_scene(),
        flake=to_program_scene(build_scene(load_json("configs",
                                                     "sphereflake"))),
        tree=render_curves.to_program_scene(build_scene(load_json(
            "configs", "spd_tree"))))
    real = sp.shade_path
    for name, scene in scenes.items():
        r = Renderer(scene, params, device=dev)
        r.body_graphs = None
        kept, differ, lanes = [], 0, 0

        def checking(tables, s, plain):
            nonlocal differ, lanes
            got = real(tables, s, plain)
            n = s.alive.shape[0]
            for a, b in zip(got, plain(s), strict=True):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                differ += int((a != b).reshape(n, -1).any(1).sum())
            lanes += n
            if n == 1 << 20:
                kept.append((tables, s, plain))
            return got

        checking.launches = 0
        with mock.patch.object(sp, "shade_path", checking):
            r.trace_samples(make_trace_state(scene, params, device=dev))
        torch.cuda.synchronize()
        require(differ == 0, f"the shading kernel differs from the eager "
                f"shading on {differ} of {name}'s lanes")
        require(len(kept) >= 2, f"{name}: no second 1,048,576-lane body")
        tables, s, plain = kept[1]
        ms = device_ms(lambda: real(tables, s, plain))
        cost = kf.shade_path_cost(1 << 20,
                                  r.config.light_counts.total_inst_elems)
        b = cost_bound(cost)
        out[name] = dict(
            lanes=lanes, bodies=len(kept), live=int(s.alive.sum()),
            kernel_ms=ms, eager_ms=device_ms(lambda: plain(s)),
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            share=b["bound_ms"] / ms)
        log(f"shade_path {name}: {json.dumps(out[name])}")
        require(out[name]["share"] >= SHADE_MIN_SHARE,
                f"the shading kernel reads {out[name]['share']:.3f} of its "
                f"bound on {name}")
        del kept, r
    return out


def cull_per_sample(renderer, scene, dev) -> dict:
    """One sample of an instanced main path with the work-item precull
    (the cull kernel) bracketed by CUDA events: its device
    ms per sample and its calls. Events only; no host sync is added."""
    spans = []
    precull = ii.precull

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = precull(*args)
        end.record()
        spans.append((start, end))
        return out

    params = renderer.params
    state = make_trace_state(scene, params, device=dev)
    ii.precull = timed
    try:
        renderer.trace_samples(state)
    finally:
        ii.precull = precull
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in spans) / params.batch
    return dict(cull_ms_per_sample=ms, cull_calls_per_sample=len(spans) / params.batch)


def _instanced_counts(renderer) -> dict:
    cfg = renderer.config
    tb = cfg.inst_tables
    return dict(items=len(tb.wi_sup), supers=tb.tab.shape[0],
                n_prims=cfg.n_prims,
                soup=0 if cfg.hyb_world_verts is None else len(cfg.hyb_world_verts))


def no_host_sync(renderer, dev) -> None:
    """One intersect of the renderer (precull + kernel) under
    set_sync_debug_mode("error"): it must not synchronise with the host."""
    rays = _primary_rays(renderer, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        renderer.intersect(*rays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _zero_counts() -> None:
    di.dense_intersect.launches = 0
    lc.compact_planes.launches = 0
    lc.expand_planes.launches = 0
    wl.worklist_intersect_kernel.launches = 0
    rg.regroup_pack.launches = 0
    rg.regroup_tritest.launches = 0
    rg.regroup_unpack.launches = 0
    ii.instanced_intersect_kernel.launches = 0
    ii.candidate_lists_kernel.launches = 0
    ci.cluster_intersect_kernel.launches = 0
    ci.cluster_intersect_streamed_kernel.launches = 0


def _read_counts() -> dict:
    return {
        "dense_intersect": di.dense_intersect.launches,
        "lane_compact": lc.compact_planes.launches,
        "lane_expand": lc.expand_planes.launches,
        "worklist_intersect": wl.worklist_intersect_kernel.launches,
        "regroup_pack": rg.regroup_pack.launches,
        "regroup_tritest": rg.regroup_tritest.launches,
        "regroup_unpack": rg.regroup_unpack.launches,
        "instanced_intersect": ii.instanced_intersect_kernel.launches,
        "candidate_cull": ii.candidate_lists_kernel.launches,
        "cluster_intersect": ci.cluster_intersect_kernel.launches,
        "cluster_intersect_streamed": ci.cluster_intersect_streamed_kernel.launches,
    }


def body_spans(t0_ns: int) -> int:
    """The loop bodies of the frames that started at or after t0_ns
    (time.perf_counter_ns), by their `body` spans."""
    return sum(row["n"] for u in timing.units() if u["start_ns"] >= t0_ns
               for path, row in u["table"].items() if path.endswith("/body"))


def main_path(renderer, scene, dev) -> tuple[dict, dict]:
    """512 x 512, 8 bounces through Renderer: one batch of warm-up
    samples, then the rest timed; the launch counters are zeroed just
    before."""
    params = renderer.params
    state = make_trace_state(scene, params, device=dev)
    _zero_counts()
    renderer.trace_samples(state)  # warm-up
    torch.cuda.synchronize()
    syncs0 = trace_wavefront.host_syncs + rg.regroup_intersect.host_syncs
    fb0 = rg.regroup_intersect.fallbacks
    timed = params.samples - state.samples
    t0 = time.perf_counter()
    while state.samples < params.samples:
        renderer.trace_samples(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    syncs = (trace_wavefront.host_syncs + rg.regroup_intersect.host_syncs
             - syncs0)
    fallbacks = rg.regroup_intersect.fallbacks - fb0
    img = renderer.get_image(state)
    require(img.shape == (MAIN_RES, MAIN_RES, 4), f"image shape {img.shape}")
    require(np.isfinite(img).all(), "non-finite pixels in the main-path image")
    require(img[..., :3].mean() > 0.0, "black main-path image")
    stats = dict(
        seconds=seconds,
        mpaths_per_s=N_RAYS * timed / seconds / 1e6,
        ms_per_sample=1e3 * seconds / timed,
        host_syncs_per_sample=syncs / timed,
        regroup_fallbacks_per_sample=fallbacks / timed,
        image_mean=float(img[..., :3].mean()),
    )
    log(f"main path {renderer.config.n_prims} quads: {MAIN_RES}x{MAIN_RES}, "
        f"{params.bounces} bounces, sorted {renderer.options.sort_rays}, "
        f"regroup={params.regroup!r}, "
        f"{timed} timed samples after {params.batch} "
        f"warm: {stats['mpaths_per_s']:.3f} Mpaths/s, "
        f"{stats['ms_per_sample']:.2f} ms/sample, "
        f"{stats['host_syncs_per_sample']:.1f} host syncs/sample, regroup "
        f"fallbacks/sample {stats['regroup_fallbacks_per_sample']:.1f}, "
        f"image mean {stats['image_mean']:.5f}, launches {launches}")
    return stats, launches


def agreement(dev, scene, res, spp, **fields) -> dict:
    """res x res at spp samples, 8 bounces: kernels on the card vs plain
    versions on the CPU, same seed. Image mean within 1e-3 relative,
    >= 99% of pixels within 1e-3 absolute (testing.image_close, as in the
    CPU tests). `fields`: further Params fields."""
    params = Params(resolution=res, samples=spp, batch=spp,
                    bounces=MAIN_BOUNCES, sampler="path", seed=3, **fields)
    images = []
    for device in (dev, "cpu"):
        r = Renderer(scene, params, device=device)
        st = make_trace_state(scene, params, device=device)
        r.trace_samples(st)
        images.append(r.get_image(st))
    rel, frac = image_close(*images)
    return dict(mean_rel_err=rel, frac_pixels_within_1e3=frac)


def forced_agreement(dev, scene, res, spp, hybrid_budget) -> dict:
    """A small scene forced through the two-level build and traced
    (testing.render_instanced), res x res, spp samples, 8 bounces: the
    kernels on the card vs the plain versions on the CPU, same seed, under
    image_close."""
    rel, frac = image_close(*(
        render_instanced(scene, res, spp, MAIN_BOUNCES, hybrid_budget, device,
                         seed=3) for device in (dev, "cpu")))
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


def _cli_run(argv, want) -> dict:
    """cli.main(argv) on the card with the launch counters zeroed just
    before, its output captured. `want`: the kernels it must launch.
    Returns the sampling loop's seconds (the CLI's "rendered in" line),
    each batch's ms (its "sample i/n in" lines), the whole call's
    seconds, the launches, and the Renderer it built."""
    built = []

    class Recording(Renderer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    out = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "Renderer", Recording), \
            contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    require(rc == 0, f"cli.main {argv} returned {rc}")
    for name in want:
        require(launches[name] > 0, f"the CLI run {argv} never launched {name}")
    lines = out.getvalue().splitlines()
    render_s = float([ln for ln in lines if ln.startswith("rendered in")][-1]
                     .rsplit("(", 1)[1].rstrip("s)"))

    def ms(hms):  # the CLI's h:mm:ss.mmm
        h, m, s = hms.split(":")
        return 1e3 * (3600 * int(h) + 60 * int(m) + float(s))

    batch_ms = [ms(ln.split(" in ")[1].split()[0]) for ln in lines
                if ln.startswith("sample ")]
    return dict(render_s=render_s, call_s=seconds, batch_ms=batch_ms,
                launches=launches, renderer=built[0])


def _mse(img, ref) -> float:
    return float(((img[..., :3] - ref[..., :3]) ** 2).mean())


def _denoise_gain(den, noisy, ref) -> tuple[float, float]:
    """The denoiser's error reduction as tests/test_denoise.py measures
    it: the per-pixel MSE against ref of the denoised image over the
    noisy one's, in full and without each image's worst 1% of pixels."""
    e_noisy = ((noisy[..., :3] - ref[..., :3]) ** 2).reshape(-1, 3).mean(axis=1)
    e_den = ((den[..., :3] - ref[..., :3]) ** 2).reshape(-1, 3).mean(axis=1)

    def trimmed(e):
        return float(np.sort(e)[: int(len(e) * 0.99)].mean())

    return (float(e_den.mean() / e_noisy.mean()),
            trimmed(e_den) / trimmed(e_noisy))


def phase_cli(dev, cornell_mpaths: float) -> dict:
    """The CLI end to end (julia_raytracer_tpu_torch.cli.main, in process)
    on scenes written by write_yocto_scene, 512 x 512, 8 bounces, path
    sampler, under out/ (deleted after):
      1. Cornell, uniform, 16 samples in batches of 4: the PNG's bytes
         equal save_png of the Renderer's image rendered directly;
      2. Cornell, --checkpoint at 8 samples, then --resume to 16: the PNG
         byte-equal to run 1;
      3. Cornell, --adaptive --adaptive-warmup 4 --denoise --aov-prefix,
         twice: image and counts bit-equal between the runs, counts sum
         to 16 per pixel exactly with at least 4 each, the denoised image
         finite and its PNG the CLI's;
      4. quality against a 64-sample uniform reference (another seed):
         adaptive MSE < 1.35 x uniform MSE (tests/test_adaptive.py), and
         the denoiser's error reduction on a 4-sample uniform render, as
         tests/test_denoise.py measures it (< 0.9 in full, < 0.5 trimmed);
      5. the sphere grid (102,406 quads) with --addsky, 8 samples: one
         environment, every camera sample a hit or the sky, finite;
      6. --trace-profile at 32 x 32: its trace holds the card's kernels;
      7. card against CPU (testing.image_close) at 32 x 32, 2 samples:
         a denoised uniform render, and an adaptive one inside its
         warm-up (counts equal).
    Each run holds its kernels to having launched: rows 1-3 for the
    Cornell box at 512 x 512, row 1 at 32 x 32 (1,024 lanes, under the
    integrator's COMPACT_MIN of 16,384, are never compacted), row 6 for
    the grid."""
    cornell_kernels = ("dense_intersect", "lane_compact", "lane_expand")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(root, exist_ok=True)
    stats, launches = {}, {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        def path(name):
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        cornell = write_yocto_scene(cornell_scene(), path("cornell"))
        grid = write_yocto_scene(sphere_grid_scene(), path("grid"))
        stats["write_scenes_s"] = time.perf_counter() - t0
        common = ["--resolution", str(MAIN_RES), "--bounces",
                  str(MAIN_BOUNCES), "--sampler", "path", "--device", str(dev)]
        base = ["--scene", cornell, "--batch", str(CLI_BATCH)] + common
        n_pix = MAIN_RES * MAIN_RES

        def record(name, run, samples):
            launches[name] = {k: v for k, v in run["launches"].items() if v}
            stats[name] = dict(
                ms_per_sample=1e3 * run["render_s"] / samples,
                mpaths_per_s=n_pix * samples / run["render_s"] / 1e6,
                call_s=run["call_s"], batch_ms=run["batch_ms"])
            later = run["batch_ms"][1:]  # after the first batch's warm-up
            if later:
                stats[name]["mpaths_per_s_after_first_batch"] = (
                    n_pix * (samples - samples // len(run["batch_ms"]))
                    / sum(later) / 1e3)

        # 1. uniform, against the Renderer rendered directly
        run = _cli_run(base + ["--samples", str(CLI_SPP),
                               "--output", path("uniform.png")],
                       cornell_kernels)
        record("uniform", run, CLI_SPP)
        params = run["renderer"].params
        direct = Renderer(cornell_scene(), params, device=dev)
        uni = make_trace_state(cornell_scene(), params, device=dev)
        while uni.samples < params.samples:
            direct.trace_samples(uni)
        uni_img = direct.get_image(uni)
        save_png(path("direct.png"), uni_img)
        with open(path("uniform.png"), "rb") as f:
            uniform_png = f.read()
        with open(path("direct.png"), "rb") as f:
            require(f.read() == uniform_png,
                    "the CLI's PNG differs from save_png of the Renderer's image")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_png(path("encode.png"), uni_img)
        stats["png_encode_ms"] = 1e3 * (time.perf_counter() - t0)

        # 2. checkpoint, then resume
        run = _cli_run(base + ["--samples", str(CLI_CKPT_SPP), "--checkpoint",
                               path("ck.npz"), "--output", path("half.png")],
                       cornell_kernels)
        record("checkpoint", run, CLI_CKPT_SPP)
        run = _cli_run(base + ["--samples", str(CLI_SPP), "--resume",
                               path("ck.npz"), "--output", path("resumed.png")],
                       cornell_kernels)
        record("resume", run, CLI_SPP - CLI_CKPT_SPP)
        with open(path("resumed.png"), "rb") as f:
            require(f.read() == uniform_png,
                    "the resumed render's PNG differs from the uninterrupted one")
        t0 = time.perf_counter()
        uni.save(path("timed.npz"))
        stats["checkpoint_write_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = TraceState.load(path("timed.npz"), device=dev)
        torch.cuda.synchronize()
        stats["checkpoint_read_ms"] = 1e3 * (time.perf_counter() - t0)
        require(torch.equal(back.image, uni.image), "checkpoint round trip")

        # 3. adaptive + denoise + AOVs, twice
        ada = []
        for k in range(2):
            run = _cli_run(base + [
                "--samples", str(CLI_SPP), "--adaptive", "--adaptive-warmup",
                str(CLI_WARMUP), "--denoise", "--aov-prefix", path(f"aov{k}"),
                "--checkpoint", path(f"ada{k}.npz"),
                "--output", path(f"ada{k}.png")], cornell_kernels)
            record(f"adaptive_{k}", run, CLI_SPP)
            ada.append(np.load(path(f"ada{k}.npz")))
            for aov in ("albedo", "normal"):
                require(os.path.getsize(path(f"aov{k}_{aov}.png")) > 0,
                        f"no {aov} AOV")
        for key in ("image", "counts", "m2", "hits"):
            require(np.array_equal(ada[0][key], ada[1][key]),
                    f"two adaptive runs differ in {key}")
        counts = ada[0]["counts"]
        require(int(counts.sum()) == CLI_SPP * n_pix,
                f"adaptive budget {int(counts.sum())} != {CLI_SPP * n_pix}")
        require(int(counts.min()) >= CLI_WARMUP,
                f"a pixel has {int(counts.min())} < {CLI_WARMUP} samples")
        ada_state = TraceState.load(path("ada0.npz"), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        den = denoise_image(ada_state.image, ada_state.albedo,
                            ada_state.normal, ada_state.width,
                            ada_state.height)
        torch.cuda.synchronize()
        stats["denoise_ms"] = 1e3 * (time.perf_counter() - t0)
        den = den.cpu().numpy().reshape(MAIN_RES, MAIN_RES, 4)
        require(np.isfinite(den).all(), "non-finite denoised pixels")
        stats["denoise_device_ms"] = profiled_ms(lambda: denoise_image(
            ada_state.image, ada_state.albedo, ada_state.normal,
            ada_state.width, ada_state.height))
        # the adaptive step's own device work a sample: the draw (CDF,
        # inverse-CDF draw, ranks) and the per-pixel sums of the merge
        lanes = torch.zeros((n_pix, 13), device=dev)

        def draw_and_sum():
            ids, _, order = adaptive_draw(
                adaptive_cdf(ada_state.counts, ada_state.m2), n_pix,
                CLI_SPP, 0)
            return pixel_sums(ids[order], lanes[order], n_pix)

        stats["adaptive_draw_sum_device_ms"] = profiled_ms(draw_and_sum)
        # why the CDF is no torch.cumsum: on the card its bits vary from
        # call to call; inclusive_scan's must not
        scans = [inclusive_scan(ada_state.m2) for _ in range(10)]
        require(all(torch.equal(x, scans[0]) for x in scans),
                "inclusive_scan gave different bits for one input")
        sums = [torch.cumsum(ada_state.m2, 0) for _ in range(10)]
        stats["cumsum_calls_unequal_to_first"] = sum(
            not torch.equal(x, sums[0]) for x in sums)
        save_png(path("den.png"), den)
        with open(path("den.png"), "rb") as f, open(path("ada0.png"), "rb") as g:
            require(f.read() == g.read(),
                    "the adaptive run's PNG is not its denoised image")
        stats["adaptive_counts"] = dict(min=int(counts.min()),
                                        max=int(counts.max()))

        # 4. quality against a higher-sample uniform reference
        ref_params = Params(resolution=MAIN_RES, samples=CLI_REF_SPP,
                            batch=CLI_REF_SPP, bounces=MAIN_BOUNCES,
                            sampler="path", seed=CLI_REF_SEED)
        ref_state = make_trace_state(cornell_scene(), ref_params, device=dev)
        Renderer(cornell_scene(), ref_params, device=dev).trace_samples(ref_state)
        ref = ref_state.image.cpu().numpy().reshape(MAIN_RES, MAIN_RES, 4)
        ada_img = ada[0]["image"].reshape(MAIN_RES, MAIN_RES, 4)
        noisy_params = Params(resolution=MAIN_RES, samples=CLI_NOISY_SPP,
                              batch=CLI_NOISY_SPP, bounces=MAIN_BOUNCES,
                              sampler="path")
        noisy = make_trace_state(cornell_scene(), noisy_params, device=dev)
        Renderer(cornell_scene(), noisy_params, device=dev).trace_samples(noisy)
        noisy_img = noisy.image.cpu().numpy().reshape(ref.shape)
        noisy_den = denoise_image(
            noisy.image, noisy.albedo, noisy.normal, noisy.width,
            noisy.height).cpu().numpy().reshape(ref.shape)
        quality = dict(mse_uniform=_mse(uni_img, ref),
                       mse_adaptive=_mse(ada_img, ref),
                       mse_denoised_adaptive=_mse(den, ref),
                       mse_uniform_4spp=_mse(noisy_img, ref),
                       mse_denoised_uniform_4spp=_mse(noisy_den, ref))
        gain, gain_trimmed = _denoise_gain(noisy_den, noisy_img, ref)
        quality.update(denoise_gain=gain, denoise_gain_trimmed=gain_trimmed)
        stats["quality"] = quality
        require(quality["mse_adaptive"] < 1.35 * quality["mse_uniform"],
                f"adaptive MSE {quality['mse_adaptive']} >= 1.35 x uniform "
                f"{quality['mse_uniform']}")
        require(gain < 0.9 and gain_trimmed < 0.5,
                f"the denoiser's error ratio {gain} (trimmed {gain_trimmed})")

        # 5. the sphere grid under the procedural sky
        run = _cli_run(["--scene", grid, "--samples", str(CLI_GRID_SPP),
                        "--batch", str(CLI_GRID_SPP), "--addsky",
                        "--checkpoint", path("grid.npz"), "--output",
                        path("grid.png")] + common, ("worklist_intersect",))
        record("grid_addsky", run, CLI_GRID_SPP)
        require(run["renderer"].config.n_envs == 1,
                f"{run['renderer'].config.n_envs} environments with --addsky")
        g = np.load(path("grid.npz"))
        require(np.isfinite(g["image"]).all(), "non-finite sky-lit pixels")
        require(int(g["hits"].min()) == CLI_GRID_SPP,
                "a camera sample missed both the scene and the sky")

        # 6. --trace-profile: its trace of the second batch holds the
        # card's kernels
        run = _cli_run(["--scene", cornell, "--samples", "2", "--batch", "1",
                        "--resolution", str(CLI_CHECK_RES), "--trace-profile",
                        path("prof"), "--output", path("prof.png"),
                        "--device", str(dev)], ("dense_intersect",))
        with open(path("prof/trace.json")) as f:
            events = json.load(f)["traceEvents"]
        stats["trace_kernel_events"] = sum(e.get("cat") == "kernel"
                                           for e in events)
        require(stats["trace_kernel_events"] > 0,
                "the --trace-profile trace holds no kernel of the card")

        # 7. card against CPU
        for label, fields in (("denoised uniform", {}),
                              ("adaptive warm-up",
                               dict(adaptive=True, adaptive_warmup=CLI_WARMUP))):
            p = Params(resolution=CLI_CHECK_RES, samples=CLI_CHECK_SPP,
                       batch=CLI_CHECK_SPP, bounces=MAIN_BOUNCES,
                       sampler="path", seed=CLI_REF_SEED, **fields)
            images, counts = [], []
            for device in (dev, "cpu"):
                st = make_trace_state(cornell_scene(), p, device=device)
                Renderer(cornell_scene(), p, device=device).trace_samples(st)
                if not fields:
                    st.denoised = denoise_image(st.image, st.albedo, st.normal,
                                                st.width, st.height)
                    images.append(st.denoised.cpu().numpy())
                else:
                    images.append(st.image.cpu().numpy())
                    counts.append(st.counts.cpu().numpy())
            rel, frac = image_close(*images)
            if counts:
                require(np.array_equal(*counts), "warm-up counts differ")
            stats[f"card_vs_cpu_{label.replace(' ', '_')}"] = dict(
                mean_rel_err=rel, frac_pixels_within_1e3=frac)
    stats["main_path_cornell_mpaths_per_s"] = cornell_mpaths
    return dict(stats=stats, launches=launches)


# Run in a child process by kernels_in_turns (argv: a tree, the inputs
# file): rows 1, 4, 5, 8, 9 and 10 through that tree's own wrappers, each
# result held to this tree's plain version bit for bit, then their device
# times (device_ms; rows 4 and 5 over CLUSTER_REPS launches).
def _profile_once(fn) -> tuple[float, list, dict]:
    """Device time of one call of fn (torch.profiler's device activities,
    summed), its five largest device activities ([name, ms, count]) and
    every activity ({name: [ms, count]})."""
    by_name = _device_activities(fn, 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return (sum(ms for ms, _ in by_name.values()),
            [[name[:80], ms, count] for name, (ms, count) in ranked], by_name)


def _activity(by_name: dict, key: str) -> dict:
    """Device ms, count and ms a launch of the activities whose name holds
    `key` (a kernel's __global__ name)."""
    ms = sum(v[0] for name, v in by_name.items() if key in name)
    count = sum(v[1] for name, v in by_name.items() if key in name)
    return dict(ms=ms, launches=count, ms_per_launch=ms / max(count, 1))


def _per_launch(prof: dict, kernels) -> dict:
    """_activity of each (label, kernel name) of `kernels` in the forward
    and the backward of a _profile_step result, whose activity tables it
    takes out."""
    acts = {"forward": prof.pop("forward_all"),
            "backward": prof.pop("backward_all")}
    return {f"{label}_{part}": _activity(acts[part], kernel)
            for part in acts for label, kernel in kernels}


def _launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _read_counts().items()}


@contextlib.contextmanager
def one_rank_group():
    """A one-process NCCL group over a file:// store in a temporary
    directory (one process on one host: the loopback interface is all
    NCCL needs); destroyed on exit."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tempfile.mkdtemp(prefix="chip_smoke_store")
    init_distributed("nccl", f"file://{store}/store", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _perturbed(mats, dev):
    """The material colours moved by a seeded offset (lights kept)."""
    g = np.random.default_rng(DIFF_SEED)
    lit = (mats.emission.sum(dim=1) > 0)[:, None]
    offset = torch.as_tensor(g.uniform(
        -DIFF_COLOR_OFFSET, DIFF_COLOR_OFFSET, tuple(mats.color.shape)),
        dtype=torch.float32, device=dev)
    return torch.where(lit, mats.color, (mats.color + offset).clamp(0.01, 0.99))


def _train_steps(step, color, emission, pix, target, n_steps, kernels, dev,
                 label):
    """n_steps of `step` from (color, emission): per step the loss, wall
    ms, event ms (CUDA events around the step: the stream's span, its
    idle gaps included; _profile_step gives the device's busy time), peak
    memory (all allocations, and the step's own above what was allocated
    before it) and the launches of `kernels`. Returns (steps, color,
    emission)."""
    steps = []
    for _ in range(n_steps):
        before = _read_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        loss, color, emission = step(color, emission, pix, target, 1,
                                     DIFF_SEED)
        end.record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        launched = _launch_delta(before)
        steps.append(dict(
            loss=float(loss), wall_ms=wall, event_ms=start.elapsed_time(end),
            peak_mb=torch.cuda.max_memory_allocated(dev) / 2**20,
            step_peak_mb=(torch.cuda.max_memory_allocated(dev) - base) / 2**20,
            launches={k: launched[k] for k in kernels}))
        log(f"{label} step {len(steps)}: {steps[-1]}")
    return steps, color, emission


def _profile_step(r, color, emission, pix, target) -> dict:
    """One step's forward (make_param_loss) and backward device time and
    activities by torch.profiler, apart."""
    loss_fn = make_param_loss(r.dscene, r.config, r.options, r.cam_arrays,
                              MAIN_RES, MAIN_RES)
    c = color.detach().clone().requires_grad_()
    e = emission.detach().clone().requires_grad_()
    fwd_ms, fwd_top, fwd_all = _profile_once(
        lambda: loss_fn(c, e, pix, target, 1, DIFF_SEED))
    # the graph is kept, so a session taken again runs the same backward
    value = loss_fn(c, e, pix, target, 1, DIFF_SEED)
    bwd_ms, bwd_top, bwd_all = _profile_once(
        lambda: value.backward(retain_graph=True))
    return dict(forward_device_ms=fwd_ms, backward_device_ms=bwd_ms,
                backward_forward_ratio=bwd_ms / fwd_ms, forward_top=fwd_top,
                backward_top=bwd_top, forward_all=fwd_all,
                backward_all=bwd_all)


def gather_backward(dev, cornell) -> dict:
    """The material gathers' backward (ops/row_gather.py) at the main
    path's shapes: the Cornell box's 262,144 camera hits' material ids
    onto its material rows, colour and emission lane gradients (6
    columns). The one-hot product twice, bit for bit; its device ms
    against ATen's backward of table[idx] (the sort-based index put the
    port used before) and index_add_ (atomics, in no fixed order), and
    their results within float32 rounding of a float64 sum."""
    r = cornell
    hit = r.intersect(*_primary_rays(r, dev))
    mid = r.dscene.inst_material[hit.instance.clamp(min=0).long()]
    rows = r.dscene.materials.color.shape[0]
    g = torch.Generator(device=dev).manual_seed(DIFF_SEED)
    grad = torch.randn((N_RAYS, 6), generator=g, device=dev)
    got = [rgat.rows_sum_onehot(mid, grad, rows) for _ in range(2)]
    require(torch.equal(got[0], got[1]),
            "the one-hot material backward differs between two calls")
    want = torch.zeros((rows, 6), dtype=torch.float64, device=dev).index_add_(
        0, mid, grad.double())
    table = torch.zeros((rows, 6), device=dev, requires_grad=True)

    def aten():
        table.grad = None
        table[mid].backward(grad)
        return table.grad

    err = float(((got[0].double() - want).abs()
                 / want.abs().clamp(min=1.0)).max())
    require(err < 1e-5, f"the one-hot material backward is {err:.3g} off")
    out = dict(lanes=N_RAYS, rows=rows, columns=6, rel_err=err,
               onehot_ms=device_ms(lambda: rgat.rows_sum_onehot(mid, grad,
                                                               rows)),
               aten_index_backward_ms=profiled_ms(aten, reps=2),
               index_add_ms=device_ms(lambda: torch.zeros(
                   (rows, 6), device=dev).index_add_(0, mid, grad)))
    log(f"diff: material-gather backward at {N_RAYS} lanes onto {rows} rows: "
        f"{out}")
    require(out["onehot_ms"] < 1.0,
            f"the material-gather backward takes {out['onehot_ms']:.3f} ms")
    return out


def phase_diff(dev, cornell) -> tuple[dict, dict]:
    """The differentiable path on the card: (a) the fixed-trip render at
    512 x 512, 8 bounces, against the while loop's (its lane compaction
    on), bit for bit; (b) the pixel loss's colour and emission gradients
    on the card against the CPU's at DIFF_CHECK_RES; (c) DIFF_STEPS
    shard_train_step steps at 512 x 512 (on the one-process NCCL group
    the caller holds) from colours perturbed by a seeded offset, against
    the render at the true colours with the same seed (so the loss is 0
    at the truth): loss, wall and event ms, peak memory and dense
    launches a step (one sample a step), then one step's forward and
    backward device time and largest device activities by
    torch.profiler, the material gathers' backward (gather_backward)
    absent from the backward's largest; (d) one gradient on the sphere
    grid at DIFF_SPHERE_RES through the worklist kernel against the
    CPU's. Returns (stats, the launches of (c) and (d), zeroed before)."""
    r = cornell
    opts = diff_options(r.options, r.config)
    fixed = opts.fixed_iterations
    pix = torch.arange(N_RAYS, dtype=torch.int32, device=dev)
    args = (r.cam_arrays, MAIN_RES, MAIN_RES, pix, 0, DIFF_SEED)
    out = {"fixed_iterations": fixed}

    # (a) forward parity
    _zero_counts()
    with torch.no_grad():
        rad_w = render_radiance(r.dscene, r.config, r.options, *args,
                                intersector=r.intersect)
        loop = _read_counts()
        rad_f = render_radiance(r.dscene, r.config, opts, *args,
                                intersector=r.intersect)
    differ = (rad_w != rad_f).any(dim=-1)
    rel = ((rad_w - rad_f).abs()
           / torch.clamp(rad_w.abs(), min=1e-30)).max()
    out["forward"] = dict(
        lanes_differ_share=float(differ.float().mean()),
        max_rel_diff=float(rel), mean=float(rad_f.mean()),
        while_loop_compact_launches=loop["lane_compact"])
    log(f"diff (a): fixed-trip ({fixed} bodies) vs while-loop render at "
        f"{MAIN_RES}x{MAIN_RES}, {MAIN_BOUNCES} bounces: {out['forward']}")
    require(loop["lane_compact"] > 0, "the while loop did not compact")
    require(torch.equal(rad_w, rad_f),
            "the fixed-trip render differs from the while loop's")
    del rad_w, rad_f

    # (b) card against CPU gradients
    t0 = time.perf_counter()
    card = param_grads(cornell_scene(), DIFF_CHECK_RES, dev, seed=DIFF_SEED)
    cpu = param_grads(cornell_scene(), DIFF_CHECK_RES, "cpu", seed=DIFF_SEED)
    out["grads_vs_cpu"] = dict(
        res=DIFF_CHECK_RES, tol=GRAD_TOL,
        loss_rel=abs(card[0] - cpu[0]) / cpu[0],
        color=grads_close(card[1], cpu[1]),
        emission=grads_close(card[2], cpu[2]),
        seconds=time.perf_counter() - t0)
    log(f"diff (b): gradients card vs cpu: {out['grads_vs_cpu']}")

    # (c) train steps on the one-process NCCL group
    out["gather_backward"] = gather_backward(dev, r)
    step = shard_train_step(make_mesh(dev), r.dscene, r.config, r.options,
                            r.cam_arrays, MAIN_RES, MAIN_RES)
    mats = r.dscene.materials
    with torch.no_grad():
        target = render_radiance(r.dscene, r.config, opts, *args,
                                 intersector=step.intersect)
    color = _perturbed(mats, dev)
    err0 = float((color - mats.color).abs().mean())
    _zero_counts()
    steps, color, emission = _train_steps(
        step, color, mats.emission, pix, target, DIFF_STEPS,
        ("dense_intersect",), dev, "diff (c)")
    prof = _profile_step(r, color, emission, pix, target)
    bwd_all = prof.pop("backward_all")
    prof.pop("forward_all")
    out["train"] = dict(
        steps=steps, **prof, color_err_start=err0,
        color_err_end=float((color - mats.color).abs().mean()),
        index_backward_ms=_activity(bwd_all, "indexing_backward")["ms"])
    log(f"diff (c): forward {prof['forward_device_ms']:.2f} ms, backward "
        f"{prof['backward_device_ms']:.2f} ms device (ratio "
        f"{prof['backward_forward_ratio']:.2f}; with ATen's index-put "
        f"backward it took 651-662 ms on an H100 80GB HBM3); mean |colour "
        f"- truth| {err0:.5f} -> "
        f"{out['train']['color_err_end']:.5f}; backward's largest device "
        f"activities {prof['backward_top']}")
    require(all(math.isfinite(st["loss"]) for st in steps), "non-finite loss")
    require(steps[-1]["loss"] < steps[0]["loss"],
            "the train steps did not lower the loss")
    require(all(st["launches"]["dense_intersect"] == 1 + 2 * fixed
                for st in steps),
            f"a train step did not launch the dense kernel {1 + 2 * fixed} "
            "times (camera rays, each body, each body's recompute)")
    require(not any("indexing_backward_kernel" in name
                    for name, _, _ in prof["backward_top"]),
            "ATen's index backward is among the backward's largest device "
            "activities")

    # (d) the worklist route
    t0 = time.perf_counter()
    before = _read_counts()
    card = param_grads(sphere_grid_scene(), DIFF_SPHERE_RES, dev,
                       pixel_step=DIFF_SPHERE_STEP, seed=DIFF_SEED)
    wl_launches = _launch_delta(before)["worklist_intersect"]
    cpu = param_grads(sphere_grid_scene(), DIFF_SPHERE_RES, "cpu",
                      pixel_step=DIFF_SPHERE_STEP, seed=DIFF_SEED)
    out["worklist"] = dict(
        res=DIFF_SPHERE_RES, pixel_step=DIFF_SPHERE_STEP, tol=GRAD_TOL,
        launches=wl_launches, loss_rel=abs(card[0] - cpu[0]) / cpu[0],
        color=grads_close(card[1], cpu[1]),
        emission=grads_close(card[2], cpu[2]),
        seconds=time.perf_counter() - t0)
    log(f"diff (d): sphere grid gradients card vs cpu: {out['worklist']}")
    require(wl_launches == 1 + 2 * fixed,
            f"the sphere-grid gradient launched the worklist kernel "
            f"{wl_launches} times, not {1 + 2 * fixed}")
    return out, _read_counts()


def _grads_vs_cpu(dev, scene, budget) -> tuple[dict, dict]:
    """Colour and emission gradients of the pixel loss and the shape-space
    prim_verts gradient of the mean squared radiance of `scene` forced
    through the two-level build at `budget`, DIFF_CHECK_RES, 8 bounces,
    on the card against the CPU within GRAD_TOL; and the card side's
    launches."""
    t0 = time.perf_counter()
    _zero_counts()
    card = param_grads(scene, DIFF_CHECK_RES, dev, seed=DIFF_SEED,
                       hybrid_budget=budget)
    card_v = vertex_grads(scene, DIFF_CHECK_RES, dev, budget, seed=DIFF_SEED)
    launched = _read_counts()
    cpu = param_grads(scene, DIFF_CHECK_RES, "cpu", seed=DIFF_SEED,
                      hybrid_budget=budget)
    cpu_v = vertex_grads(scene, DIFF_CHECK_RES, "cpu", budget, seed=DIFF_SEED)
    live = int((cpu_v[1].abs().reshape(len(cpu_v[1]), -1).amax(1) > 0).sum())
    return dict(
        res=DIFF_CHECK_RES, tol=GRAD_TOL,
        loss_rel=abs(card[0] - cpu[0]) / cpu[0],
        color=grads_close(card[1], cpu[1]),
        emission=grads_close(card[2], cpu[2]),
        radiance_rel=abs(card_v[0] - cpu_v[0]) / cpu_v[0],
        prim_verts=grads_close(card_v[1], cpu_v[1]), live_vertex_rows=live,
        seconds=time.perf_counter() - t0), launched


def phase_diff_instanced(dev, inst) -> tuple[dict, dict]:
    """The differentiable path on instanced and hybrid scenes (the
    instanced re-test of ops/diff_hit.py over the cull and row 7, the
    hybrid's soup over row 6): (a) at 512 x 512, 8 bounces, on
    instanced_scene() and hybrid_scene() (the main paths' Renderers,
    `inst`), the fixed-trip render against the while loop's with the same
    options unsorted, bit for bit (and, for information, the lanes that
    differ when the while loop keeps the Renderer's sort); (b) colour,
    emission and prim_verts gradients on the card against the CPU's
    (_grads_vs_cpu) on the reduced scenes forced_agreement renders, with
    row 7 and the cull (and row 6 for the hybrid) launched; (c) DIFF_STEPS
    shard_train_step steps on instanced_scene() at 512 x 512 from
    perturbed colours (on the one-process NCCL group the caller holds):
    the loss falls and each step launches row 7 and the cull 1 + 2 x
    fixed times; one step's forward and backward by the profiler, row 7's
    and the cull's ms a launch on these unsorted rays; then one step on
    hybrid_scene(), whose row-6 (or regroup tri-test) and row-7 launches
    are 1 + 2 x fixed each; (d) the instanced intersector twice on
    unsorted full-width bounce rays of instanced_scene(), bit-equal Hits
    (torch.utils.checkpoint does not check that the recompute equals the
    forward). Returns (stats, the launches of (a)-(d), zeroed before)."""
    out, total = {}, dict.fromkeys(_read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    pix = torch.arange(N_RAYS, dtype=torch.int32, device=dev)

    # (a) forward parity at full size
    for name in ("instanced", "hybrid"):
        r = inst[name]
        opts = diff_options(r.options, r.config)
        args = (r.cam_arrays, MAIN_RES, MAIN_RES, pix, 0, DIFF_SEED)
        _zero_counts()
        with torch.no_grad():
            rad_w = render_radiance(r.dscene, r.config,
                                    r.options._replace(sort_rays=False), *args,
                                    intersector=r.intersect)
            rad_f = render_radiance(r.dscene, r.config, opts, *args,
                                    intersector=r.intersect)
            rad_s = render_radiance(r.dscene, r.config, r.options, *args,
                                    intersector=r.intersect)
        add(_read_counts())
        out[f"{name}_forward"] = dict(
            fixed_iterations=opts.fixed_iterations,
            lanes_differ_share=float((rad_w != rad_f).any(dim=-1).float().mean()),
            sorted_lanes_differ=int((rad_s != rad_f).any(dim=-1).sum()),
            sorted_max_abs_diff=float((rad_s - rad_f).abs().max()),
            mean=float(rad_f.mean()))
        log(f"diff_instanced (a) {name}: fixed-trip vs unsorted while-loop "
            f"render at {MAIN_RES}x{MAIN_RES}, {MAIN_BOUNCES} bounces: "
            f"{out[f'{name}_forward']}")
        require(torch.equal(rad_w, rad_f),
                f"the {name} fixed-trip render differs from the while loop's")
        del rad_w, rad_f, rad_s

    # (b) card against CPU gradients on the reduced scenes
    for key, scene, budget in (
            ("instanced_grads", instanced_scene(4, (16, 12)), 0),
            ("hybrid_grads", hybrid_scene(8, 8, 4, 32), 5000)):
        out[key], launched = _grads_vs_cpu(dev, scene, budget)
        add(launched)
        log(f"diff_instanced (b) {key}: card vs cpu: {out[key]}")
        for kernel in ("instanced_intersect", "candidate_cull") + (
                ("worklist_intersect",) if budget else ()):
            require(launched[kernel] > 0,
                    f"the {key} gradients never launched {kernel}")

    # (c) train steps
    r = inst["instanced"]
    fixed = diff_options(r.options, r.config).fixed_iterations
    items = ("instanced_intersect", "candidate_cull")
    step = shard_train_step(make_mesh(dev), r.dscene, r.config, r.options,
                            r.cam_arrays, MAIN_RES, MAIN_RES)
    mats = r.dscene.materials
    with torch.no_grad():
        target = render_radiance(r.dscene, r.config, diff_options(
            r.options, r.config), r.cam_arrays, MAIN_RES, MAIN_RES, pix, 0,
            DIFF_SEED, intersector=step.intersect)
    color = _perturbed(mats, dev)
    err0 = float((color - mats.color).abs().mean())
    _zero_counts()
    steps, color, emission = _train_steps(
        step, color, mats.emission, pix, target, DIFF_STEPS, items, dev,
        "diff_instanced (c) instanced")
    add(_read_counts())
    prof = _profile_step(r, color, emission, pix, target)
    per_launch = _per_launch(prof, (("row7", "instanced_intersect_kernel"),
                                    ("cull", "candidate_cull_kernel")))
    out["instanced_train"] = dict(
        steps=steps, **prof, kernels=per_launch, color_err_start=err0,
        color_err_end=float((color - mats.color).abs().mean()))
    log(f"diff_instanced (c) instanced: forward "
        f"{prof['forward_device_ms']:.2f} ms, backward "
        f"{prof['backward_device_ms']:.2f} ms device; row 7 and the cull a "
        f"launch: {per_launch}; forward's largest {prof['forward_top']}; "
        f"backward's largest {prof['backward_top']}; mean |colour - truth| "
        f"{err0:.5f} -> {out['instanced_train']['color_err_end']:.5f}")
    require(all(math.isfinite(st["loss"]) for st in steps), "non-finite loss")
    require(steps[-1]["loss"] < steps[0]["loss"],
            "the instanced train steps did not lower the loss")
    require(all(st["launches"][k] == 1 + 2 * fixed
                for st in steps for k in items),
            f"an instanced train step did not launch row 7 and the cull "
            f"{1 + 2 * fixed} times each")
    del step, target

    r = inst["hybrid"]
    hfixed = diff_options(r.options, r.config).fixed_iterations
    soup, soup_kernel = (("worklist_intersect", "worklist_intersect_kernel")
                         if r.intersect.livegate is None
                         else ("regroup_tritest", "tritest_kernel"))
    step = shard_train_step(make_mesh(dev), r.dscene, r.config, r.options,
                            r.cam_arrays, MAIN_RES, MAIN_RES)
    with torch.no_grad():
        target = render_radiance(r.dscene, r.config, diff_options(
            r.options, r.config), r.cam_arrays, MAIN_RES, MAIN_RES, pix, 0,
            DIFF_SEED, intersector=step.intersect)
    _zero_counts()
    color = _perturbed(r.dscene.materials, dev)
    hsteps, _, _ = _train_steps(
        step, color, r.dscene.materials.emission, pix, target, 1,
        items + (soup,), dev, "diff_instanced (c) hybrid")
    add(_read_counts())
    prof = _profile_step(r, color, r.dscene.materials.emission, pix, target)
    per_launch = _per_launch(prof, (("row7", "instanced_intersect_kernel"),
                                    ("cull", "candidate_cull_kernel"),
                                    ("soup", soup_kernel)))
    out["hybrid_train"] = dict(steps=hsteps, soup_kernel=soup, **prof,
                               kernels=per_launch)
    log(f"diff_instanced (c) hybrid: forward "
        f"{prof['forward_device_ms']:.2f} ms, backward "
        f"{prof['backward_device_ms']:.2f} ms device; row 7, the cull and "
        f"the soup's kernel a launch: {per_launch}; backward's largest "
        f"{prof['backward_top']}")
    require(math.isfinite(hsteps[0]["loss"]), "non-finite hybrid loss")
    require(all(hsteps[0]["launches"][k] == 1 + 2 * hfixed
                for k in ("instanced_intersect", soup)),
            f"the hybrid train step did not launch row 7 and {soup} "
            f"{1 + 2 * hfixed} times each")
    del step, target

    # (d) recompute determinism: the same unsorted bounce rays twice
    r = inst["instanced"]
    _zero_counts()
    primary = _primary_rays(r, dev)
    bounce = _bounce_rays(r.intersect(*primary), primary[1], dev)
    first = r.intersect(*bounce)
    second = r.intersect(*bounce)
    add(_read_counts())
    out["recompute_bit_equal"] = _bit_equal(first, second)
    out["recompute_hits"] = int(first.hit.sum())
    log(f"diff_instanced (d): two calls on {N_RAYS} unsorted bounce rays "
        f"({out['recompute_hits']} hits): bit-equal "
        f"{out['recompute_bit_equal']}")
    require(out["recompute_bit_equal"],
            "the instanced intersector's hits differ between two calls")
    return out, total


def _sample_device_ms(renderer, scene, dev) -> float:
    """Device ms of one sample of `renderer` (batch 1): torch.profiler's
    device activities over one sample on a fresh state, after one more."""
    def one():
        renderer.trace_samples(make_trace_state(scene, renderer.params,
                                                device=dev))
    return profiled_ms(one, reps=1)


def phase_scene_content(dev) -> tuple[dict, dict]:
    """The scene content of testing.py that no earlier phase renders, at
    512 x 512, 8 bounces, path sampler, each render with the launch
    counters zeroed just before:
      (a) hairball_scene(1024, 4, 256): 4,096 lines and 256 points over
          the Cornell box's 18 quads. The dense kernel under curve_wrap,
          the lane compactor; Mpaths/s, device ms a sample, the
          line/point sweep's (merge_curves) device ms a sample, on the
          inputs and quad hits of each intersect call of one sample, and
          its extra peak memory at the widest call;
      (b) many_lights_scene(): 5,120 emissive quads (> EXACT_ELEMS), so
          the light pdf marches auto_light_pdf_steps steps through the
          worklist kernel; its launches must be one a sample for the
          camera rays plus (1 + steps) a loop body (the `body` spans);
          Mpaths/s and device ms a sample;
      (c) subdiv_cube_scene() written by write_yocto_scene: the cube's PLY
          is empty, so the loader tessellates its cage to 6 x 4^4 = 1,536
          quads (the worklist kernel); cli.main at SUBDIV_SPP samples, its
          PNG byte-equal to save_png of the Renderer's image on the scene
          load_scene(tessellate=False) gives.
    (a) and (b) are held card against CPU at 64 x 64 (image_close).
    Returns (stats, the launches of the three renders)."""
    out, launches = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def params(**k):
        return Params(resolution=MAIN_RES, bounces=MAIN_BOUNCES, sampler="path",
                      samples=CONTENT_WARM_SPP + CONTENT_TIMED_SPP,
                      batch=CONTENT_WARM_SPP, **k)

    # (a) lines and points
    t0 = time.perf_counter()
    scene = hairball_scene(HAIR_HAIRS, HAIR_SEGMENTS, HAIR_POINTS)
    r = Renderer(scene, params(), device=dev)
    cfg = r.config
    require((cfg.n_prims, cfg.n_lines, cfg.n_points)
            == (CORNELL_QUADS, HAIR_HAIRS * HAIR_SEGMENTS, HAIR_POINTS),
            f"hairball counts {cfg.n_prims}, {cfg.n_lines}, {cfg.n_points}")
    require(isinstance(r.intersect.tables, di.DenseTable),
            "the hairball's quads do not take the dense kernel under curve_wrap")
    stats, ln = main_path(r, scene, dev)
    for name in ("dense_intersect", "lane_compact", "lane_expand"):
        require(ln[name] > 0, f"the hairball path never launched {name}")
    add(ln)
    stats["device_ms_per_sample"] = _sample_device_ms(r, scene, dev)
    calls, wrapped = [], r.intersect

    def recording(ro, rd, tmin, tmax):
        h = di.dense_intersect(wrapped.tables, ro, rd, tmin, tmax)
        calls.append((h, ro, rd, tmin, tmax))
        return merge_curves(r.dscene, cfg, h, ro, rd, tmin, tmax,
                            wrapped.curves)

    r.intersect = Intersector(recording)
    try:
        r.trace_samples(make_trace_state(scene, r.params, device=dev))
    finally:
        r.intersect = wrapped
    torch.cuda.synchronize()
    widest = max(calls, key=lambda c: c[1].shape[0])
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    merge_curves(r.dscene, cfg, *widest)
    torch.cuda.synchronize()
    stats["sweep_peak_extra_mb"] = (
        (torch.cuda.max_memory_allocated(dev) - base) / 2**20)
    stats["sweep_calls_per_sample"] = len(calls)
    stats["sweep_lanes_per_sample"] = sum(c[1].shape[0] for c in calls)
    stats["sweep_device_ms_per_sample"] = sum(
        profiled_ms(lambda c=c: merge_curves(r.dscene, cfg, *c), reps=1)
        for c in calls)
    stats["sweep_share"] = (stats["sweep_device_ms_per_sample"]
                            / stats["device_ms_per_sample"])
    stats["walk_device_ms_per_sample"] = sum(
        profiled_ms(lambda c=c: merge_curves(r.dscene, cfg, *c,
                                             wrapped.curves), reps=1)
        for c in calls)
    del calls, widest, r
    stats["agreement"] = agreement(
        dev, hairball_scene(HAIR_HAIRS, HAIR_SEGMENTS, HAIR_POINTS),
        CONTENT_CHECK_RES, HAIR_CHECK_SPP)
    stats["seconds"] = time.perf_counter() - t0
    out["hairball"] = stats
    log(f"scene_content (a) hairball: {json.dumps(stats)}")

    # (b) the truncated-march light pdf
    t0 = time.perf_counter()
    scene = many_lights_scene()
    r = Renderer(scene, params(), device=dev)
    counts = r.config.light_counts
    steps = r.options.light_pdf_extra_steps
    require(counts.total_inst_elems > EXACT_ELEMS,
            f"{counts.total_inst_elems} emissive elements: the pdf does not march")
    require(steps == auto_light_pdf_steps(counts.total, False),
            f"the renderer chose {steps} march steps")
    require(not r.options.sort_rays and r.intersect.livegate is None
            and isinstance(r.intersect.tables, wl.WorklistTables),
            "the many-lights scene does not take the unsorted worklist path")
    t0_ns = time.perf_counter_ns()
    stats, ln = main_path(r, scene, dev)
    bodies = body_spans(t0_ns)
    spp = CONTENT_WARM_SPP + CONTENT_TIMED_SPP
    predicted = spp + bodies * (1 + steps)
    for name in ("lane_compact", "lane_expand"):
        require(ln[name] > 0, f"the many-lights path never launched {name}")
    require(ln["worklist_intersect"] == predicted,
            f"the many-lights path launched the worklist kernel "
            f"{ln['worklist_intersect']} times, not {predicted} (camera "
            f"{spp}, {bodies} bodies x (1 + {steps} march steps))")
    add(ln)
    stats.update(
        emissive_elements=counts.total_inst_elems, lights=counts.total,
        march_steps=steps, bodies_per_sample=bodies / spp,
        worklist_launches_per_sample=ln["worklist_intersect"] / spp,
        predicted_launches_per_sample=predicted / spp,
        device_ms_per_sample=_sample_device_ms(r, scene, dev))
    del r
    stats["agreement"] = agreement(dev, many_lights_scene(), CONTENT_CHECK_RES,
                                   LIGHTS_CHECK_SPP)
    stats["seconds"] = time.perf_counter() - t0
    out["many_lights"] = stats
    log(f"scene_content (b) many lights: {json.dumps(stats)}")

    # (c) a subdivision cage through the CLI
    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cage = write_cube_cage(os.path.join(tmp, "cube.obj"),
                               center=(0.3, 1.4, 0.3), half=0.18)
        path = write_yocto_scene(subdiv_cube_scene(cage, SUBDIV_LEVELS),
                                 os.path.join(tmp, "subdiv"))
        png = os.path.join(tmp, "cli.png")
        run = _cli_run(["--scene", path, "--resolution", str(MAIN_RES),
                        "--bounces", str(MAIN_BOUNCES), "--sampler", "path",
                        "--samples", str(SUBDIV_SPP), "--batch",
                        str(SUBDIV_SPP), "--device", str(dev),
                        "--output", png], ("worklist_intersect",))
        quads = CORNELL_QUADS + 6 * 4 ** SUBDIV_LEVELS
        require(run["renderer"].config.n_prims == quads,
                f"the tessellated scene has {run['renderer'].config.n_prims} "
                f"quads, not {quads}")
        add(run["launches"])
        loaded = load_scene(path, tessellate=False)
        direct = Renderer(loaded, run["renderer"].params, device=dev)
        st = make_trace_state(loaded, direct.params, device=dev)
        while st.samples < direct.params.samples:
            direct.trace_samples(st)
        save_png(os.path.join(tmp, "direct.png"), direct.get_image(st))
        with open(png, "rb") as f, \
                open(os.path.join(tmp, "direct.png"), "rb") as g:
            require(f.read() == g.read(), "the CLI's PNG of the subdivided "
                    "scene differs from the Renderer's")
    out["subdiv_cli"] = dict(
        quads=quads, samples=SUBDIV_SPP, render_s=run["render_s"],
        call_s=run["call_s"],
        worklist_launches=run["launches"]["worklist_intersect"],
        mpaths_per_s=N_RAYS * SUBDIV_SPP / run["render_s"] / 1e6,
        seconds=time.perf_counter() - t0)
    log(f"scene_content (c) subdivided cube through the CLI: "
        f"{json.dumps(out['subdiv_cli'])}")
    return out, launches


def _timed(stack, module, name, acc, key):
    """Patch module.name with a wrapper that adds its seconds to acc[key]
    (and returns what the function returns) for the ExitStack's span."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

    stack.enter_context(mock.patch.object(module, name, wrapper))


def _raising(stack, module, name):
    def refuse(*_args, **_kwargs):
        raise AssertionError(f"{name} ran on the warm build")

    stack.enter_context(mock.patch.object(module, name, refuse))


def _build_renderer(path, params, dev, warm: bool):
    """load_scene(path) and Renderer(scene, params) on the card, with the
    set-up's seconds by step (load, bvh, lights, tables, kernel_select, the
    cache's reads and writes, setup: load + Renderer) and the cache tags
    read and written. Warm: every builder of a cached product raises."""
    secs, tags = {}, dict(read=[], written=[], native=[])
    load_arrays, save_arrays = diskcache.load_arrays, diskcache.save_arrays
    build_native = native.build_cluster_tables_native

    def reading(key, tag):
        got = load_arrays(key, tag)
        if got is not None:
            tags["read"].append(tag)
        return got

    def writing(key, tag, arrays):
        tags["written"].append(tag)
        return save_arrays(key, tag, arrays)

    def native_tables(*args):
        tags["native"].append(build_native(*args))
        return tags["native"][-1]

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(diskcache, "load_arrays", reading))
        stack.enter_context(mock.patch.object(diskcache, "save_arrays", writing))
        stack.enter_context(mock.patch.object(
            native, "build_cluster_tables_native", native_tables))
        for module, name, key in ((scene_device, "build_bvh", "bvh"),
                                  (scene_device, "build_lights_np", "lights"),
                                  (cluster_tables, "build_cluster_tables",
                                   "tables"),
                                  (ks, "predict_ratio", "kernel_select")):
            if warm:
                _raising(stack, module, name)
            else:
                _timed(stack, module, name, secs, key)
        _timed(stack, diskcache, "load_arrays", secs, "cache_read")
        _timed(stack, diskcache, "save_arrays", secs, "cache_write")
        t0 = time.perf_counter()
        scene = load_scene(path)
        secs["load"] = time.perf_counter() - t0
        renderer = Renderer(scene, params, device=dev)
        torch.cuda.synchronize()
        secs["setup"] = time.perf_counter() - t0
    return renderer, scene, secs, tags


def _one_sample(renderer, scene, dev) -> np.ndarray:
    st = make_trace_state(scene, renderer.params, device=dev)
    renderer.trace_samples(st)
    return renderer.get_image(st)


def phase_host_build(dev, hybrid) -> tuple[dict, Renderer, object, dict]:
    """The scene set-up on the host: testing.heavy_scene() written with
    write_yocto_scene into a temporary directory, JRT_CACHE_DIR a fresh
    temporary directory; load_scene + Renderer (regroup="auto") cold, then
    warm, with the set-up's seconds by step. The warm build must read the
    products "geom", "clusters" and "kernel_select" and call no builder
    (each raises), and one 512 x 512 sample of each must be bit-equal. The
    cold build's tables must come from the C++ builder (ops/native.py).
    Then build_cluster_tables on the heavy prims, native and numpy
    (JRT_NO_NATIVE=1), within rtol = atol = 2e-6, boxes exact; and
    build_world_flat on `hybrid` (testing.hybrid_scene(), its soup at the
    automatic budget) both ways, within HOST_WORLD_RTOL of the largest
    coordinate. Returns (stats, the warm Renderer, its scene, launches)."""
    out = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(root, exist_ok=True)
    saved_env = {k: os.environ.get(k) for k in ("JRT_CACHE_DIR", "JRT_NO_NATIVE")}
    _zero_counts()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.environ["JRT_CACHE_DIR"] = os.path.join(tmp, "cache")
        os.environ.pop("JRT_NO_NATIVE", None)
        try:
            t0 = time.perf_counter()
            path = write_yocto_scene(heavy_scene(), os.path.join(tmp, "heavy"))
            out["write_s"] = time.perf_counter() - t0
            params = Params(scene=path, resolution=MAIN_RES, samples=1, batch=1,
                            bounces=MAIN_BOUNCES, sampler="path")
            cold, cold_scene, out["cold"], cold_tags = _build_renderer(
                path, params, dev, False)
            require(cold_tags["native"] and all(cold_tags["native"]),
                    "the cold build's cluster tables did not take the C++ "
                    f"builder ({cold_tags['native']})")
            require({"geom", "clusters", "kernel_select"}
                    <= set(cold_tags["written"]),
                    f"the cold build saved {cold_tags['written']}")
            img_cold = _one_sample(cold, cold_scene, dev)
            warm, warm_scene, out["warm"], warm_tags = _build_renderer(
                path, params, dev, True)
            require({"geom", "clusters", "kernel_select"}
                    <= set(warm_tags["read"]) and not warm_tags["written"],
                    f"the warm build read {warm_tags['read']}, wrote "
                    f"{warm_tags['written']}")
            img_warm = _one_sample(warm, warm_scene, dev)
            require(np.array_equal(img_cold, img_warm),
                    "the warm build's sample differs from the cold one's")
            out["products_read"] = sorted(warm_tags["read"])
            out["cache_mb"] = sum(
                os.path.getsize(os.path.join(dirpath, f))
                for dirpath, _, files in os.walk(os.environ["JRT_CACHE_DIR"])
                for f in files) / 2**20
            out["warm_intersector"] = ("worklist" if warm.intersect.livegate
                                       is None else "regroup")
            del cold, cold_scene

            pv = np.asarray(warm.config.host_prim_verts, np.float64)
            inst = warm.config.host_prim_instance
            out["native_threads"] = native.threads()
            # every library this process built, nvcc's and g++'s
            out["lib_build_s"] = timing.setup().get(
                "lib_build", {"ns": 0})["ns"] / 1e9
            t0 = time.perf_counter()
            got = cluster_tables.build_cluster_tables(pv, inst)
            out["tables_native_s"] = time.perf_counter() - t0
            os.environ["JRT_NO_NATIVE"] = "1"
            t0 = time.perf_counter()
            want = cluster_tables.build_cluster_tables(pv, inst)
            out["tables_numpy_s"] = time.perf_counter() - t0
            require(got[3] == want[3] and np.array_equal(got[2], want[2]),
                    "native cluster boxes differ from numpy's")
            for a, b, what in ((got[0], want[0], "transforms"),
                               (got[1], want[1], "normals")):
                err = float(np.abs(a.astype(np.float64) - b).max())
                require(np.allclose(a, b, rtol=HOST_TABLE_TOL,
                                    atol=HOST_TABLE_TOL),
                        f"native {what} differ from numpy's by {err}")
                out[f"tables_{what}_max_abs_err"] = err
            out["tables_bit_equal"] = all(np.array_equal(a, b)
                                          for a, b in zip(got[:3], want[:3]))
            del got, want, pv

            flat = flatten_scene(hybrid, expand_prims=False)
            mask = select_flatten_shapes(flat, auto_hybrid_budget(flat))
            os.environ.pop("JRT_NO_NATIVE", None)
            t0 = time.perf_counter()
            wn = build_world_flat(flat, mask)
            out["world_native_s"] = time.perf_counter() - t0
            os.environ["JRT_NO_NATIVE"] = "1"
            t0 = time.perf_counter()
            wp = build_world_flat(flat, mask)
            out["world_numpy_s"] = time.perf_counter() - t0
            require(len(wp[0]) > 0, "the hybrid scene flattened no soup")
            scale = float(np.abs(wp[0]).max())
            err = float(np.abs(wn[0] - wp[0]).max())
            require(np.array_equal(wn[1], wp[1]) and np.array_equal(wn[2], wp[2])
                    and err <= HOST_WORLD_RTOL * scale,
                    f"native world soup differs from numpy's by {err} "
                    f"(scale {scale})")
            out.update(world_quads=len(wn[0]), world_max_abs_err=err,
                       world_bit_equal=bool(np.array_equal(wn[0], wp[0])))
            del wn, wp, flat
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    launches = _read_counts()
    require(launches["worklist_intersect"] > 0,
            "the host_build samples never launched worklist_intersect")
    return out, warm, warm_scene, launches


def _cost_row(renderer, scene, dev) -> dict:
    st = make_trace_state(scene, renderer.params, device=dev)
    t0 = time.perf_counter()
    c = renderer.sample_kernel_cost(st)
    c["count_s"] = time.perf_counter() - t0
    return c


def phase_cost(dev, paths: dict) -> tuple[dict, dict]:
    """Renderer.sample_kernel_cost of one 512 x 512, 8-bounce sample on
    each main path (`paths`: {name: (renderer, scene, ms per sample of its
    timed main_path samples)}), with roofline() over the main path's wall
    ms a sample and over one sample's device ms (torch.profiler); the
    op-name and kernel tables. The Cornell box's count on the card must be
    within COST_CPU_RTOL of the CPU's at 64 x 64. Returns (stats,
    launches)."""
    out = {}
    _zero_counts()
    for name, (r, scene, wall_ms) in paths.items():
        t0 = time.perf_counter()
        c = _cost_row(r, scene, dev)
        params, r.params = r.params, dataclasses.replace(r.params, batch=1)
        try:
            dev_ms = _sample_device_ms(r, scene, dev)
        finally:
            r.params = params
        top = sorted(c["ops"].items(), key=lambda kv: -kv[1][2])[:COST_TOP_OPS]
        out[name] = dict(
            flops=c["flops"], bytes=c["bytes_accessed"],
            kernel_flops=c["kernel_flops"], kernel_bytes=c["kernel_bytes"],
            other_flops=c["other_flops"], other_bytes=c["other_bytes"],
            chunks_per_sample=c["chunks_per_sample"],
            op_calls=sum(v[0] for v in c["ops"].values()),
            kernels=c["kernels"], top_ops_by_bytes=dict(top),
            count_s=c["count_s"], wall_ms=wall_ms, device_ms=dev_ms,
            at_wall=roofline(c["flops"], c["bytes_accessed"], wall_ms / 1e3),
            at_device=roofline(c["flops"], c["bytes_accessed"], dev_ms / 1e3),
            seconds=time.perf_counter() - t0)
        for k in ("at_wall", "at_device"):
            out[name][k].pop("mfu_note", None)
        log(f"cost {name}: {json.dumps(out[name])}")
    launches = _read_counts()
    small = Params(resolution=COST_CHECK_RES, samples=1, batch=1,
                   bounces=MAIN_BOUNCES, sampler="path")
    scene = cornell_scene()
    got = [_cost_row(Renderer(scene, small, device=device), scene, device)
           for device in (dev, "cpu")]
    agree = {k: abs(got[0][k] - got[1][k]) / got[1][k]
             for k in ("flops", "bytes_accessed")}
    require(max(agree.values()) <= COST_CPU_RTOL,
            f"the Cornell box's count on the card is {agree} off the CPU's")
    out["cornell_card_vs_cpu_rel"] = agree
    out["mfu_note"] = roofline(1.0, 1.0, 1.0)["mfu_note"]
    return out, launches


_TURN_CHILD = """
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import row_gather as rgat
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
REPS = @REPS@
CLUSTER_REPS = @CLUSTER_REPS@
@DEVICE_MS@
x = torch.load(sys.argv[2], weights_only=False)
dev = torch.device("cuda", 0)


def on_card(saved):
    return wl.WorklistTables(**{k: v.to(dev) if torch.is_tensor(v) else v
                                for k, v in saved.items()})


def same(got, ref):
    return all(torch.equal(a.cpu(), b) for a, b in zip(got, ref, strict=True))


dense = di.make_dense_intersect(x["verts"], x["inst"], dev)
args = [a.to(dev) for a in x["dense_args"]]
tables = on_card(x["tables"])
packed, grp = x["packed"].to(dev), x["grp_super"].to(dev)
plan = rg.Plan(**{k: v.to(dev) for k, v in x["plan"].items()})
rays8, tri = x["rays8"].to(dev), x["tri_ref"].to(dev)
n_slots = packed.shape[0]
ctables = on_card(x["cluster_tables"])
crays = [a.to(dev) for a in x["cluster_rays"]]
equal = dict(
    dense=same(dense(*args), x["dense_ref"]),
    sweep=same(ci.cluster_intersect_kernel(ctables, *crays),
               x["cluster_intersect_ref"]),
    streamed=same(ci.cluster_intersect_streamed_kernel(ctables, *crays),
                  x["cluster_intersect_streamed_ref"]),
    pack=torch.equal(rg.regroup_pack(plan, rays8, n_slots).cpu().view(torch.int32),
                     x["pack_ref"].view(torch.int32)),
    tritest=torch.equal(rg.regroup_tritest(packed, tables, grp).cpu(), x["tri_ref"]),
    unpack=torch.equal(rg.regroup_unpack(plan, tri).cpu(), x["unpack_ref"]))
print(json.dumps(dict(
    package=os.path.dirname(os.path.dirname(di.__file__)),
    equal=equal, dense_ms=device_ms(lambda: dense(*args)),
    sweep_ms=device_ms(lambda: ci.cluster_intersect_kernel(ctables, *crays),
                       CLUSTER_REPS),
    streamed_ms=device_ms(
        lambda: ci.cluster_intersect_streamed_kernel(ctables, *crays),
        CLUSTER_REPS),
    pack_ms=device_ms(lambda: rg.regroup_pack(plan, rays8, n_slots)),
    tritest_ms=device_ms(lambda: rg.regroup_tritest(packed, tables, grp)),
    unpack_ms=device_ms(lambda: rg.regroup_unpack(plan, tri)))))
"""

# the kernels timed in turns: (name, the child's key, its log label)
TURN_KERNELS = (("dense_intersect", "dense_ms", "dense"),
                ("cluster_intersect", "sweep_ms", "cluster sweep"),
                ("cluster_intersect_streamed", "streamed_ms", "streamed sweep"),
                ("regroup_pack", "pack_ms", "pack"),
                ("regroup_tritest", "tritest_ms", "tri-test"),
                ("regroup_unpack", "unpack_ms", "unpack"))


def kernels_in_turns(parent: str, turn_inputs: dict) -> dict:
    """Device times of the dense kernel, the two cluster kernels without a
    work list and the three regroup kernels of the tree in `parent` and of
    this one, each through its own wrappers in a child process on the same
    saved inputs, in turns: parent, this, this, parent -> {kernel:
    {"parent_ms": [..], "ms_turns": [..]}}."""
    code = (_TURN_CHILD.replace("@REPS@", str(REPS))
            .replace("@CLUSTER_REPS@", str(CLUSTER_REPS))
            .replace("@DEVICE_MS@", inspect.getsource(device_ms)))
    here = os.path.dirname(os.path.abspath(__file__))
    trees = (os.path.abspath(parent), here, here, os.path.abspath(parent))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "turn_inputs.pt")
        torch.save(turn_inputs, path)
        for tree in trees:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", code, tree, path],
                                  cwd=tree, capture_output=True, text=True,
                                  timeout=600)
            require(proc.returncode == 0,
                    f"the in-turns timing of {tree} failed:\n{proc.stderr[-4000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            require(os.path.samefile(os.path.dirname(got["package"]), tree),
                    f"the child for {tree} imported {got['package']}")
            for name, same in got["equal"].items():
                require(same, f"{tree}'s {name} kernel and this tree's plain "
                        "version differ")
            times = ", ".join(f"{label} {got[key]:.4f} ms"
                              for _, key, label in TURN_KERNELS)
            log(f"in turns, {tree}: {times} (device; child process "
                f"{time.perf_counter() - t0:.1f} s)")
            runs.append(got)
    return {name: dict(parent_ms=[runs[0][key], runs[3][key]],
                       ms_turns=[runs[1][key], runs[2][key]])
            for name, key, _ in TURN_KERNELS}


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", help="an earlier checkout whose dense, "
                      "cluster and regroup kernels are timed beside these, "
                      "in turns")
    opts = args.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    cuda_build.build_all({"dense_intersect": di.FLAGS,
                          "lane_compact": lc.FLAGS,
                          "worklist_intersect": wl.FLAGS,
                          "regroup_intersect": rg.FLAGS,
                          "instanced_intersect": ii.FLAGS,
                          "candidate_cull": ii.FLAGS,
                          "cluster_intersect": ci.FLAGS,
                          "span_stamp": (),
                          "curve_intersect": cw.FLAGS,
                          "shade_path": sp.FLAGS})
    di._lib()
    lc._lib()
    wl._lib()
    rg._lib()
    ii._lib()
    ii._cull_lib()
    ci._lib()
    span_stamp._lib()
    cw._lib()
    sp._lib()
    libs = timing.setup()
    log(f"build: {time.perf_counter() - t0:.2f} s, in parallel ("
        + ", ".join(f"{k} {v['libs']} libraries {v['ns'] / 1e9:.2f} s"
                    for k, v in libs.items()) + ")")
    for name, info in cuda_build.ptxas_info.items():
        log(f"ptxas {name}:\n{info}")
    cornell = Renderer(cornell_scene(), Params(
        resolution=MAIN_RES, samples=WARM_SPP + TIMED_SPP, batch=WARM_SPP,
        bounces=MAIN_BOUNCES, sampler="path"), device=dev)
    # with --parent: the inputs of the kernels timed in turns
    turn_inputs = None
    if opts.parent:
        verts, inst_ids = _host_prims(cornell.dscene, cornell.config)
        turn_inputs = dict(verts=verts, inst=inst_ids)
    t0 = time.perf_counter()
    spheres_scene = sphere_grid_scene()
    spheres = Renderer(spheres_scene, Params(
        resolution=MAIN_RES, samples=SPHERE_WARM_SPP + SPHERE_TIMED_SPP,
        batch=SPHERE_WARM_SPP, bounces=MAIN_BOUNCES, sampler="path"),
        device=dev)
    log(f"sphere grid: {spheres.config.n_prims} quads, "
        f"{spheres.intersect.tables.tab.shape[0]} clusters (padded), "
        f"{spheres.intersect.tables.sbbox.shape[0]} superclusters, table "
        f"{spheres.intersect.tables.tab.numel() * 4 / 1e6:.2f} MB, set-up "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    heavy_data = heavy_scene()
    heavy = Renderer(heavy_data, Params(
        resolution=MAIN_RES, samples=HEAVY_WARM_SPP + HEAVY_TIMED_SPP,
        batch=HEAVY_WARM_SPP, bounces=MAIN_BOUNCES, sampler="path",
        regroup="on"), device=dev)
    heavy_tables = heavy.intersect.tables
    log(f"heavy scene: {heavy.config.n_prims} quads, "
        f"{heavy_tables.tab.shape[0]} clusters (padded), "
        f"{heavy_tables.sbbox.shape[0]} superclusters, table "
        f"{heavy_tables.tab.numel() * 4 / 1e6:.2f} MB, set-up "
        f"{time.perf_counter() - t0:.2f} s")
    inst_scenes, inst = {}, {}
    for name, make, counts in (("instanced", instanced_scene, INSTANCED_COUNTS),
                               ("hybrid", hybrid_scene, HYBRID_COUNTS)):
        t0 = time.perf_counter()
        inst_scenes[name] = make()
        inst[name] = Renderer(inst_scenes[name], Params(
            resolution=MAIN_RES, samples=INST_WARM_SPP + INST_TIMED_SPP,
            batch=INST_WARM_SPP, bounces=MAIN_BOUNCES, sampler="path"),
            device=dev)
        got = _instanced_counts(inst[name])
        log(f"{name} scene: {got['items']} work items over {got['supers']} "
            f"superclusters, {got['n_prims']} padded shape-space quads, "
            f"flattened soup {got['soup']} quads, set-up "
            f"{time.perf_counter() - t0:.2f} s")
        require(got == counts, f"the {name} scene's counts {got} != {counts}")
    rng_agrees(dev)
    sp_primary = _primary_rays(spheres, dev)
    sp_bounce = _bounce_rays(
        wl.worklist_intersect(spheres.intersect.tables, *sp_primary),
        sp_primary[1], dev)
    phases = {
        "dense_intersect": phase_intersect(dev, cornell.intersect.tables,
                                           turn_inputs),
        "lane_compact": phase_compact(dev),
        "lane_expand": phase_expand(dev),
        "worklist_intersect": phase_worklist(dev, spheres, sp_primary,
                                             sp_bounce),
    }
    phases.update(phase_cluster(dev, spheres, sp_bounce, turn_inputs))
    del sp_primary, sp_bounce
    phases["instanced_intersect"], phases["candidate_cull"] = phase_instanced(
        dev, inst["instanced"], inst_scenes["instanced"])
    phases["instanced_intersect"]["hybrid_group_sweep"] = phase_hybrid_sweep(
        dev, inst["hybrid"])
    heavy_primary, heavy_bounce = _heavy_rays(heavy, dev)
    rg_phases, stages = phase_regroup(dev, heavy, heavy_bounce, turn_inputs)
    phases.update(rg_phases)
    if opts.parent:
        for name, turns in kernels_in_turns(opts.parent, turn_inputs).items():
            phases[name].update(turns)
        del turn_inputs
    for name, p in phases.items():
        lib = "none" if p["library_ms"] is None else f"{p['library_ms']:.4f} ms"
        log(f"phase {name}: ok, max_abs_err {p['max_abs_err']}, kernel "
            f"{p['ms']:.4f} ms (device; {p['call_ms']:.4f} ms with the host's "
            f"launch), plain {p['plain_ms']:.4f} ms, bound "
            f"{p['bound_ms']:.4f} ms ({p['bound_by']}), library call {lib}")
    hyb = inst["hybrid"].config
    versus = phase_regroup_vs_worklist(
        dev, heavy, heavy_primary, heavy_bounce, stages,
        dict(heavy=(heavy.config.host_prim_verts, heavy.config.host_prim_instance),
             hybrid_soup=(hyb.hyb_world_verts, hyb.hyb_world_inst)))
    del stages
    no_host_sync(spheres, dev)
    log("worklist intersect under set_sync_debug_mode('error'): no host sync")
    no_host_sync(inst["instanced"], dev)
    log("instanced intersect under set_sync_debug_mode('error'): no host sync")
    t0 = time.perf_counter()
    stamp_phase = phase_span_stamp(dev)
    log(f"span_stamp: {json.dumps(stamp_phase)} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    curve_phase = phase_curve_walk(dev)
    log(f"curve_walk: {json.dumps(curve_phase)} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    shade_phase = phase_shade_path(dev)
    log(f"shade_path: {json.dumps(shade_phase)} "
        f"({time.perf_counter() - t0:.1f} s)")

    c_stats, c_launch = main_path(cornell, cornell_scene(), dev)
    for name in ("dense_intersect", "lane_compact", "lane_expand"):
        require(c_launch[name] > 0, f"the Cornell path never launched {name}")
    s_stats, s_launch = main_path(spheres, spheres_scene, dev)
    require(spheres.options.sort_rays, "the sphere path does not sort")
    require(s_launch["worklist_intersect"] > 0,
            "the sphere path never launched worklist_intersect")
    require(s_launch["dense_intersect"] == 0,
            "the sphere path launched the dense intersector")
    h_stats, h_launch = main_path(heavy, heavy_data, dev)
    require(heavy.options.sort_rays, "the heavy path does not sort")
    for name in ("worklist_intersect", "regroup_pack", "regroup_tritest",
                 "regroup_unpack"):
        require(h_launch[name] > 0, f"the heavy path never launched {name}")
    require(h_launch["dense_intersect"] == 0,
            "the heavy path launched the dense intersector")
    del heavy
    # the heavy scene again in the Renderer's default configuration:
    # regroup="auto" runs kernel_select, which prints its decision line
    heavy = Renderer(heavy_data, Params(
        resolution=MAIN_RES, samples=HEAVY_WARM_SPP + HEAVY_TIMED_SPP,
        batch=HEAVY_WARM_SPP, bounces=MAIN_BOUNCES, sampler="path"),
        device=dev)
    livegate = heavy.intersect.livegate
    log(f"heavy scene, regroup='auto': bounce rays through "
        f"{'the worklist' if livegate is None else f'regroup, livegate {livegate}'}")
    a_stats, a_launch = main_path(heavy, heavy_data, dev)
    require(a_launch["dense_intersect"] == 0,
            "the heavy 'auto' path launched the dense intersector")
    del heavy
    inst_stats, inst_launch = {}, {}
    for name in ("instanced", "hybrid"):
        r = inst[name]
        require(r.options.sort_rays, f"the {name} path does not sort")
        st, ln = main_path(r, inst_scenes[name], dev)
        st.update(cull_per_sample(r, inst_scenes[name], dev))
        log(f"{name} path: candidate cull {st['cull_ms_per_sample']:.2f} "
            f"ms/sample in {st['cull_calls_per_sample']:.0f} calls, "
            f"{st['ms_per_sample']:.2f} ms/sample in all")
        for kernel in ("instanced_intersect", "candidate_cull"):
            require(ln[kernel] > 0, f"the {name} path never launched {kernel}")
        require(ln["dense_intersect"] == 0,
                f"the {name} path launched the dense intersector")
        inst_stats[name], inst_launch[name] = st, ln
    require(inst_launch["instanced"]["lane_compact"] == 0
            and inst_launch["instanced"]["lane_expand"] == 0,
            "the instanced path launched the lane kernels")
    require(inst_launch["hybrid"]["worklist_intersect"] > 0
            or inst_launch["hybrid"]["regroup_tritest"] > 0,
            "the hybrid path never launched the soup's kernels")
    log(f"host syncs per sample: heavy {h_stats['host_syncs_per_sample']:.1f} "
        f"('auto' {a_stats['host_syncs_per_sample']:.1f}), sphere grid "
        f"{s_stats['host_syncs_per_sample']:.1f}, Cornell box "
        f"{c_stats['host_syncs_per_sample']:.1f}, instanced "
        f"{inst_stats['instanced']['host_syncs_per_sample']:.1f}, hybrid "
        f"{inst_stats['hybrid']['host_syncs_per_sample']:.1f}")

    agree = agreement(dev, cornell_scene(), CHECK_RES, CHECK_SPP)
    log(f"agreement Cornell {CHECK_RES}x{CHECK_RES} {CHECK_SPP} spp card vs "
        f"cpu: {agree}")
    agree = agreement(dev, sphere_grid_scene(5, SPHERE_CHECK_SEGMENTS),
                      SPHERE_CHECK_RES, SPHERE_CHECK_SPP)
    log(f"agreement sphere grid (5, {SPHERE_CHECK_SEGMENTS}) "
        f"{SPHERE_CHECK_RES}x{SPHERE_CHECK_RES} {SPHERE_CHECK_SPP} spp card "
        f"vs cpu: {agree}")
    _zero_counts()
    agree = agreement(dev, sphere_grid_scene(HEAVY_CHECK_GRID, SPHERE_CHECK_SEGMENTS),
                      HEAVY_CHECK_RES, HEAVY_CHECK_SPP, sort_rays=True,
                      regroup="on", regroup_min_prims=0)
    small = _read_counts()
    require(min(small[k] for k in ("regroup_pack", "regroup_tritest",
                                   "regroup_unpack")) > 0,
            "the small heavy-path render never launched the regroup kernels")
    log(f"agreement heavy path (sort, regroup on) sphere grid "
        f"({HEAVY_CHECK_GRID}, {SPHERE_CHECK_SEGMENTS}) "
        f"{HEAVY_CHECK_RES}x{HEAVY_CHECK_RES} {HEAVY_CHECK_SPP} spp card vs "
        f"cpu: {agree}")
    # a reduced instanced scene forced through the two-level build, and a
    # mixed hybrid: a budget that flattens the room and the 64 small spheres
    # (4,102 quads, the worklist kernel) and keeps the 4 big ones as items
    for label, scene, budget in (
            ("instanced_scene(4, (16, 12))", instanced_scene(4, (16, 12)), 0),
            ("hybrid_scene(8, 8, 4, 32), hybrid_budget 5,000",
             hybrid_scene(8, 8, 4, 32), 5000)):
        _zero_counts()
        agree = forced_agreement(dev, scene, INST_CHECK_RES, INST_CHECK_SPP,
                                 budget)
        small = _read_counts()
        for kernel in ("instanced_intersect", "candidate_cull"):
            require(small[kernel] > 0,
                    f"the small render of {label} never launched {kernel}")
        require(("hybrid" not in label) or small["worklist_intersect"] > 0,
                f"the small render of {label} never launched the soup's kernel")
        log(f"agreement {label} {INST_CHECK_RES}x{INST_CHECK_RES} "
            f"{INST_CHECK_SPP} spp card vs cpu: {agree}")

    t0 = time.perf_counter()
    cli_phase = phase_cli(dev, c_stats["mpaths_per_s"])
    log(f"cli: {json.dumps(cli_phase)} ({time.perf_counter() - t0:.1f} s)")
    cli_launch = {name: sum(run.get(name, 0)
                            for run in cli_phase["launches"].values())
                  for name in phases}
    with one_rank_group():
        t0 = time.perf_counter()
        diff_phase, diff_launch = phase_diff(dev, cornell)
        log(f"diff: {json.dumps(diff_phase)} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        dinst_phase, dinst_launch = phase_diff_instanced(dev, inst)
        log(f"diff_instanced: {json.dumps(dinst_phase)} "
            f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    content_phase, content_launch = phase_scene_content(dev)
    log(f"scene_content: {json.dumps(content_phase)} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    host_phase, heavy_warm, heavy_scene_warm, host_launch = phase_host_build(
        dev, inst_scenes["hybrid"])
    log(f"host_build: {json.dumps(host_phase)} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cost_phase, cost_launch = phase_cost(dev, {
        "cornell": (cornell, cornell_scene(), c_stats["ms_per_sample"]),
        "spheres": (spheres, spheres_scene, s_stats["ms_per_sample"]),
        "heavy_auto": (heavy_warm, heavy_scene_warm, a_stats["ms_per_sample"]),
        "instanced": (inst["instanced"], inst_scenes["instanced"],
                      inst_stats["instanced"]["ms_per_sample"]),
        "hybrid": (inst["hybrid"], inst_scenes["hybrid"],
                   inst_stats["hybrid"]["ms_per_sample"]),
    })
    del inst, heavy_warm
    log(f"cost: {json.dumps(cost_phase)} ({time.perf_counter() - t0:.1f} s)")

    kernels = []
    for name, p in phases.items():
        entry = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1],
            launches=(c_launch[name] + s_launch[name] + h_launch[name]
                      + a_launch[name] + inst_launch["instanced"][name]
                      + inst_launch["hybrid"][name] + cli_launch[name]
                      + diff_launch[name] + dinst_launch[name]
                      + content_launch.get(name, 0) + host_launch[name]
                      + cost_launch[name]),
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"],
        )
        for extra in ("call_ms", "parent_ms", "ms_turns", "pretest", "primary",
                      "sorted_rays_ms", "passes", "group_passes",
                      "clusters", "pairs", "bound_pairs", "bound_clusters", "loads", "warps",
                      "groups", "steps", "votes", "warp_pairs", "tri_slots",
                      "precull_ms", "candidates", "tested", "spills",
                      "cluster_tests", "item_tests",
                      "group_sweep", "hybrid_group_sweep"):
            if extra in p:
                entry[extra] = p[extra]
        kernels.append(entry)
    log("main paths: " + json.dumps(dict(cornell=c_stats, spheres=s_stats,
                                         heavy=h_stats, heavy_auto=a_stats,
                                         **inst_stats)))
    log("instanced phase: " + json.dumps({
        k: v for k, v in phases["instanced_intersect"].items()
        if k.startswith(("flat", "vs_flat", "instanced"))}))
    log("regroup vs worklist: " + json.dumps(versus))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
