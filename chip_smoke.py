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
package) run on the sphere grid's bounce rays. Then it drives the five main
paths through the kernels, each with the launch counters zeroed just before
it:
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
on the CPU.

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
import json
import inspect
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import cuda_build, dense_intersect as di
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.ops.dense_intersect import _moller
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.integrator import (
    _host_prims, _sort_key, sort_bounds, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.flatten import flatten_scene
from julia_raytracer_tpu_torch.testing import (
    HYBRID_COUNTS, INSTANCED_COUNTS, check_hits, check_vs_flat, cornell_scene,
    heavy_scene, hybrid_scene, image_close, instanced_scene,
    render_instanced, require, sphere_grid_scene,
)
from julia_raytracer_tpu_torch.utils import kernel_select as ks
from julia_raytracer_tpu_torch.utils import rng as rng_mod
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
SPHERE_CHECK_RES, SPHERE_CHECK_SPP, SPHERE_CHECK_SEGMENTS = 64, 2, 16
N_RAYS = MAIN_RES * MAIN_RES  # lanes per main-path dispatch (262,144)
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
# H100 SXM peaks (NVIDIA's data sheet): HBM rate and fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 arithmetic of one Moller-Trumbore test in dense_intersect.cu by how
# far its pre-test lets it go (compares and selects not counted): every
# test 25 (9 pvec, 5 det, 3 tvec, 5 u numerator, |det|, 2|det|, 2^-23
# |det|), past the pre-test 24 more (9 qvec, the reciprocal, u, 6 v, 6 t,
# u + v)
DENSE_OPS = (25, 24)
# the test with its 6 edge subtractions and no pre-test (the count of the
# kernel before its table was precomputed)
DENSE_OPS_PER_TRI_TEST = 52
PRETEST_SUBSET = 16384  # rays of the labelled subset of the pre-test share
RAY_IN_BYTES = 32  # origin, direction, tmin, tmax
HIT_OUT_BYTES = 44  # prim, u, v, t, position, normal, instance

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


def profiled_ms(fn, reps: int = 5) -> float:
    """Device time of one call of fn: the durations of the device
    activities (kernels, copies, sets) that torch.profiler records over
    `reps` calls, summed and divided by reps. Unlike device_ms it takes a
    call that reads back to the host, and unlike median_ms it leaves out
    the host's time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    require(us > 0, "the profiler recorded no device time")
    return us / 1e3 / reps


def kernel_ms(fn, reps: int = REPS) -> dict:
    """A kernel's `ms` (device time, device_ms) and `call_ms` (one call
    between CUDA events, the host's launch included)."""
    return dict(ms=device_ms(fn, reps), call_ms=median_ms(fn, reps))


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    n_bytes = (N_RAYS * (RAY_IN_BYTES + HIT_OUT_BYTES) + table.quads.nbytes
               + table.prims.numel() * 4)
    out = dict(max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
               pretest=c, **bound(n_bytes, c["tests"] * DENSE_OPS[0]
                                  + c["reach"] * DENSE_OPS[1]))
    old_bound = bound(n_bytes, c["tests"] * DENSE_OPS_PER_TRI_TEST)["bound_ms"]
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
        f"{old_bound:.4f} ms at {DENSE_OPS_PER_TRI_TEST} operations a test, "
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
    n_bytes = vals.numel() * 4 + alive.numel() + STATE_PLANES * COMPACT_CAP * 4
    return dict(max_abs_err=int_max_abs_err(got[:, :total], ref[:, :total]),
                **t, plain_ms=plain_ms, library_ms=library_ms,
                **bound(n_bytes, 0))


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
    n_bytes = (narrow.numel() + 2 * fallback.numel()) * 4 + alive.numel()
    return dict(max_abs_err=int_max_abs_err(got, ref), **t,
                plain_ms=plain_ms, library_ms=library_ms, **bound(n_bytes, 0))


def _primary_rays(renderer, dev):
    """The camera rays of sample 0 of the 512 x 512 frame."""
    pix = torch.arange(N_RAYS, dtype=torch.int32, device=dev)
    rng = rng_mod.seed_state(pix, 0, 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = torch.stack([pix % MAIN_RES, pix // MAIN_RES], dim=-1)
    ro, rd = sample_camera(renderer.cam_arrays, ij, (MAIN_RES, MAIN_RES),
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
            f"{work['warp_pairs']}, (ray, cluster) pairs in the bound "
            f"{work['pairs']}, rays per table load "
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
    n = rays[0].shape[0]
    table_bytes = (tables.tab.numel() + tables.bbox.numel()
                   + tables.sbbox.numel()) * 4
    list_bytes = (order.numel() + cnt.numel()) * 4
    return dict(
        max_abs_err=err, bit_equal=bit_equal, same_prim=same_prim, **t,
        plain_ms=plain_ms, plain_wall_s=plain_wall, precull_ms=precull_ms,
        library_ms=None, hit_rate=float(got.hit.float().mean()),
        mean_list=float(cnt.float().mean()), **work,
        **bound(n * (RAY_IN_BYTES + HIT_OUT_BYTES) + table_bytes + list_bytes,
                work["pairs"] * wl.TRIS * wl.OPS_PER_TRI_TEST),
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
        "warp_pairs", "groups", "steps", "votes", "mean_list", "precull_ms")},
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
    plan_bytes = 4 * plan.cnt_ts.numel() + live_pairs * (rg.TILE + 4)
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
        **bound(plan_bytes + 8 * n_super + live_lanes * rg.PAYLOAD * 4
                + packed.numel() * 4, 0))

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
    # the tables the function must read: each wanted cluster's 8 KB once,
    # and the boxes of the supers its groups test
    table_bytes = (work["clusters"] * wl.ROWS * wl.TRIS
                   + torch.unique(grp_super).numel() * tables.sup * 8) * 4
    tritest = dict(
        max_abs_err=int_max_abs_err(tri, tri_ref),
        **kernel_ms(lambda: rg.regroup_tritest(packed, tables, grp_super)),
        plain_ms=plain_ms, library_ms=None, **work,
        **bound(packed.numel() * 4 + table_bytes + grp_super.numel() * 4
                + tri.numel() * 4,
                work["passes"] * wl.TRIS * wl.OPS_PER_TRI_TEST))
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
        # + the (tri, t) of each set bit's slot, each ray's result written
        **bound(plan_bytes + set_bits * 8 + res.numel() * 4, 0))
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


def phase_cluster(dev, renderer, rays, need_pairs: int,
                  turn_inputs: dict | None) -> dict:
    """Rows 4 and 5 (ops/cluster_intersect.py: each warp of 32 rays sweeps
    every cluster, or every supercluster of 64 and then its clusters, each
    ray culling against its tmax) on the sphere grid's 262,144 pixel-order
    bounce rays: each kernel against its plain version on the card, bit for
    bit, and within check_hits of the worklist intersector on the same rays
    (both pack the BVH-ordered quads, so prim ids agree); the walks' table
    loads (`loads`, counted by the plain versions). The bound counts
    the operations of what the function needs, `need_pairs`: the (ray,
    cluster) pairs that the worklist intersector, computing the same closest
    hits front to back against each ray's running best, tests on these
    rays; the kernels' own cull against tmax passes more. No PyTorch call
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
        out[name] = dict(
            max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
            bound_pairs=need_pairs,
            **work, **bound(n * (RAY_IN_BYTES + HIT_OUT_BYTES) + box_bytes
                            + work["clusters"] * wl.ROWS * wl.TRIS * 4,
                            need_pairs * wl.TRIS * wl.OPS_PER_TRI_TEST))
        log(f"{name}: {n} sphere-grid bounce rays, {ci.n_clusters(tables)} "
            f"clusters in {tables.sbbox.shape[0]} supers of {ci.SUPER}, "
            f"bit-equal to its plain version, within check_hits of the "
            f"worklist (max |dt| {wl_dt}), (ray, cluster) pairs culled against "
            f"tmax {work['pairs']}, needed (the worklist's on these rays) "
            f"{need_pairs}, clusters tested {work['clusters']}, (warp, "
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
    lists = ii.precull(*bounce, tables.wi_bbox)
    got = ii.instanced_intersect_kernel(tables, *bounce, *lists)
    plain_ms, (want, work) = event_ms(
        lambda: ii.instanced_intersect_plain(tables, *bounce, *lists))
    require(_bit_equal(got, want),
            "instanced_intersect kernel and plain version differ")
    err = check_hits(want, got)
    t = kernel_ms(lambda: ii.instanced_intersect_kernel(tables, *bounce, *lists),
                  CLUSTER_REPS)
    ms = t["ms"]
    precull_ms = median_ms(lambda: ii.precull(*bounce, tables.wi_bbox),
                           CLUSTER_REPS)
    n, ng = bounce[0].shape[0], lists[2].shape[0]
    # each input read once: the rays, the group counts, the list entries the
    # warps walk (order, t_low, and the item's supercluster and instance),
    # the boxes of the superclusters, the rows of the instances and the
    # tables of the clusters they visit; each result written once
    n_bytes = (n * (RAY_IN_BYTES + HIT_OUT_BYTES) + ng * 4
               + work["steps"] * 16 + work["supers"] * tables.sup * 32
               + work["instances"] * 96 + work["clusters"] * wl.ROWS * wl.TRIS * 4)
    out = dict(max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
               precull_ms=precull_ms, **work,
               candidates=int(lists[2].sum()),
               **bound(n_bytes, work["pairs"] * wl.TRIS * wl.OPS_PER_TRI_TEST))
    log(f"instanced_intersect: {n} sorted bounce rays, {len(tables.wi_sup)} "
        f"work items, candidates per {ii.GROUP_RAYS} rays "
        f"{float(lists[2].float().mean()):.1f} ({out['candidates']} in all), "
        f"{_walk_counters(work)}, clusters {work['clusters']}, bit-equal to "
        f"its plain version, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"precull (cull kernel, sort, count) {precull_ms:.4f} ms, bound "
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
    the lists at that size: the keys (f32), argsort's int64 indices,
    order (i32) and t_low (f32), each [groups, items]."""
    sweep = {}
    items = tables.wi_sup.shape[0]
    for g in GROUP_SWEEP:
        row = {}
        for name, rays in named_rays:
            lg = ii.precull(*rays, tables.wi_bbox, g)
            row[name] = dict(
                precull_ms=median_ms(
                    lambda: ii.precull(*rays, tables.wi_bbox, g), 5),
                kernel_ms=median_ms(lambda: ii.instanced_intersect_kernel(
                    tables, *rays, *lg, group=g), 5),
                mean_list=float(lg[2].float().mean()),
                list_bytes=lg[0].shape[0] * items * (4 + 8 + 4 + 4))
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
    """The candidate cull (ops/instanced_intersect.py candidate_keys_*) on
    the instanced scene's sorted bounce rays against its work items' world
    boxes: kernel against plain version on the card, bit for bit. Bound:
    rays x items x CULL_OPS_PER_TEST operations against the rays, the boxes
    and the keys. No single PyTorch call computes it (library_ms null)."""
    boxes = tables.wi_bbox
    got = ii.candidate_keys_kernel(*rays, boxes)
    want = ii.candidate_keys_plain(*rays, boxes)
    require(torch.equal(got, want), "candidate_cull kernel and plain differ")
    t = kernel_ms(lambda: ii.candidate_keys_kernel(*rays, boxes))
    ms = t["ms"]
    plain_ms = median_ms(lambda: ii.candidate_keys_plain(*rays, boxes),
                         PLAIN_REPS)
    ng, items = got.shape
    out = dict(max_abs_err=0.0, **t, plain_ms=plain_ms, library_ms=None,
               finite_keys=int(torch.isfinite(got).sum()),
               **bound(rays[0].shape[0] * RAY_IN_BYTES + items * 24
                       + ng * items * 4,
                       ng * ii.GROUP_RAYS * items * ii.CULL_OPS_PER_TEST))
    log(f"candidate_cull: {rays[0].shape[0]} sorted bounce rays in {ng} "
        f"groups of {ii.GROUP_RAYS} x {items} items, keys bit-equal to the "
        f"plain version ({out['finite_keys']} finite), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}), library call: none")
    return out


def cull_per_sample(renderer, scene, dev) -> dict:
    """One sample of an instanced main path with the work-item precull
    (the plain PyTorch candidate cull) bracketed by CUDA events: its device
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
    ii.candidate_keys_kernel.launches = 0
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
        "candidate_cull": ii.candidate_keys_kernel.launches,
        "cluster_intersect": ci.cluster_intersect_kernel.launches,
        "cluster_intersect_streamed": ci.cluster_intersect_streamed_kernel.launches,
    }


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


# Run in a child process by kernels_in_turns (argv: a tree, the inputs
# file): rows 1, 4, 5, 8, 9 and 10 through that tree's own wrappers, each
# result held to this tree's plain version bit for bit, then their device
# times (device_ms; rows 4 and 5 over CLUSTER_REPS launches).
_TURN_CHILD = """
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from julia_raytracer_tpu_torch.ops import cluster_intersect as ci
from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
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
                          "cluster_intersect": ci.FLAGS})
    di._lib()
    lc._lib()
    wl._lib()
    rg._lib()
    ii._lib()
    ii._cull_lib()
    ci._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s, in parallel "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")
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
        "dense_intersect": phase_intersect(dev, cornell.intersect.table,
                                           turn_inputs),
        "lane_compact": phase_compact(dev),
        "lane_expand": phase_expand(dev),
        "worklist_intersect": phase_worklist(dev, spheres, sp_primary,
                                             sp_bounce),
    }
    phases.update(phase_cluster(dev, spheres, sp_bounce,
                                phases["worklist_intersect"]["pairs"],
                                turn_inputs))
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
    livegate = getattr(heavy.intersect, "livegate", None)
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
    del inst
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

    kernels = []
    for name, p in phases.items():
        entry = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1],
            launches=(c_launch[name] + s_launch[name] + h_launch[name]
                      + a_launch[name] + inst_launch["instanced"][name]
                      + inst_launch["hybrid"][name]),
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"],
        )
        for extra in ("call_ms", "parent_ms", "ms_turns", "pretest", "primary",
                      "sorted_rays_ms", "passes", "group_passes",
                      "clusters", "pairs", "bound_pairs", "loads", "warps",
                      "groups", "steps", "votes", "warp_pairs", "tri_slots",
                      "precull_ms", "candidates", "finite_keys",
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
