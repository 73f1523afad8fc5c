"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from julia_raytracer_tpu_torch/csrc
with nvcc (one process per source, all at once), checks each kernel against
its plain PyTorch version on the card at the main paths' shapes and times
both beside the card's bound and, where one exists, a single PyTorch call
computing the same function. It holds the whole regroup intersector against
the worklist intersector on the heavy scene's rays and fits the H100's
kernel-selection costs from their stage times. Then it drives the three main
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
and holds small renders of the three paths on the card against the same
renders on the CPU.

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
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.ops import lane_compact as lc
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.integrator import _sort_key, trace_wavefront
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import (
    check_hits, cornell_scene, heavy_scene, image_close, require,
    sphere_grid_scene,
)
from julia_raytracer_tpu_torch.utils import kernel_select as ks
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.vecmath import normalize

MAIN_RES, MAIN_BOUNCES, WARM_SPP, TIMED_SPP = 512, 8, 8, 32
SPHERE_WARM_SPP, SPHERE_TIMED_SPP = 2, 8
HEAVY_WARM_SPP, HEAVY_TIMED_SPP = 1, 2
HEAVY_CHECK_GRID, HEAVY_CHECK_RES, HEAVY_CHECK_SPP = 4, 64, 2
CHECK_RES, CHECK_SPP = 128, 4
SPHERE_CHECK_RES, SPHERE_CHECK_SPP, SPHERE_CHECK_SEGMENTS = 64, 2, 16
N_RAYS = MAIN_RES * MAIN_RES  # lanes per main-path dispatch (262,144)
COMPACT_CAP = N_RAYS // 4  # first two-phase boundary of the main path
STATE_PLANES = 45  # int32 planes of the integrator state (TraceVars)
OUTPUT_PLANES = 11  # radiance 3, hit 1, albedo 3, normal 3, rng 1
REPS = 20
PLAIN_WORKLIST_REPS = 3  # its plain version reads counts back every step
PLAIN_REPS = 5  # the regroup kernels' plain versions
# live shares of the regroup-vs-worklist sweep (the JAX package's gates
# are 0.45 and 0.2)
LIVE_SHARES = (0.45, 0.2, 0.1, 0.03)
# H100 SXM peaks (NVIDIA's data sheet): HBM rate and fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 arithmetic of one Moller-Trumbore test in dense_intersect.cu
# (6 edges, 9 pvec, 5 det, 1 divide, 3 tvec, 6 u, 9 qvec, 6 v, 6 t, 1 u+v)
DENSE_OPS_PER_TRI_TEST = 52
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
    require(_bit_equal(got, ref), "dense kernel and plain version differ")
    require(got.hit.float().mean() > 0.5, "too few intersect hits")
    plain_ms = median_ms(lambda: di.dense_intersect_plain(table, *args))
    ms = median_ms(lambda: di.dense_intersect(table, *args))
    q = table.shape[0]
    tests = 2 * q - int((table[:, 6:9] == table[:, 9:12]).all(dim=1).sum())
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound(N_RAYS * (RAY_IN_BYTES + HIT_OUT_BYTES) + table.numel() * 4,
                        N_RAYS * tests * DENSE_OPS_PER_TRI_TEST))


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
    ms = median_ms(lambda: lc.compact_planes(vals, alive, COMPACT_CAP))
    library_ms = median_ms(lambda: vals[:, alive])
    n_bytes = vals.numel() * 4 + alive.numel() + STATE_PLANES * COMPACT_CAP * 4
    return dict(max_abs_err=int_max_abs_err(got[:, :total], ref[:, :total]),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
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
    ms = median_ms(lambda: lc.expand_planes(narrow, alive, fallback))
    library_ms = median_ms(library)
    n_bytes = (narrow.numel() + 2 * fallback.numel()) * 4 + alive.numel()
    return dict(max_abs_err=int_max_abs_err(got, ref), ms=ms,
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


def _sorted(rays, dscene):
    """Rays in the order trace_wavefront sorts them: by the wavefront key
    over the scene's bounds, dead lanes (tmax < 0) last."""
    pv = dscene.prim_verts.reshape(-1, 3)
    key = _sort_key(rays[0], rays[1], pv.amin(dim=0), pv.amax(dim=0))
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
    ms = median_ms(lambda: wl.worklist_intersect_kernel(tables, *rays, order, cnt))
    plain_ms = median_ms(
        lambda: wl.worklist_intersect_plain(tables, *rays, order, cnt),
        PLAIN_WORKLIST_REPS)
    precull_ms = median_ms(lambda: wl.precull(*rays, tables.sbbox))
    n = rays[0].shape[0]
    table_bytes = (tables.tab.numel() + tables.bbox.numel()
                   + tables.sbbox.numel()) * 4
    list_bytes = (order.numel() + cnt.numel()) * 4
    return dict(
        max_abs_err=err, bit_equal=bit_equal, same_prim=same_prim, ms=ms,
        plain_ms=plain_ms, plain_wall_s=plain_wall, precull_ms=precull_ms,
        library_ms=None, hit_rate=float(got.hit.float().mean()),
        mean_list=float(cnt.float().mean()), **work,
        **bound(n * (RAY_IN_BYTES + HIT_OUT_BYTES) + table_bytes + list_bytes,
                work["pairs"] * wl.TRIS * wl.OPS_PER_TRI_TEST),
    )


def phase_worklist(dev, renderer) -> dict:
    """The sphere grid (102,406 quads, 13 superclusters of 128 clusters) at
    262,144 rays, twice: the 512 x 512 camera rays, then cosine bounce rays
    from their hits (divergent, long work lists), both in pixel order.
    Kernel vs plain version on the card; no PyTorch
    call computes this function (library_ms null). Then the kernel alone
    on the same rays in the wavefront sort's order, as the sorted main
    path sends them."""
    tables = renderer.intersect.tables
    primary = _primary_rays(renderer, dev)
    p = _worklist_case(tables, primary)
    hit = wl.worklist_intersect(tables, *primary)
    bounce = _bounce_rays(hit, primary[1], dev)
    b = _worklist_case(tables, bounce)
    for name, c in (("primary", p), ("bounce", b)):
        log(f"worklist {name}: {N_RAYS} rays, hit rate {c['hit_rate']:.4f}, "
            f"bit-equal {c['bit_equal']}, same prim {c['same_prim']:.6f}, "
            f"max |dt| {c['max_abs_err']}, mean work list {c['mean_list']:.3f} "
            f"of {tables.sbbox.shape[0]}, (ray, cluster) pairs culled in "
            f"{c['pairs']} (warp, cluster) {c['warp_pairs']} (block, cluster) "
            f"{c['block_pairs']}, kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} "
            f"ms (one call {c['plain_wall_s']:.2f} s wall), precull "
            f"{c['precull_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']}), library call: none")
    require(p["hit_rate"] > 0.5, "too few primary hits on the sphere grid")
    sorted_ms = {}
    for name, rays in (("primary", primary), ("bounce", bounce)):
        rays = _sorted(rays, renderer.dscene)
        order, cnt = wl.precull(*rays, tables.sbbox)
        sorted_ms[name] = median_ms(
            lambda: wl.worklist_intersect_kernel(tables, *rays, order, cnt))
        log(f"worklist {name}, sorted rays: kernel {sorted_ms[name]:.4f} ms "
            f"(pixel order: {(p if name == 'primary' else b)['ms']:.4f} ms), "
            f"mean work list {float(cnt.float().mean()):.3f}")
    return dict(b, primary={k: p[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "pairs",
        "warp_pairs", "block_pairs", "mean_list", "precull_ms")},
        sorted_rays_ms=sorted_ms)


def _heavy_rays(renderer, dev):
    """The heavy scene's 512 x 512 camera rays and cosine bounce rays from
    their hits (dead where the camera ray missed), each in the wavefront
    sort's order, as the sorted main path sends them."""
    primary = _sorted(_primary_rays(renderer, dev), renderer.dscene)
    hit = wl.worklist_intersect(renderer.intersect.tables, *primary)
    return primary, _sorted(_bounce_rays(hit, primary[1], dev), renderer.dscene)


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


def phase_regroup(dev, renderer, bounce) -> dict:
    """The three regroup kernels on the heavy scene's 262,144 bounce rays:
    each against its plain version on the card, bit for bit, with its
    bound and, for pack, the library gather of the rays in the stable
    (super, tile, lane) order."""
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
    log(f"regroup plan: {nb} tiles x {n_super} supers, {set_bits} set bits "
        f"of {live_lanes} lanes in {live_pairs} live (tile, super) pairs, "
        f"{n_groups} groups of 1024 slots")

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
        ms=median_ms(lambda: rg.regroup_pack(plan, rays8, n_slots)),
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
    # the tables the function must read: each wanted cluster's 8 KB once,
    # and the boxes of the supers its groups test
    table_bytes = (work["clusters"] * wl.ROWS * wl.TRIS
                   + torch.unique(grp_super).numel() * tables.sup * 8) * 4
    tritest = dict(
        max_abs_err=int_max_abs_err(tri, tri_ref),
        ms=median_ms(lambda: rg.regroup_tritest(packed, tables, grp_super)),
        plain_ms=plain_ms, library_ms=None, **work,
        **bound(packed.numel() * 4 + table_bytes + grp_super.numel() * 4
                + tri.numel() * 4,
                work["passes"] * wl.TRIS * wl.OPS_PER_TRI_TEST))
    log(f"regroup_tritest: (slot, cluster) passes {work['passes']}, (group, "
        f"cluster) table loads {work['group_passes']}, distinct clusters "
        f"{work['clusters']}, slots {packed.shape[0]}, plain version "
        f"{plain_ms / 1e3:.2f} s")

    # ---- unpack
    res = rg.regroup_unpack(plan, tri)
    res_ref = rg.regroup_unpack_plain(plan, tri)
    torch.cuda.synchronize()
    require(torch.equal(res, res_ref), "regroup_unpack kernel and plain version differ")
    unpack = dict(
        max_abs_err=int_max_abs_err(res, res_ref),
        ms=median_ms(lambda: rg.regroup_unpack(plan, tri)),
        plain_ms=median_ms(lambda: rg.regroup_unpack_plain(plan, tri), PLAIN_REPS),
        library_ms=None,
        # + the (tri, t) of each set bit's slot, each ray's result written
        **bound(plan_bytes + set_bits * 8 + res.numel() * 4, 0))
    stages = dict(rays8=rays8, res=res)
    return dict(regroup_pack=pack, regroup_tritest=tritest,
                regroup_unpack=unpack), stages


def phase_regroup_vs_worklist(dev, renderer, primary, bounce, kernels, stages):
    """The whole regroup intersector (count, three kernels, merge) against
    the worklist intersector (precull, kernel) on the heavy scene's camera
    and bounce rays: check_hits, both times, the fallbacks; both again on
    the bounce rays with fewer of them live; then the H100's SelectCosts
    fitted from the stage times on the bounce rays and kernel_select's
    pass counts of the same rays."""
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
        out[name] = dict(
            regroup_ms=rg_ms, worklist_ms=wl_ms, ratio=rg_ms / wl_ms,
            fallbacks=fb, max_abs_dt=err,
            same_prim=float((h_rg.prim == h_wl.prim).float().mean()),
            hit_rate=float(h_wl.hit.float().mean()),
            live=float((rays[3] > 0).float().mean()))
        log(f"regroup vs worklist, {name} rays ({N_RAYS}, live share "
            f"{out[name]['live']:.4f}): within check_hits (same prim "
            f"{out[name]['same_prim']:.6f}, max |dt| {err}), regroup "
            f"{rg_ms:.4f} ms (fallbacks in the first call: {fb}), worklist "
            f"{wl_ms:.4f} ms, measured ratio {rg_ms / wl_ms:.4f}")

    # ---- the liveness gate's crossover on this card: the bounce rays with
    # a seeded share of them dead (tmax = -1, sorted last), regroup with no
    # gate against the worklist
    g = torch.Generator(device=dev).manual_seed(7)
    out["live_sweep"] = []
    for share in LIVE_SHARES:
        dead = torch.rand(N_RAYS, generator=g, device=dev) >= share
        rays = _sorted((*bounce[:3], torch.where(dead, -1.0, bounce[3])),
                       renderer.dscene)
        rg_ms = median_ms(lambda: rg.regroup_intersect(tables, *rays,
                                                       livegate=0.0), 5)
        wl_ms = median_ms(lambda: wl.worklist_intersect(tables, *rays), 5)
        live = float((rays[3] > 0).float().mean())
        out["live_sweep"].append(dict(live=live, regroup_ms=rg_ms,
                                      worklist_ms=wl_ms))
        log(f"bounce rays at live share {live:.4f}: regroup (no gate) "
            f"{rg_ms:.4f} ms, worklist {wl_ms:.4f} ms, ratio "
            f"{rg_ms / wl_ms:.4f}")

    # ---- stage times on the bounce rays and the cost fit
    rays8 = stages["rays8"]
    t_count = median_ms(lambda: _plan(tables, rays8))
    t_merge = median_ms(lambda: rg.merge(tables, rays8, stages["res"]))
    t_pack = kernels["regroup_pack"]["ms"]
    t_unpack = kernels["regroup_unpack"]["ms"]
    t_tri = kernels["regroup_tritest"]["ms"]
    n_clusters = -(-renderer.config.n_prims // 64)
    np_rays = [x.cpu().numpy() for x in bounce]
    counts = ks.count_passes(*np_rays, tables.bbox[:n_clusters, :6].cpu().numpy(),
                             device=dev)
    t_rg, t_wl = out["bounce"]["regroup_ms"], out["bounce"]["worklist_ms"]
    # the signed remainder: negative when the stages timed one by one add
    # up to more than the whole call, and then the fit is flagged
    fixed = t_rg - (t_count + t_pack + t_tri + t_unpack + t_merge)
    costs = ks.SelectCosts(
        us_wl_pass=t_wl * 1e3 / counts["passes_wl"],
        us_rg_pass=t_tri * 1e3 / counts["passes_rg"],
        us_rg_pair=(t_pack + t_unpack) * 1e3 / counts["pairs"],
        us_rg_ray=(t_count + t_merge) * 1e3 / N_RAYS,
        ms_rg_fixed=fixed)
    log(f"regroup stages on the bounce rays: count + read + group map "
        f"{t_count:.4f} ms, pack {t_pack:.4f}, tri-test {t_tri:.4f}, unpack "
        f"{t_unpack:.4f}, merge {t_merge:.4f}, rest {fixed:.4f} (whole "
        f"{t_rg:.4f}); kernel_select counts on these rays {counts}")
    log(f"fitted H100 SelectCosts: {costs._asdict()}"
        + ("" if fixed >= 0.0 else " FLAGGED: the stages timed apart sum to "
           f"{-fixed:.4f} ms more than the whole, so ms_rg_fixed < 0"))
    out["fit_flagged"] = fixed < 0.0
    verts, inst = renderer.config.host_prim_verts, renderer.config.host_prim_instance
    for label, c in (("module costs", ks.H100_COSTS), ("fitted costs", costs)):
        sel = ks.select_bounce_kernel(verts, inst, costs=c, device=dev)
        log(f"kernel_select with the {label}: predicted ratio {sel['ratio']} "
            f"on {sel['n_rays']} synthetic bounce rays (measured on this "
            f"run's bounce rays {t_rg / t_wl:.4f}) -> {sel['kernel']} "
            f"(threshold {sel['threshold']}, passes wl {sel['passes_wl']} rg "
            f"{sel['passes_rg']}, pairs {sel['pairs']}, probe {sel['probe_s']} s)")
        out[label.split()[0] + "_prediction"] = {
            k: sel[k] for k in ("ratio", "kernel", "t_wl_ms", "t_rg_ms")}
    out["fitted_costs"] = costs._asdict()
    out["stages_ms"] = dict(count=t_count, pack=t_pack, tritest=t_tri,
                            unpack=t_unpack, merge=t_merge, rest=fixed)
    out["counts"] = counts
    return out


def no_host_sync(renderer, dev) -> None:
    """One worklist intersect (precull + kernel) under
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


def _read_counts() -> dict:
    return {
        "dense_intersect": di.dense_intersect.launches,
        "lane_compact": lc.compact_planes.launches,
        "lane_expand": lc.expand_planes.launches,
        "worklist_intersect": wl.worklist_intersect_kernel.launches,
        "regroup_pack": rg.regroup_pack.launches,
        "regroup_tritest": rg.regroup_tritest.launches,
        "regroup_unpack": rg.regroup_unpack.launches,
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
                          "regroup_intersect": rg.FLAGS})
    di._lib()
    lc._lib()
    wl._lib()
    rg._lib()
    log(f"build: {time.perf_counter() - t0:.2f} s, in parallel "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")
    for name, info in cuda_build.ptxas_info.items():
        log(f"ptxas {name}:\n{info}")

    cornell = Renderer(cornell_scene(), Params(
        resolution=MAIN_RES, samples=WARM_SPP + TIMED_SPP, batch=WARM_SPP,
        bounces=MAIN_BOUNCES, sampler="path"), device=dev)
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
    rng_agrees(dev)
    phases = {
        "dense_intersect": phase_intersect(dev, cornell.intersect.table),
        "lane_compact": phase_compact(dev),
        "lane_expand": phase_expand(dev),
        "worklist_intersect": phase_worklist(dev, spheres),
    }
    heavy_primary, heavy_bounce = _heavy_rays(heavy, dev)
    rg_phases, stages = phase_regroup(dev, heavy, heavy_bounce)
    phases.update(rg_phases)
    for name, p in phases.items():
        lib = "none" if p["library_ms"] is None else f"{p['library_ms']:.4f} ms"
        log(f"phase {name}: ok, max_abs_err {p['max_abs_err']}, kernel "
            f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
            f"{p['bound_ms']:.4f} ms ({p['bound_by']}), library call {lib}")
    versus = phase_regroup_vs_worklist(dev, heavy, heavy_primary, heavy_bounce,
                                       rg_phases, stages)
    del stages
    no_host_sync(spheres, dev)
    log("worklist intersect under set_sync_debug_mode('error'): no host sync")

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
    log(f"host syncs per sample: heavy {h_stats['host_syncs_per_sample']:.1f} "
        f"('auto' {a_stats['host_syncs_per_sample']:.1f}), sphere grid "
        f"{s_stats['host_syncs_per_sample']:.1f}, Cornell box "
        f"{c_stats['host_syncs_per_sample']:.1f}")

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

    kernels = []
    for name, p in phases.items():
        entry = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1],
            launches=(c_launch[name] + s_launch[name] + h_launch[name]
                      + a_launch[name]),
            max_abs_err=p["max_abs_err"], ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"],
            library_ms=p["library_ms"],
        )
        for extra in ("primary", "sorted_rays_ms", "passes", "group_passes",
                      "clusters"):
            if extra in p:
                entry[extra] = p[extra]
        kernels.append(entry)
    log("main paths: " + json.dumps(dict(cornell=c_stats, spheres=s_stats,
                                         heavy=h_stats, heavy_auto=a_stats)))
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
