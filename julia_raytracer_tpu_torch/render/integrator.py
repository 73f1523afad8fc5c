"""Wavefront path integrators (naive + MIS path tracing with volumes),
port of julia_raytracer_tpu/render/integrator.py.

The whole ray batch advances in lock-step: every lane carries its own
bounce counter, weight, RNG stream and a one-slot volume stack. The loop
carries the *current intersection* across iterations; each body computes
the NEXT ray's intersection at its end. The loop runs eagerly on the
host, one body per iteration, until no lane is alive; each loop test
reads the live-lane count back from the device (`trace_wavefront.host_syncs`
counts them). Spans (utils/timing.py) mark the layers: `wavefront`
around the call, holding `primary_hit`, `loop_test` (each read), `body`
(with the count its test read, `live=`, the state's `width=` and
`graphed=`, 1 where a CUDA graph ran it; holding the bounce's
`intersect`, which appears only on eager and captured bodies, and
below it the work items' device_spans, which every replay files too),
`compact` (`live=`, `width=`, `cap=`), `expand` and `unsort`.

CUDA graphs (`graphs`, a render/body_graphs.py BodyGraphs that the
Renderer owns): on the card, a while-loop body whose Intersector is
`graph_safe` is captured at the second sighting of its lane width and
replayed from then on; the replay launches the same kernels on
the same data, so the outputs are the eager loop's bit for bit.

The shading kernel (ops/shade_path.py, csrc/shade_path.cu): where
`shade_route` allows it (the path sampler's unsorted while loop on the
card, on scenes whose weight update reads nothing of the next hit), a
body's shading is one launch before its intersect, and its outputs are
the eager bounce's bit for bit; `shade_plain` (`eager_bounce` with
its intersect stood in for) is its plain version. `body` spans carry
`shaded=`, 1 on that route.

Wavefront sort (`TraceOptions.sort_rays`; the renderer turns it on for
scenes of >= 50,000 quads, as the JAX package does): camera rays, and
every bounce's rays after the shading, are reordered by a 30-bit key
(direction octant, origin morton, direction morton; dead lanes last),
so each 1024-ray block of the intersector shares a direction octant and
an origin neighbourhood. Lanes carry their original index and are
unsorted at the end. Each lane's path does not depend on its position,
so the outputs equal the unsorted loop's.

Two-phase dispatch, on by default for widths n >= 16,384: the loop runs
at full width until the survivors fit width / compact_div, then narrows,
up to compact_levels such boundaries, and the narrow loop's outputs are
merged back. Dead lanes' outputs are final at a boundary, so radiance,
hit, albedo and normal equal the plain loop's bit for bit.
  - sorted (DIV 2, 5 levels): one extra body packs the <= cap survivors
    into the prefix, the narrow state is that prefix (a slice) and the
    merge a contiguous update of the prefix;
  - unsorted (DIV 4, 3 levels, n % 1024 == 0): the lane compactor
    (ops/lane_compact.py, a CUDA kernel on the card) packs the state and
    the expander scatters the five outputs back. (The returned rng
    differs on lanes that died before a boundary: the plain loop keeps
    advancing their streams.)

Control flow per bounce, as in the reference integrator: miss -> env
radiance unless (bounce == 0 and envhidden); volume transmittance;
stochastic opacity skip (cap 128, bounce not consumed); first-hit AOVs;
one-sample MIS, 50/50 bsdf/light, balance heuristic; delta materials
bypass MIS; volume push/pop on transmission; in-volume scattering with
the same MIS; weight zero/non-finite break; Russian roulette after
bounce 3.

Intersectors: build_intersector routes a scene to an ops/traversal.py
Intersector (the dense, worklist, regroup, work-item or hybrid route;
lines and points merged by `curve_wrap`). Camera rays, and the light
pdf's march in scenes of more than lights.EXACT_ELEMS emissive elements
(`TraceOptions.light_pdf_extra_steps` closest-hit queries a body after
the bounce's own hit), go through its `primary`; under regroup that is
the worklist kernel, since the march's rays converge on the lights, as
camera rays leave one point.

Fixed-trip loop (`TraceOptions.fixed_iterations` > 0; render/diff.py
sets it): `body` runs exactly that many times, with no host-side liveness
test, no sort and no compaction, each step under
`torch.utils.checkpoint` (the JAX package's `jax.checkpoint` inside its
`lax.scan`), so the backward pass recomputes one bounce at a time, the
intersect kernel included. Sampled directions, pdfs and the Russian
roulette probability are detached, as the JAX package stops their
gradients (detached sampling), and the Intersector takes its
differentiable form (ops/diff_hit.py), whose hits carry the gradients of
the JAX package's argmin-selected hit (with curves, the quad route inside
`curve_wrap` is wrapped, and the line/point sweep differentiates as it
is; on instanced scenes the work-item hits are re-tested under their
instance's transform, and a hybrid's soup and work-item branches are
wrapped apart, then composed). The body is fully masked, so the radiance
equals the while loop's bit for bit.
"""

from __future__ import annotations

import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import _get_current_dispatch_mode

from julia_raytracer_tpu_torch.ops import bsdf as bsdf_ops
from julia_raytracer_tpu_torch.ops import eval as eval_ops
from julia_raytracer_tpu_torch.ops import lane_compact, shade_path
from julia_raytracer_tpu_torch.ops.dense_intersect import make_dense_intersect
from julia_raytracer_tpu_torch.ops.diff_hit import instanced_diff
from julia_raytracer_tpu_torch.ops.cluster_tables import PRIMS_PER_CLUSTER
from julia_raytracer_tpu_torch.ops.curve_intersect import (
    CurveBest, CurveTables, curve_intersect, upload as upload_curves,
)
from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, RAY_EPS, intersect_line, intersect_point, intersect_quad,
    quad_normal,
)
from julia_raytracer_tpu_torch.ops.instanced_intersect import (
    make_instanced_intersect,
)
from julia_raytracer_tpu_torch.ops.shade_path import ShadeOut
from julia_raytracer_tpu_torch.ops.traversal import (
    Hit, Intersector, intersect_bruteforce,
)
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import dispatch, lights as lights_mod
from julia_raytracer_tpu_torch.render.body_graphs import Kept
from julia_raytracer_tpu_torch.render.scene_device import DeviceScene, SceneConfig
from julia_raytracer_tpu_torch.utils import kernel_select
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.timing import counter, span
from julia_raytracer_tpu_torch.utils.vecmath import dot, normalize, orthonormalize

# dense-kernel cutoff: scenes with more quads go to the worklist
# intersector
BRUTEFORCE_THRESHOLD = 112
# narrowest wavefront that takes the two-phase dispatch
COMPACT_MIN = 16384
# heavy scenes: at or above this many quads build_intersector may take
# the regroup intersector for bounce rays (the JAX package's
# JRT_REGROUP_MIN default)
REGROUP_MIN_PRIMS = 150_000


class TraceOptions(NamedTuple):
    """Integrator options."""

    sampler: str = "path"  # "path" | "naive"
    bounces: int = 8
    envhidden: bool = False
    nocaustics: bool = False
    # closest-hit queries a body adds to the light pdf's march (scenes of
    # more than lights.EXACT_ELEMS emissive elements only)
    light_pdf_extra_steps: int = 2
    # > 0: the fixed-trip, differentiable loop of that many bodies
    # (module docstring; render/diff.py diff_options)
    fixed_iterations: int = 0
    # wavefront sort of camera and bounce rays (module docstring)
    sort_rays: bool = False
    # two-phase dispatch: survivors must fit width // compact_div before a
    # boundary; at most compact_levels boundaries. None: the JAX package's
    # defaults, 2 and 5 when sorting, 4 and 3 otherwise
    compact: bool = True
    compact_div: int | None = None
    compact_levels: int | None = None


class TraceVars(NamedTuple):
    """Per-lane loop state (45 int32 planes when packed)."""

    ro: torch.Tensor
    rd: torch.Tensor
    isec_hit: torch.Tensor
    isec_prim: torch.Tensor
    isec_u: torch.Tensor
    isec_v: torch.Tensor
    isec_t: torch.Tensor
    isec_pos: torch.Tensor
    isec_gn: torch.Tensor
    isec_inst: torch.Tensor
    radiance: torch.Tensor
    weight: torch.Tensor
    rng: torch.Tensor
    bounce: torch.Tensor
    opbounce: torch.Tensor
    alive: torch.Tensor
    hit_flag: torch.Tensor
    hit_albedo: torch.Tensor
    hit_normal: torch.Tensor
    max_roughness: torch.Tensor
    vol_density: torch.Tensor
    vol_scattering: torch.Tensor
    vol_aniso: torch.Tensor
    has_vol: torch.Tensor
    idx: torch.Tensor  # original lane id


# lanes x elements of one chunk of the line/point sweep, by device type:
# on the card, at 262,144 lanes, a chunk of 64 elements (64 MB a float32
# temporary, 201 MB a 3-vector one); on the CPU smaller chunks, whose
# temporaries stay in cache
CURVE_CHUNK = {"cuda": 1 << 24, "cpu": 1 << 20}


def _sweep_closest(test, n_elems: int, n: int, device):
    """First-minimum closest hit of an [n, n_elems] element test on
    `device`, swept in chunks of CURVE_CHUNK[device.type] // n elements:
    `test(lo, hi)` gives (hit, t, extras...) over elements [lo, hi), each
    [n, hi - lo]. Returns (index [n] i64, t [n], extras at the index); t
    is F32_MAX where no element hits. A later chunk wins only with a
    strictly smaller t, so ties keep the lower index, as one argmin over
    all elements does."""
    step = max(1, CURVE_CHUNK.get(device.type, CURVE_CHUNK["cuda"])
               // max(n, 1))
    best = None
    for lo in range(0, n_elems, step):
        hi = min(lo + step, n_elems)
        h, t, *extras = test(lo, hi)
        t = torch.where(h, t, F32_MAX)
        j = torch.argmin(t, dim=1, keepdim=True)  # first minimum
        cand = [lo + j[:, 0], t.gather(1, j)[:, 0]] + [
            e.gather(1, j)[:, 0] for e in extras]
        if best is None:
            best = cand
        else:
            take = cand[1] < best[1]
            best = [torch.where(take, c, b) for c, b in zip(cand, best)]
    return best


def sweep_curves(dscene: DeviceScene, config: SceneConfig, ro, rd, tmin,
                 bt) -> CurveBest:
    """The plain sweep of every line, then every point, as
    ops/curve_intersect.py CurveBest: the first minimum of t over the
    lines hit in [tmin, bt], then over the points hit in [tmin, bt'] (bt'
    the line's t where it is below bt), chunked by `_sweep_closest`. On a
    miss the index is 0 and t F32_MAX."""
    L, P = config.n_lines, config.n_points
    n, dev = ro.shape[0], ro.device
    none_i = torch.zeros(n, dtype=torch.int64, device=dev)
    none_t = torch.full((n,), F32_MAX, device=dev)
    li, ltb, s_, v_, pi, ptb = none_i, none_t, none_t, none_t, none_i, none_t
    ro_, rd_, tmin_ = ro[:, None], rd[:, None], tmin[:, None]
    if L > 0:
        lv, lr = dscene.line_verts, dscene.line_radius

        def test(lo, hi):
            h, s_, v_, t = intersect_line(
                ro_, rd_, tmin_, bt[:, None], lv[None, lo:hi, 0],
                lv[None, lo:hi, 1], lr[None, lo:hi, 0], lr[None, lo:hi, 1])
            return h, t, s_, v_

        li, ltb, s_, v_ = _sweep_closest(test, L, n, dev)
        bt = torch.where(ltb < bt, ltb, bt)
    if P > 0:
        pp, pr = dscene.point_pos, dscene.point_radius

        def test(lo, hi):
            return intersect_point(ro_, rd_, tmin_, bt[:, None],
                                   pp[None, lo:hi], pr[None, lo:hi])

        pi, ptb = _sweep_closest(test, P, n, dev)
    return CurveBest(li, ltb, s_, v_, pi, ptb)


def merge_curves(dscene: DeviceScene, config: SceneConfig, best: Hit, ro, rd,
                 tmin, tmax, tables: CurveTables | None = None) -> Hit:
    """The line/point merge of curve_wrap: `best` (the quad hit, or a miss)
    with the closest line, then the closest point, that the rays hit closer
    merged in. The closest line and point come from the culled walk
    (ops/curve_intersect.py) over `tables`, or from the plain sweep
    (sweep_curves) where `tables` is None; the two give the same hits bit
    for bit."""
    Q, L = dscene.prim_verts.shape[0], config.n_lines
    bt = torch.where(best.hit, best.t, tmax)
    if tables is None:
        c = sweep_curves(dscene, config, ro, rd, tmin, bt)
    else:
        c = curve_intersect(tables, ro, rd, tmin, bt)
    if L > 0:
        li, s_ = c.line.long().clamp(min=0), c.line_u
        upd = c.line_t < bt
        lp1, lp2 = dscene.line_verts[li, 0], dscene.line_verts[li, 1]
        axis_pt = lp1 + (lp2 - lp1) * s_[:, None]
        la = dscene.line_attr
        tan = normalize(la[li, 0, 0:3] * (1.0 - s_[:, None])
                        + la[li, 1, 0:3] * s_[:, None])
        up3 = upd[:, None]
        best = Hit(
            hit=best.hit | upd,
            prim=torch.where(upd, Q + li.to(torch.int32), best.prim),
            u=torch.where(upd, s_, best.u),
            v=torch.where(upd, c.line_v, best.v),
            t=torch.where(upd, c.line_t, best.t),
            position=torch.where(up3, axis_pt, best.position),
            gnormal=torch.where(up3, tan, best.gnormal),
            instance=torch.where(upd, dscene.line_instance[li], best.instance),
        )
        bt = torch.where(best.hit, best.t, tmax)
    if config.n_points > 0:
        pi = c.point.long().clamp(min=0)
        upd = c.point_t < bt
        up3 = upd[:, None]
        pp = dscene.point_pos
        best = Hit(
            hit=best.hit | upd,
            prim=torch.where(upd, Q + L + pi.to(torch.int32), best.prim),
            u=torch.where(upd, 0.0, best.u),
            v=torch.where(upd, 0.0, best.v),
            t=torch.where(upd, c.point_t, best.t),
            position=torch.where(up3, pp[pi], best.position),
            gnormal=torch.where(up3, -normalize(rd), best.gnormal),
            instance=torch.where(upd, dscene.point_instance[pi], best.instance),
        )
    return best


# device types whose curve route is the culled walk (ops/curve_intersect.py);
# the others sweep (sweep_curves)
CURVE_WALK_DEVICES = ("cuda",)


def curve_wrap(quads: Intersector | None, dscene: DeviceScene,
               config: SceneConfig) -> Intersector | None:
    """Merge line and point (capsule) primitives into the closest hits of
    the quad route `quads` (returned as it is for scenes without them).
    Curve hits are prim ids >= Q: Q..Q+L-1 lines, then points. Their
    `position` is the point on the line's axis, or the point's centre;
    `gnormal` carries the interpolated tangent of a line, or
    -normalize(rd) for a point, for the shading-normal rules. On a device
    of CURVE_WALK_DEVICES the lines and points go through the culled walk
    (merge_curves over ops/curve_intersect.py CurveTables, built here,
    once, and kept as the route's `curves`); elsewhere, and in the
    differentiable form, through the plain sweep of every element. Their
    tmax is the quad hit's t. With Q == 0 (`quads` None) no quad
    intersector is called. The merge keeps the quad route's tables,
    livegate and graph_safe (neither reads anything back), merges into its
    `primary` apart, and its differentiable form into the quad route's (a
    curve hit's prim id >= Q names no quad to re-test)."""
    if config.n_lines == 0 and config.n_points == 0:
        return quads
    device = dscene.line_verts.device
    tables = (upload_curves(dscene.line_verts, dscene.line_radius,
                            dscene.point_pos, dscene.point_radius, device)
              if device.type in CURVE_WALK_DEVICES else None)
    return _curve_route(quads, dscene, config, tables)


def _curve_route(quads: Intersector | None, dscene: DeviceScene,
                 config: SceneConfig, tables: CurveTables | None):
    """curve_wrap's Intersector over `tables` (None: the sweep)."""
    def merged(quad_fn):
        def intersect(ro, rd, tmin, tmax):
            if quad_fn is not None:
                best = quad_fn(ro, rd, tmin, tmax)
            else:
                n, dev = ro.shape[0], ro.device
                z = torch.zeros(n, device=dev)
                best = Hit(torch.zeros(n, dtype=torch.bool, device=dev),
                           torch.full((n,), -1, dtype=torch.int32, device=dev),
                           z, z, tmax, torch.zeros_like(ro),
                           torch.zeros_like(ro),
                           torch.zeros(n, dtype=torch.int32, device=dev))
            return merge_curves(dscene, config, best, ro, rd, tmin, tmax,
                                tables)

        return intersect

    if quads is None:
        return Intersector(
            merged(None), curves=tables,
            diff=lambda d: _curve_route(None, d, config, None))
    return Intersector(
        *quads.each(merged), graph_safe=quads.graph_safe,
        diff=lambda d: _curve_route(quads.differentiable(d), d, config, None),
        tables=quads.tables, livegate=quads.livegate, curves=tables)


def _host_prims(dscene: DeviceScene, config: SceneConfig):
    """Host copies of the sorted primitive arrays (no device readback
    when the config carries them). Flat scenes only: an instanced scene's
    prim_instance is a 1-element placeholder."""
    verts = config.host_prim_verts
    inst = config.host_prim_instance
    if verts is None:
        verts = dscene.prim_verts.cpu().numpy()
    if inst is None:
        inst = dscene.prim_instance.cpu().numpy()
    return verts, inst


def make_intersect_instanced_ref(dscene: DeviceScene, config: SceneConfig):
    """Plain reference intersector of an instanced scene (the tests'): a
    loop over the work items' instances, each ray moved into shape space
    and tested against every quad of the instance's shape (the reference
    semantics of a scene BVH over instances). O(instances x quads)."""
    tb = config.inst_tables
    verts = dscene.prim_verts  # shape space, cluster-padded concatenation
    rows = torch.as_tensor(tb.inst_rows, device=verts.device)
    pp_per_sup = tb.sup * PRIMS_PER_CLUSTER
    sup_off = np.asarray(tb.shape_sup_offset)
    groups, seen = [], set()  # (instance, prim range of its shape)
    for item in range(len(tb.wi_inst)):
        i = int(tb.wi_inst[item])
        if i in seen:
            continue
        seen.add(i)
        sid = int(np.searchsorted(sup_off, int(tb.wi_sup[item]), side="right") - 1)
        plo, phi = int(sup_off[sid]) * pp_per_sup, int(sup_off[sid + 1]) * pp_per_sup
        if phi > plo:
            groups.append((i, plo, phi))

    def intersect(ro, rd, tmin, tmax):
        n = ro.shape[0]
        z = torch.zeros(n, device=ro.device)
        best = Hit(torch.zeros(n, dtype=torch.bool, device=ro.device),
                   torch.full((n,), -1, dtype=torch.int32, device=ro.device),
                   z, z, tmax, ro + rd * tmax[:, None], torch.zeros_like(ro),
                   torch.zeros(n, dtype=torch.int32, device=ro.device))
        for i, plo, phi in groups:
            ri = rows[i, 0:9].reshape(3, 3)
            fw = rows[i, 12:21].reshape(3, 3)
            so = ro @ ri + rows[i, 9:12]
            sd = rd @ ri
            sv = verts[plo:phi]
            h, u, v, t = intersect_quad(
                so[:, None], sd[:, None], tmin[:, None],
                torch.minimum(tmax, best.t)[:, None],
                sv[None, :, 0], sv[None, :, 1], sv[None, :, 2], sv[None, :, 3],
            )
            tt = torch.where(h, t, F32_MAX)
            jbest = torch.argmin(tt, dim=1, keepdim=True)  # first minimum
            tbest = tt.gather(1, jbest)[:, 0]
            upd = tbest < best.t
            pb = plo + jbest[:, 0].to(torch.int32)
            vb = verts[pb]
            gn = quad_normal(vb[:, 0], vb[:, 1], vb[:, 2], vb[:, 3]) @ fw
            gl = torch.sqrt((gn * gn).sum(dim=-1, keepdim=True))
            gn = gn / torch.where(gl > 0, gl, 1.0)
            up3 = upd[:, None]
            best = Hit(
                hit=best.hit | upd,
                prim=torch.where(upd, pb, best.prim),
                u=torch.where(upd, u.gather(1, jbest)[:, 0], best.u),
                v=torch.where(upd, v.gather(1, jbest)[:, 0], best.v),
                t=torch.where(upd, tbest, best.t),
                position=torch.where(up3, ro + rd * tbest[:, None], best.position),
                gnormal=torch.where(up3, gn, best.gnormal),
                instance=torch.where(upd, i, best.instance),
            )
        return best

    return Intersector(intersect, diff=instanced_diff(intersect, rows))


def _check_regroup(regroup: str) -> None:
    if regroup not in ("auto", "on", "off"):
        raise ValueError(f"regroup={regroup!r}: one of 'auto', 'on', 'off'")


def _flat_intersector(verts, inst, device, n_prims, leaf, regroup,
                      regroup_min_prims, label, cache_key="") -> Intersector:
    """The intersector of a flat quad soup, routed as the JAX package
    routes one (integrator.py:471-538, and :199-248 for a hybrid soup):
    dense, regroup (by kernel_select under "auto", whose decision line is
    printed with `label`) or worklist; the cluster tables and the kernel
    choice through the disk cache under `cache_key`."""
    _check_regroup(regroup)
    if leaf or n_prims <= BRUTEFORCE_THRESHOLD:
        return make_dense_intersect(verts, inst, device)
    if n_prims >= regroup_min_prims and regroup != "off":
        livegate = None
        if regroup == "auto":
            sel = kernel_select.select_bounce_kernel(
                verts, inst, device=device, cache_key=cache_key)
            print(f"{label}: {sel['kernel']} (predicted "
                  f"regroup/worklist ratio {sel['ratio']}, threshold "
                  f"{sel['threshold']})", flush=True)
            if sel["kernel"] == "worklist":
                return wl.make_worklist_intersect(verts, inst, device,
                                                  cache_key=cache_key)
            if sel["ratio"] < 0.25:
                livegate = 0.2
        return rg.make_regroup_intersect(verts, inst, device, livegate=livegate,
                                         cache_key=cache_key)
    return wl.make_worklist_intersect(verts, inst, device, cache_key=cache_key)


def soup_cache_key(cache_key: str, wpv: np.ndarray) -> str:
    """The disk-cache key of a hybrid's world soup's tables and kernel
    choice: the scene's key and the soup's content (a sampled
    fingerprint), so different hybrid budgets never share tables (JAX
    integrator.py:204-212); "" when the scene has no key."""
    if not cache_key:
        return ""
    samp = wpv[:: max(1, len(wpv) // 1024)]
    fp = hashlib.sha1(np.ascontiguousarray(samp)).hexdigest()[:10]
    return f"{cache_key}:hybf{len(wpv)}-{fp}"


# the instanced branch of the hybrid only reports hits closer than the
# flat branch's best: its tmax is the flat t times this (float32)
HYBRID_T_CUT = float(np.float32(1.0000002))


def make_intersect_hybrid(dscene: DeviceScene, config: SceneConfig,
                          reference: bool = False, regroup: str = "auto",
                          regroup_min_prims: int = REGROUP_MIN_PRIMS):
    """Hybrid instanced intersector: the flattened world-space soup
    (config.hyb_world_verts) goes through the flat intersectors, the
    remaining work items through the work-item intersector with the flat
    branch's t as tmax; flat prim ids are remapped into the shared
    shape-space eval layout (config.hyb_remap), so shading is the same
    for both branches. `reference=True`: the plain references (the dense
    reference intersector and make_intersect_instanced_ref, as the JAX
    package composes off the TPU); otherwise the soup is routed by
    `_flat_intersector` (`regroup`, `regroup_min_prims` as in
    build_intersector) and the work items take
    ops/instanced_intersect.py, on the scene's device. `tables` is (the
    soup's, the work items'); `livegate` the soup's; `graph_safe` where
    both parts are (a soup through the dense kernel over the work-item
    kernels; not a worklist or regroup soup). The differentiable
    form composes the soup's over the world soup (a constant, as in the
    JAX package) with the work items' under their instance rows."""
    device = dscene.prim_verts.device
    wpv = np.asarray(config.hyb_world_verts)
    winst = np.asarray(config.hyb_world_inst)
    remap = torch.as_tensor(config.hyb_remap, device=device)
    has_items = len(config.inst_tables.wi_inst) > 0
    world_verts = functools.cache(lambda: torch.as_tensor(wpv, device=device))
    if reference:
        winst_d = torch.as_tensor(winst, device=device)
        soup = Intersector(lambda ro, rd, tmin, tmax: intersect_bruteforce(
            world_verts(), ro, rd, tmin, tmax, prim_instance=winst_d))
        items = (make_intersect_instanced_ref(dscene, config)
                 if has_items else None)
    else:
        soup = _flat_intersector(wpv, winst, device, len(wpv), False,
                                 regroup, regroup_min_prims,
                                 "hybrid flat kernel",
                                 soup_cache_key(config.cache_key, wpv))
        items = (make_instanced_intersect(config.inst_tables, device,
                                          instanced_diff)
                 if has_items else None)

    def compose(flat_fn, inst_fn):
        def intersect(ro, rd, tmin, tmax):
            h1 = flat_fn(ro, rd, tmin, tmax)
            prim1 = torch.where(h1.hit, remap[h1.prim.clamp(min=0).long()], -1)
            if inst_fn is None:
                return h1._replace(prim=prim1)
            t_cut = torch.where(h1.hit, h1.t * HYBRID_T_CUT, tmax)
            h2 = inst_fn(ro, rd, tmin, torch.minimum(tmax, t_cut))
            take = h2.hit
            hit = h1.hit | take

            def sel(a, b):
                return torch.where(take if a.dim() == 1 else take[:, None], a, b)

            return Hit(
                hit=hit, prim=sel(h2.prim, prim1), u=sel(h2.u, h1.u),
                v=sel(h2.v, h1.v),
                t=torch.where(hit, sel(h2.t, h1.t), tmax),
                position=sel(h2.position, h1.position),
                gnormal=sel(h2.gnormal, h1.gnormal),
                instance=sel(h2.instance, h1.instance),
            )

        return intersect

    def diff(d):
        flat = soup.differentiable(d._replace(prim_verts=world_verts()))
        inst = items.differentiable(d).hit if items else None
        return Intersector(*flat.each(lambda f: compose(f, inst)))

    return Intersector(
        *soup.each(lambda f: compose(f, items.hit if items else None)),
        graph_safe=soup.graph_safe and (items is None or items.graph_safe),
        diff=diff,
        tables=(soup.tables, items.tables if items else None),
        livegate=soup.livegate)


def make_intersect(dscene: DeviceScene, config: SceneConfig) -> Intersector:
    """Closest-hit query of the plain versions, the reference the tests
    hold the intersectors to, for a scene on the CPU: the dense reference
    intersector (ops/traversal.py intersect_bruteforce) for <= 112 quads,
    else the worklist intersector's plain version (the JAX package walks
    its BVH there, ops/traversal.py intersect_bvh; both are exact
    closest-hit queries), with lines and points merged by curve_wrap.
    Instanced scenes: make_intersect_instanced_ref, or the hybrid over the
    plain references. A scene on the card takes build_intersector."""
    if dscene.prim_verts.device.type != "cpu":
        raise ValueError(
            "make_intersect is the plain reference for a scene on the CPU; "
            "use build_intersector for a scene on "
            f"{dscene.prim_verts.device}"
        )
    if config.inst_tables is not None:
        if config.hyb_world_verts is not None:
            return make_intersect_hybrid(dscene, config, reference=True)
        return make_intersect_instanced_ref(dscene, config)
    if config.root_is_leaf or config.n_prims <= BRUTEFORCE_THRESHOLD:
        def intersect(ro, rd, tmin, tmax):
            return intersect_bruteforce(
                dscene.prim_verts, ro, rd, tmin, tmax,
                prim_instance=dscene.prim_instance,
            )
    else:
        tables = wl.pack_tables(*_host_prims(dscene, config))

        def intersect(ro, rd, tmin, tmax):
            order, cnt = wl.precull(ro, rd, tmin, tmax, tables.sbbox)
            return wl.worklist_intersect_plain(tables, ro, rd, tmin, tmax,
                                               order, cnt)[0]
    return curve_wrap(Intersector(intersect), dscene, config)


def build_intersector(dscene: DeviceScene, config: SceneConfig,
                      regroup: str = "auto",
                      regroup_min_prims: int = REGROUP_MIN_PRIMS):
    """The scene's Intersector, on the device the scene lives on (the
    kernels for a scene on the card, their plain versions for one on the
    CPU), routed as the JAX package routes a scene (integrator.py:443-538):
      - instanced scenes: the hybrid (make_intersect_hybrid) when the build
        flattened a world-space soup, else the work-item intersector
        (ops/instanced_intersect.py);
      - <= 112 quads (or a leaf root): the dense kernel
        (ops/dense_intersect.py);
      - >= `regroup_min_prims` quads (150,000; was JRT_REGROUP_MIN) and
        `regroup` (was JRT_REGROUP) "on": the regroup intersector
        (ops/regroup_intersect.py) for bounce rays, its `primary` (the
        worklist kernel over the same tables) for camera rays; "auto"
        takes it only when utils/kernel_select.py predicts a decisive win
        (and then, below a predicted ratio of 0.25, with the lower
        liveness gate 0.2), and prints the decision line; "off" keeps the
        worklist kernel;
      - otherwise the worklist cluster kernel (ops/worklist_intersect.py).
    Regroup is only a speed choice over the same closest hits. Flat
    scenes with lines or points take curve_wrap around the above (no
    quad intersector when the scene has no quads)."""
    _check_regroup(regroup)
    device = dscene.prim_verts.device
    if config.inst_tables is not None:
        if config.hyb_world_verts is not None:
            return make_intersect_hybrid(dscene, config, regroup=regroup,
                                         regroup_min_prims=regroup_min_prims)
        return make_instanced_intersect(config.inst_tables, device,
                                        instanced_diff)
    if config.n_prims == 0:
        # only lines and points: curve_wrap never calls the quad intersector
        return curve_wrap(None, dscene, config)
    verts, inst = _host_prims(dscene, config)
    return curve_wrap(
        _flat_intersector(verts, inst, device, config.n_prims,
                          config.root_is_leaf, regroup, regroup_min_prims,
                          "bounce kernel", config.cache_key),
        dscene, config)


def _vec(mask):
    return mask[..., None]


def _live_lanes(alive) -> int:
    """The loop test: the number of live lanes, read back to the host (one
    synchronization)."""
    with span("loop_test"):
        trace_wavefront.host_syncs += 1
        return int(alive.sum())


def _spread3(x):
    """Spread 10 bits to every 3rd bit (morton interleave helper), int32."""
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _to_int32(x):
    """float -> int32 with NaN -> 0, as XLA converts."""
    return torch.where(torch.isnan(x), 0.0, x).to(torch.int32)


def _morton3(pos, vmin, vmax):
    """[N,3] world position -> 30-bit morton key (10 bits/axis), int32."""
    scale = 1023.0 / torch.clamp(vmax - vmin, min=1e-30)
    q = _to_int32(torch.clamp((pos - vmin) * scale, 0.0, 1023.0))
    return (_spread3(q[..., 0]) | (_spread3(q[..., 1]) << 1)
            | (_spread3(q[..., 2]) << 2))


def _sort_key(ro, rd, vmin, vmax):
    """Wavefront coherence key, int32: octant(3) | origin-morton(18) |
    direction-morton(9), 30 bits (JAX integrator.py:566-592). The origin
    bits keep each block's footprint compact; the direction bits turn
    equal-origin camera blocks into image tiles."""
    octant = (((rd[:, 0] < 0).to(torch.int32) << 2)
              | ((rd[:, 1] < 0).to(torch.int32) << 1)
              | (rd[:, 2] < 0).to(torch.int32))
    om = _morton3(ro, vmin, vmax) >> 12  # top 18 bits
    qd = _to_int32(torch.clamp(torch.abs(rd) * 7.999, 0.0, 7.0))
    dm = (_spread3(qd[:, 0]) | (_spread3(qd[:, 1]) << 1)
          | (_spread3(qd[:, 2]) << 2))  # 9 bits (3/axis)
    return (octant << 27) | (om << 9) | dm


def sort_bounds(dscene: DeviceScene, config: SceneConfig):
    """(lo [3], hi [3]) of the scene, the box the sort key quantises in:
    the build's world bounds for an instanced scene (its prim arrays are
    shape space), else those of the prims."""
    if config.world_bounds is not None:
        return tuple(torch.as_tensor(np.asarray(b, np.float32),
                                     device=dscene.prim_verts.device)
                     for b in config.world_bounds)
    pv = dscene.prim_verts.reshape(-1, 3)
    return pv.amin(dim=0), pv.amax(dim=0)


def _take(xs, perm):
    """x[perm] for each lane-shaped tensor of `xs`, and for each field of
    a NamedTuple among them."""
    return [type(x)(*(f[perm] for f in x)) if isinstance(x, tuple)
            else x[perm] for x in xs]


class Bounce(NamedTuple):
    """What a bounce reads besides the lane state: the scene, its config,
    the options, the fixed-trip loop's trip count (0: the while loop), the
    sort's scene box (sort_bounds; None: unsorted) and the route's
    `primary` intersect, which the light pdf's march takes."""

    dscene: DeviceScene
    config: SceneConfig
    options: TraceOptions
    fixed: int
    sort_box: tuple | None
    primary: object


def eager_bounce(b: Bounce, s: TraceVars, query) -> TraceVars:
    """One bounce of the lane state `s`, in the module docstring's control
    flow: the shading of the current hit, the next ray (sorted where
    `b.sort_box` is set), `query(ro, rd, tmin, tmax) -> Hit` for its hit,
    then the weight update. Width-polymorphic: the two-phase dispatch
    re-enters with a narrowed state, so lane-shaped constants derive from
    the state."""
    dscene, config, options, fixed = b.dscene, b.config, b.options, b.fixed
    do_sort = b.sort_box is not None
    if do_sort:
        scene_vmin, scene_vmax = b.sort_box
    is_path = options.sampler == "path"
    counts = config.light_counts
    has_lights = counts.total > 0
    present = config.present_types
    n_prim = dscene.prim_verts.shape[0]
    n_inst = dscene.inst_frame.shape[0]
    dev = s.alive.device

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    n = s.alive.shape[0]
    alive = s.alive
    bounce = torch.where(alive, s.bounce + 1, s.bounce)
    rng = s.rng
    radiance, weight = s.radiance, s.weight
    outgoing = -s.rd

    # ---- miss: environment lookup
    miss = alive & ~s.isec_hit
    if config.n_envs > 0:
        env_ok = (bounce > 0) if options.envhidden else full((n,), True, torch.bool)
        env = eval_ops.eval_environment(dscene, s.rd)
        radiance = radiance + torch.where(_vec(miss & env_ok), weight * env, 0.0)
    alive = alive & s.isec_hit

    # ---- volume transmittance
    if is_path and config.has_volumes:
        in_med = alive & s.has_vol
        rl, rng = rng_mod.rand1f(rng)
        rdist, rng = rng_mod.rand1f(rng)
        dist = bsdf_ops.sample_transmittance(s.vol_density, s.isec_t, rl, rdist)
        trans = bsdf_ops.eval_transmittance(s.vol_density, dist)
        tpdf = bsdf_ops.sample_transmittance_pdf(
            s.vol_density, dist, s.isec_t).detach()  # JAX integrator.py:746
        weight = torch.where(
            _vec(in_med),
            weight * trans / torch.clamp(tpdf, min=1e-30)[..., None],
            weight,
        )
        in_volume = in_med & (dist < s.isec_t)
    else:
        in_volume = full((n,), False, torch.bool)
        dist = s.isec_t

    surf = alive & ~in_volume

    # ---- surface evaluation; position and element normal come from
    # the intersector
    prim = s.isec_prim.clamp(0, max(n_prim - 1, 0))
    # slack lanes of a packed state hold unspecified bits: clamp ids
    # before they index a table
    inst = s.isec_inst.clamp(0, n_inst - 1)
    u, v = s.isec_u, s.isec_v
    position = s.isec_pos
    need_attrs = (
        config.has_texcoords or config.has_colors
        or config.has_vertex_normals or config.has_normal_maps
    )
    if need_attrs:
        vidx = dscene.prim_vidx[prim]
        flags = dscene.prim_flags[prim]
    else:
        vidx = flags = None
    verts = dscene.prim_verts[prim] if config.has_normal_maps else None
    if config.has_texcoords:
        texcoord = eval_ops.eval_texcoord(dscene, vidx, flags, u, v)
    else:
        texcoord = torch.stack([u, v], dim=-1)
    if config.has_colors:
        shp_color = eval_ops.eval_color_attr(dscene, vidx, flags, u, v)
    else:
        shp_color = full(u.shape + (4,), 1.0)
    # curve attribute overrides (prim ids >= Q: lines, then points)
    has_curves = config.n_lines > 0 or config.n_points > 0
    if has_curves:
        is_line = (s.isec_hit & (s.isec_prim >= n_prim)
                   & (s.isec_prim < n_prim + config.n_lines))
        is_point = s.isec_hit & (s.isec_prim >= n_prim + config.n_lines)
        if config.n_lines > 0:
            lat = dscene.line_attr[
                (s.isec_prim - n_prim).clamp(0, config.n_lines - 1)]
            wu = u[:, None]
            l_tc = lat[:, 0, 3:5] * (1.0 - wu) + lat[:, 1, 3:5] * wu
            l_col = lat[:, 0, 5:9] * (1.0 - wu) + lat[:, 1, 5:9] * wu
            texcoord = torch.where(_vec(is_line), l_tc, texcoord)
            shp_color = torch.where(_vec(is_line), l_col, shp_color)
        if config.n_points > 0:
            pat = dscene.point_attr[(s.isec_prim - n_prim - config.n_lines)
                                    .clamp(0, config.n_points - 1)]
            texcoord = torch.where(_vec(is_point), pat[:, 3:5], texcoord)
            shp_color = torch.where(_vec(is_point), pat[:, 5:9], shp_color)
    # folded per-instance material rows for small scenes; not in the
    # fixed-trip loop, whose gradients flow to dscene.materials (JAX
    # integrator.py:812)
    dense_mats = 0 < config.n_instances <= 64 and not fixed
    if dense_mats and not config.has_textures:
        material = eval_ops.eval_material_dense(dscene, inst, shp_color)
        normal_tex = full((n,), -1, torch.int32)
    elif dense_mats:
        rows = dscene.inst_mat_dense[inst]
        material = eval_ops.eval_material_rows(dscene, rows, texcoord, shp_color)
        normal_tex = rows[..., 20].to(torch.int32)
    else:
        material = eval_ops.eval_material(dscene, inst, texcoord, shp_color)
        normal_tex = dscene.materials.normal_tex[dscene.inst_material[inst]]
    normal = eval_ops.eval_shading_normal(
        dscene, s.isec_gn, verts, vidx, inst, flags, u, v, outgoing,
        material.type, normal_tex, texcoord,
        with_normalmap=config.has_normal_maps,
        with_vertex_normals=config.has_vertex_normals,
        refractive_present=4 in present,
        instanced=config.inst_tables is not None,
    )
    if has_curves:
        # lines: the tangent framed against the view; points: the
        # normal is the outgoing direction
        if config.n_lines > 0:
            normal = torch.where(
                _vec(is_line), orthonormalize(outgoing, s.isec_gn), normal)
        if config.n_points > 0:
            normal = torch.where(_vec(is_point), outgoing, normal)

    max_roughness = s.max_roughness
    if is_path and options.nocaustics:
        # clamp roughness to the running max
        max_roughness = torch.where(
            surf, torch.maximum(material.roughness, max_roughness),
            max_roughness,
        )
        material = material._replace(
            roughness=torch.where(surf, max_roughness, material.roughness)
        )

    # ---- stochastic opacity
    if config.has_opacity:
        r_op, rng = rng_mod.rand1f(rng)
        op_skip = surf & (material.opacity < 1.0) & (r_op >= material.opacity)
        op_dead = op_skip & (s.opbounce > 128)
        alive = alive & ~op_dead
        op_skip = op_skip & ~op_dead
        opbounce = torch.where(op_skip, s.opbounce + 1, s.opbounce)
        bounce = torch.where(op_skip, bounce - 1, bounce)
        surf = surf & ~op_skip
    else:
        op_skip = full((n,), False, torch.bool)
        opbounce = s.opbounce

    # ---- first-hit AOVs
    first = surf & (bounce == 0)
    hit_flag = s.hit_flag | first
    hit_albedo = torch.where(_vec(first), material.color, s.hit_albedo)
    hit_normal = torch.where(_vec(first), normal, s.hit_normal)

    # ---- emission
    radiance = radiance + torch.where(
        _vec(surf), weight * eval_ops.eval_emission(material, normal, outgoing),
        0.0,
    )

    # ---- direction sampling
    r_half, rng = rng_mod.rand1f(rng)
    rnl, rng = rng_mod.rand1f(rng)
    rn, rng = rng_mod.rand2f(rng)
    if is_path and has_lights:
        rl_pick, rng = rng_mod.rand1f(rng)
        rl_el, rng = rng_mod.rand1f(rng)
        rl_uv, rng = rng_mod.rand2f(rng)

    delta = eval_ops.is_delta(material)
    bsdf_dir = dispatch.sample_bsdfcos(
        material, normal, outgoing, rnl, rn, present=present
    )
    d_incoming = dispatch.sample_delta(
        material, normal, outgoing, rnl, present=present
    )
    if is_path:
        if has_lights:
            light_dir = lights_mod.sample_lights(
                dscene, dscene.lights, counts, position, rl_pick, rl_el, rl_uv
            )
            nd_incoming = torch.where(_vec(r_half < 0.5), bsdf_dir, light_dir)
        else:
            nd_incoming = torch.where(_vec(r_half < 0.5), bsdf_dir, 0.0)
        incoming = torch.where(_vec(delta), d_incoming, nd_incoming)
    else:
        # naive: bsdf-importance only; rough-vs-delta on roughness != 0
        rough = material.roughness != 0.0
        incoming = torch.where(_vec(rough), bsdf_dir, d_incoming)
        delta = ~rough
    # detached sampling: sampled directions are not differentiated
    # (JAX integrator.py:926)
    incoming = incoming.detach()

    zero_inc = surf & (torch.abs(incoming).sum(dim=-1) == 0.0)
    alive = alive & ~zero_inc
    surf = surf & ~zero_inc

    # ---- volume scatter direction
    vol = alive & in_volume
    if is_path and config.has_volumes:
        vol_position = s.ro + s.rd * dist[..., None]
        phase_dir = dispatch.sample_scattering(
            s.vol_density, s.vol_aniso, outgoing, rn
        )
        if has_lights:
            vol_light_dir = lights_mod.sample_lights(
                dscene, dscene.lights, counts, vol_position, rl_pick,
                rl_el, rl_uv,
            )
            vol_incoming = torch.where(
                _vec(r_half < 0.5), phase_dir, vol_light_dir
            )
        else:
            vol_incoming = phase_dir
        vol_incoming = vol_incoming.detach()  # JAX integrator.py:943
        vol_zero = vol & (torch.abs(vol_incoming).sum(dim=-1) == 0.0)
        alive = alive & ~vol_zero
        vol = vol & ~vol_zero
    else:
        vol_position = position
        vol_incoming = incoming

    # ---- next ray (opacity skips continue straight)
    new_ro = torch.where(
        _vec(op_skip),
        position + s.rd * 0.01,
        torch.where(_vec(vol), vol_position, position),
    )
    new_rd = torch.where(
        _vec(op_skip), s.rd, torch.where(_vec(vol), vol_incoming, incoming)
    )

    # ---- wavefront sort before the traversal: lanes ordered by
    # (liveness, octant, morton); dead lanes go to the tail
    vol_density, vol_scattering = s.vol_density, s.vol_scattering
    vol_aniso, has_vol, idx = s.vol_aniso, s.has_vol, s.idx
    if do_sort:
        key = _sort_key(new_ro, new_rd, scene_vmin, scene_vmax)
        key = torch.where(alive, key, 0x7FFFFFFF)
        perm = torch.argsort(key, stable=True)
        (new_ro, new_rd, material, normal, outgoing, incoming,
         vol_incoming, delta, surf, vol, op_skip, weight, radiance, rng,
         bounce, opbounce, alive, hit_flag, hit_albedo, hit_normal,
         max_roughness, vol_density, vol_scattering, vol_aniso, has_vol,
         idx) = _take(
            (new_ro, new_rd, material, normal, outgoing, incoming,
             vol_incoming, delta, surf, vol, op_skip, weight, radiance,
             rng, bounce, opbounce, alive, hit_flag, hit_albedo,
             hit_normal, max_roughness, vol_density, vol_scattering,
             vol_aniso, has_vol, idx), perm)

    # ---- ONE traversal: the next bounce's hit. Dead lanes carry
    # tmax = -1 so every test against them fails.
    tmax = torch.where(alive, F32_MAX, -1.0)
    nxt = query(new_ro, new_rd, full((n,), RAY_EPS), tmax)

    # ---- weight updates
    if is_path:
        # the march (more than EXACT_ELEMS emissive elements) reuses
        # this bounce's hit as its first step and re-traces through
        # the primary intersector
        lights_pdf = (
            lights_mod.sample_lights_pdf(
                dscene, dscene.lights, counts, new_ro, new_rd,
                intersect_fn=b.primary, first_hit=nxt,
                extra_steps=options.light_pdf_extra_steps,
            )
            if has_lights
            else full((n,), 0.0)
        )
        # non-delta surface MIS
        f_nd = dispatch.eval_bsdfcos(
            material, normal, outgoing, incoming, present=present
        )
        pdf_b = dispatch.sample_bsdfcos_pdf(
            material, normal, outgoing, incoming, present=present
        )
        # pdfs are detached: the sampling measure is not
        # differentiated (JAX integrator.py:1032, :1038, :1053)
        denom_nd = (0.5 * pdf_b + 0.5 * lights_pdf).detach()
        w_nd = f_nd / torch.clamp(denom_nd, min=1e-30)[..., None]
        # delta
        f_d = dispatch.eval_delta(
            material, normal, outgoing, incoming, present=present
        )
        pdf_d = dispatch.sample_delta_pdf(
            material, normal, outgoing, incoming, present=present
        ).detach()
        w_d = f_d / torch.clamp(pdf_d, min=1e-30)[..., None]
        w_surf = torch.where(_vec(delta), w_d, w_nd)
        if config.has_volumes:
            # in-volume MIS
            f_v = dispatch.eval_scattering(
                vol_scattering, vol_density, vol_aniso, outgoing,
                vol_incoming,
            )
            pdf_v = dispatch.sample_scattering_pdf(
                vol_density, vol_aniso, outgoing, vol_incoming
            )
            denom_v = (0.5 * pdf_v + 0.5 * lights_pdf).detach()
            w_vol = f_v / torch.clamp(denom_v, min=1e-30)[..., None]
            weight = torch.where(
                _vec(surf), weight * w_surf,
                torch.where(_vec(vol), weight * w_vol, weight),
            )
        else:
            weight = torch.where(_vec(surf), weight * w_surf, weight)
    else:
        f_r = dispatch.eval_bsdfcos(
            material, normal, outgoing, incoming, present=present
        )
        pdf_r = dispatch.sample_bsdfcos_pdf(
            material, normal, outgoing, incoming, present=present
        ).detach()  # JAX integrator.py:1073
        f_d = dispatch.eval_delta(
            material, normal, outgoing, incoming, present=present
        )
        pdf_d = dispatch.sample_delta_pdf(
            material, normal, outgoing, incoming, present=present
        ).detach()  # JAX integrator.py:1074
        w_r = f_r / torch.clamp(pdf_r, min=1e-30)[..., None]
        w_d = f_d / torch.clamp(pdf_d, min=1e-30)[..., None]
        weight = torch.where(
            _vec(surf), weight * torch.where(_vec(delta), w_d, w_r), weight
        )

    # ---- volume stack push/pop
    if is_path and config.has_volumes:
        transmitted = (
            eval_ops.is_volumetric_type(material.type)
            & (dot(normal, outgoing) * dot(normal, incoming) < 0)
            & surf
        )
        push = transmitted & ~has_vol
        pop = transmitted & has_vol
        vol_density = torch.where(_vec(push), material.density, vol_density)
        vol_scattering = torch.where(
            _vec(push), material.scattering, vol_scattering
        )
        vol_aniso = torch.where(push, material.scanisotropy, vol_aniso)
        has_vol = (has_vol | push) & ~pop

    # ---- weight zero / non-finite break
    stepped = (surf | vol) & alive
    w_zero = torch.abs(weight).sum(dim=-1) == 0.0
    w_bad = ~torch.isfinite(weight).all(dim=-1)
    alive = alive & ~(stepped & (w_zero | w_bad))

    # ---- Russian roulette
    r_rr, rng = rng_mod.rand1f(rng)
    rr_lane = stepped & alive & (bounce > 3)
    # detached (JAX integrator.py:1107)
    rr_prob = torch.clamp(weight.amax(dim=-1), max=0.99).detach()
    rr_die = rr_lane & (r_rr >= rr_prob)
    alive = alive & ~rr_die
    weight = torch.where(
        _vec(rr_lane & ~rr_die),
        weight / torch.clamp(rr_prob, min=1e-30)[..., None],
        weight,
    )

    # ---- loop condition (while bounce < bounces)
    alive = alive & (bounce < options.bounces)

    return TraceVars(
        ro=new_ro, rd=new_rd,
        isec_hit=nxt.hit, isec_prim=nxt.prim, isec_u=nxt.u,
        isec_v=nxt.v, isec_t=nxt.t, isec_pos=nxt.position,
        isec_gn=nxt.gnormal, isec_inst=nxt.instance,
        radiance=radiance, weight=weight, rng=rng, bounce=bounce,
        opbounce=opbounce, alive=alive, hit_flag=hit_flag,
        hit_albedo=hit_albedo, hit_normal=hit_normal,
        max_roughness=max_roughness, vol_density=vol_density,
        vol_scattering=vol_scattering, vol_aniso=vol_aniso,
        has_vol=has_vol, idx=idx,
    )


def _miss(ro, tmax) -> Hit:
    """A miss of every ray of `ro`: shade_plain's stand-in for a hit."""
    n, dev = ro.shape[0], ro.device
    z = torch.zeros(n, device=dev)
    return Hit(torch.zeros(n, dtype=torch.bool, device=dev),
               torch.full((n,), -1, dtype=torch.int32, device=dev), z, z, tmax,
               torch.zeros_like(ro), torch.zeros_like(ro),
               torch.zeros(n, dtype=torch.int32, device=dev))


def shade_plain(b: Bounce, s: TraceVars) -> ShadeOut:
    """The eager bounce's shading, the plain version of csrc/shade_path.cu
    (ops/shade_path.py): `eager_bounce` with a stand-in for its intersect
    that keeps the query (the next ray, tmin, tmax) and reports a miss. On
    the traces that shade_route covers the weight update reads nothing of
    the hit (the light pdf is the exact sweep), so the fields are the
    bounce's."""
    kept = []

    def query(ro, rd, tmin, tmax):
        kept.append((ro, rd, tmin, tmax))
        return _miss(ro, tmax)

    out = eager_bounce(b, s, query)
    return ShadeOut(*kept[0], out.radiance, out.weight, out.rng, out.bounce,
                    out.alive, out.hit_flag, out.hit_albedo, out.hit_normal)


# device types on which shade_route may take the shading kernel
SHADE_PATH_DEVICES = ("cuda",)


def shade_route(device, config: SceneConfig, options: TraceOptions) -> bool:
    """Whether a trace shades its bodies in one kernel (ops/shade_path.py,
    csrc/shade_path.cu) and not in the eager bounce: on a device of
    SHADE_PATH_DEVICES, the path sampler's while loop, unsorted, without
    nocaustics, on a scene with instances and with no environment,
    volume, opacity, texture, normal map or vertex normal, at most
    lights.EXACT_ELEMS emissive elements (the light pdf's exact sweep,
    which reads the next ray and not its hit) and only matte and glossy
    materials (no delta lobe on any lane). Vertex texcoords are then
    unused and vertex colours are covered."""
    return (device.type in SHADE_PATH_DEVICES
            and options.sampler == "path" and not options.fixed_iterations
            and not options.sort_rays and not options.nocaustics
            and config.n_instances > 0 and config.n_envs == 0
            and not config.has_volumes and not config.has_opacity
            and not config.has_textures and not config.has_normal_maps
            and not config.has_vertex_normals
            and config.light_counts.total_inst_elems <= lights_mod.EXACT_ELEMS
            and set(config.present_types) <= {0, 1})



def trace_wavefront(dscene: DeviceScene, config: SceneConfig,
                    options: TraceOptions, ro, rd, rng_state,
                    intersector: Intersector | None = None, graphs=None):
    """Trace a batch of rays to completion.

    Returns (radiance [N,3], hit [N] bool, albedo [N,3], normal [N,3],
    rng_state [N] int32). `intersector` may be prebuilt; by default
    build_intersector's, on the scene's device (the kernels for a scene on
    the card, their plain versions for one on the CPU). With
    `options.fixed_iterations` the loop is the fixed-trip, differentiable
    one (module docstring), over the Intersector's differentiable form.
    `graphs`: the caller's BodyGraphs, which replays the while loop's
    bodies from CUDA graphs where render/body_graphs.py allows it; without
    it every body is issued eagerly."""
    with span("wavefront"):
        return _trace(dscene, config, options, ro, rd, rng_state, intersector,
                      graphs)


def _trace(dscene, config, options, ro, rd, rng_state, intersector, graphs):
    fixed = options.fixed_iterations
    n = ro.shape[0]
    dev = ro.device
    if intersector is None:
        intersector = build_intersector(dscene, config)
    if graphs is not None:
        graphs = graphs.for_trace(dev, fixed, dscene, config, options,
                                  intersector)
    if fixed:
        intersector = intersector.differentiable(dscene)
    do_sort = options.sort_rays and not fixed
    sort_box = None

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    with span("primary_hit"):
        idx0 = torch.arange(n, dtype=torch.int32, device=dev)
        if do_sort:
            sort_box = sort_bounds(dscene, config)
            # camera rays arrive in scanline order: sort them too
            perm0 = torch.argsort(_sort_key(ro, rd, *sort_box), stable=True)
            ro, rd, rng_state, idx0 = (x[perm0]
                                       for x in (ro, rd, rng_state, idx0))
        h0 = intersector.primary(ro, rd, full((n,), RAY_EPS),
                                 full((n,), F32_MAX))
    zeros3 = full((n, 3), 0.0)
    state = TraceVars(
        ro=ro, rd=rd,
        isec_hit=h0.hit, isec_prim=h0.prim, isec_u=h0.u, isec_v=h0.v,
        isec_t=h0.t, isec_pos=h0.position, isec_gn=h0.gnormal,
        isec_inst=h0.instance,
        radiance=zeros3, weight=full((n, 3), 1.0), rng=rng_state,
        bounce=full((n,), -1, torch.int32),
        opbounce=full((n,), 0, torch.int32),
        alive=full((n,), True, torch.bool),
        hit_flag=full((n,), False, torch.bool),
        hit_albedo=zeros3, hit_normal=zeros3,
        max_roughness=full((n,), 0.0),
        vol_density=zeros3, vol_scattering=zeros3,
        vol_aniso=full((n,), 0.0),
        has_vol=full((n,), False, torch.bool),
        idx=idx0,
    )

    b = Bounce(dscene, config, options, fixed, sort_box, intersector.primary)
    # the shading kernel's route, chosen once a trace; under a
    # TorchDispatchMode (utils/roofline.py count_cost) the eager bounce,
    # whose ops the mode counts
    fused = (shade_route(dev, config, options)
             and _get_current_dispatch_mode() is None)
    tables = shade_path.make_tables(dscene, config, options) if fused else None
    plain = functools.partial(shade_plain, b)

    def query(ro, rd, tmin, tmax):
        with span("intersect"):
            return intersector.hit(ro, rd, tmin, tmax)

    def bounce_step(s: TraceVars) -> TraceVars:
        if not fused:
            return eager_bounce(b, s, query)
        sh = shade_path.shade_path(tables, s, plain)
        nxt = query(sh.ro, sh.rd, sh.tmin, sh.tmax)
        return TraceVars(
            ro=sh.ro, rd=sh.rd,
            isec_hit=nxt.hit, isec_prim=nxt.prim, isec_u=nxt.u,
            isec_v=nxt.v, isec_t=nxt.t, isec_pos=nxt.position,
            isec_gn=nxt.gnormal, isec_inst=nxt.instance,
            radiance=sh.radiance, weight=sh.weight, rng=sh.rng,
            bounce=sh.bounce, opbounce=s.opbounce, alive=sh.alive,
            hit_flag=sh.hit_flag, hit_albedo=sh.hit_albedo,
            hit_normal=sh.hit_normal, max_roughness=s.max_roughness,
            vol_density=s.vol_density, vol_scattering=s.vol_scattering,
            vol_aniso=s.vol_aniso, has_vol=s.has_vol, idx=s.idx,
        )

    def body(s: TraceVars, live: int | None = None) -> TraceVars:
        """One bounce in a `body` span; `live`: the live lanes the loop
        test read before it (none in the fixed-trip loop, which `graphs`
        never replays)."""
        if live is None:
            with span("body"):
                return bounce_step(s)
        with span("body", live=live, width=s.alive.shape[0],
                  graphed=0, shaded=int(fused)) as sp:
            if graphs is None:
                return bounce_step(s)
            s, graphed = graphs.run(bounce_step, s)
            sp.counts["graphed"] = int(graphed)
            return s

    def outputs(s: TraceVars):
        return [s.radiance, s.hit_flag, s.hit_albedo, s.hit_normal, s.rng]

    # states that outlive later bodies, and the trace's outputs, leave
    # the graphs' buffers
    keep = Kept if graphs is None else graphs.keep
    finish = tuple if graphs is None else graphs.release

    def run(s: TraceVars) -> TraceVars:
        while live := _live_lanes(s.alive):
            s = body(s, live)
        return s

    if fixed:
        # no liveness test, sort or compaction; each step recomputed in
        # the backward pass (JAX integrator.py:1160-1164)
        grad = torch.is_grad_enabled()
        for _ in range(fixed):
            state = (torch.utils.checkpoint.checkpoint(
                body, state, use_reentrant=False, preserve_rng_state=False)
                if grad else body(state))
        return tuple(outputs(state))

    def drain(s: TraceVars, cap: int) -> tuple[TraceVars, int]:
        """Bodies until at most `cap` lanes live: the state and its live
        lanes."""
        while (live := _live_lanes(s.alive)) > cap:
            s = body(s, live)
        return s, live

    def unsort(outs, idx):
        if not do_sort:
            return finish(outs)
        with span("unsort"):
            lane = idx.long()
            res = []
            for a in outs:
                out = torch.empty_like(a)
                out[lane] = a
                res.append(out)
            return tuple(res)

    div = options.compact_div or (2 if do_sort else 4)
    # instanced scenes stop at 3 levels, as in the JAX package
    levels = options.compact_levels or (
        5 if do_sort and config.inst_tables is None else 3)

    def phase_cap(width):
        c = max(4096, width // div)
        return -(-c // 128) * 128

    if not (options.compact and n >= COMPACT_MIN
            and (do_sort or n % lane_compact.TILE == 0)):
        final = run(state)
        return unsort(outputs(final), final.idx)

    if do_sort:
        # each boundary: drain to the cap, then one more body sorts the
        # <= cap survivors into the prefix, which is the narrow state
        snaps, cur, width = [], state, n
        for _ in range(levels):
            c = phase_cap(width)
            if c >= width:
                break
            s_d, live = drain(cur, c)
            s_a = body(s_d, live)
            snaps.append(keep(s_a))
            with span("compact", live=live, width=width, cap=c):
                cur, width = TraceVars(*(x[:c] for x in s_a)), c
        final = run(cur)
        outs, idx = outputs(final), final.idx
        for kept in reversed(snaps):
            s_a = kept.state
            with span("expand"):
                # contiguous update of the prefix the narrow loop replaced
                full_outs = outputs(s_a)
                c = idx.shape[0]
                outs = [torch.cat([nar, wide[c:]])
                        for nar, wide in zip(outs, full_outs)]
                idx = torch.cat([idx, s_a.idx[c:]])
        return unsort(outs, idx)

    snaps, cur, width = [], state, n
    for _ in range(levels):
        c = phase_cap(width)
        if c >= width or width % lane_compact.TILE:
            break
        s_a, live = drain(cur, c)
        with span("compact", live=live, width=width, cap=c):
            planes, specs = lane_compact.leaves_to_planes(list(s_a))
            packed = lane_compact.compact_planes(planes, s_a.alive, c)
            s_n = TraceVars(*lane_compact.planes_to_leaves(packed, specs))
            # slack lanes past the survivor count hold unspecified bits;
            # the alive mask itself must be real
            s_n = s_n._replace(
                alive=s_n.alive & (torch.arange(c, device=dev) < live)
            )
        snaps.append(keep(s_a))
        cur, width = s_n, c
    outs = outputs(run(cur))
    for kept in reversed(snaps):
        s_a = kept.state
        with span("expand"):
            narrow, specs = lane_compact.leaves_to_planes(outs)
            fallback, _ = lane_compact.leaves_to_planes(outputs(s_a))
            outs = lane_compact.planes_to_leaves(
                lane_compact.expand_planes(narrow, s_a.alive, fallback), specs
            )
    return finish(outs)


counter(trace_wavefront, "host_syncs")
