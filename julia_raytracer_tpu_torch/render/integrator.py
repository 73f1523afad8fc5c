"""Wavefront path integrators (naive + MIS path tracing with volumes),
port of julia_raytracer_tpu/render/integrator.py.

The whole ray batch advances in lock-step: every lane carries its own
bounce counter, weight, RNG stream and a one-slot volume stack. The loop
carries the *current intersection* across iterations; each body computes
the NEXT ray's intersection at its end. The loop runs eagerly on the
host, one body per iteration, until no lane is alive; each loop test
reads one bool or count back from the device (`trace_wavefront.host_syncs`
counts them).

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

Intersectors (build_intersector): the dense kernel
(ops/dense_intersect.py) for scenes of <= 112 quads, the worklist cluster
kernel (ops/worklist_intersect.py) above that, and at >= 150,000 quads
the regroup intersector (ops/regroup_intersect.py) for bounce rays when
utils/kernel_select.py predicts a decisive win (or when asked).
Instanced scenes take the work-item kernel (ops/instanced_intersect.py)
or, when the build flattened a world-space soup, the hybrid: the soup
through the flat intersectors above, the remaining work items after it.

Not ported yet (NotImplementedError, see ROADMAP.md): the BVH walk
(`intersect_bvh`), line/point primitives, and the fixed-trip
differentiable loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import bsdf as bsdf_ops
from julia_raytracer_tpu_torch.ops import eval as eval_ops
from julia_raytracer_tpu_torch.ops import lane_compact
from julia_raytracer_tpu_torch.ops.dense_intersect import make_dense_intersect
from julia_raytracer_tpu_torch.ops.cluster_tables import PRIMS_PER_CLUSTER
from julia_raytracer_tpu_torch.ops.geometry import (
    F32_MAX, RAY_EPS, intersect_quad, quad_normal,
)
from julia_raytracer_tpu_torch.ops.instanced_intersect import (
    make_instanced_intersect,
)
from julia_raytracer_tpu_torch.ops.traversal import Hit, intersect_bruteforce
from julia_raytracer_tpu_torch.ops import regroup_intersect as rg
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import dispatch, lights as lights_mod
from julia_raytracer_tpu_torch.render.scene_device import DeviceScene, SceneConfig
from julia_raytracer_tpu_torch.utils import kernel_select
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.vecmath import dot

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
    # fixed-trip differentiable loop: not ported yet (a non-zero value
    # raises NotImplementedError)
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


def curve_wrap(intersect, dscene: DeviceScene, config: SceneConfig):
    """Merge line/point primitives into a quad intersector: a pass-through
    for scenes without them; scenes with them are not ported yet."""
    if config.n_lines or config.n_points:
        raise NotImplementedError(
            "line/point primitives are not ported yet (ROADMAP.md queue 1, "
            "item 10)"
        )
    return intersect


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

    return intersect


def _check_regroup(regroup: str) -> None:
    if regroup not in ("auto", "on", "off"):
        raise ValueError(f"regroup={regroup!r}: one of 'auto', 'on', 'off'")


def _flat_intersector(verts, inst, device, n_prims, leaf, regroup,
                      regroup_min_prims, label):
    """The intersector of a flat quad soup, routed as the JAX package
    routes one (integrator.py:471-538, and :199-248 for a hybrid soup):
    dense, regroup (by kernel_select under "auto", whose decision line is
    printed with `label`) or worklist."""
    _check_regroup(regroup)
    if leaf or n_prims <= BRUTEFORCE_THRESHOLD:
        return make_dense_intersect(verts, inst, device)
    if n_prims >= regroup_min_prims and regroup != "off":
        livegate = None
        if regroup == "auto":
            sel = kernel_select.select_bounce_kernel(verts, inst, device=device)
            print(f"{label}: {sel['kernel']} (predicted "
                  f"regroup/worklist ratio {sel['ratio']}, threshold "
                  f"{sel['threshold']})", flush=True)
            if sel["kernel"] == "worklist":
                return wl.make_worklist_intersect(verts, inst, device)
            if sel["ratio"] < 0.25:
                livegate = 0.2
        return rg.make_regroup_intersect(verts, inst, device, livegate=livegate)
    return wl.make_worklist_intersect(verts, inst, device)


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
    ops/instanced_intersect.py, on the scene's device. `.primary` is
    composed from the flat part's when it has one."""
    device = dscene.prim_verts.device
    wpv = np.asarray(config.hyb_world_verts)
    winst = np.asarray(config.hyb_world_inst)
    remap = torch.as_tensor(config.hyb_remap, device=device)
    has_items = len(config.inst_tables.wi_inst) > 0
    if reference:
        wpv_d = torch.as_tensor(wpv, device=device)
        winst_d = torch.as_tensor(winst, device=device)

        def flat_part(ro, rd, tmin, tmax):
            return intersect_bruteforce(wpv_d, ro, rd, tmin, tmax,
                                        prim_instance=winst_d)

        inst_part = (make_intersect_instanced_ref(dscene, config)
                     if has_items else None)
    else:
        flat_part = _flat_intersector(wpv, winst, device, len(wpv), False,
                                      regroup, regroup_min_prims,
                                      "hybrid flat kernel")
        inst_part = (make_instanced_intersect(config.inst_tables, device)
                     if has_items else None)

    def compose(flat_fn):
        def intersect(ro, rd, tmin, tmax):
            h1 = flat_fn(ro, rd, tmin, tmax)
            prim1 = torch.where(h1.hit, remap[h1.prim.clamp(min=0).long()], -1)
            if inst_part is None:
                return h1._replace(prim=prim1)
            t_cut = torch.where(h1.hit, h1.t * HYBRID_T_CUT, tmax)
            h2 = inst_part(ro, rd, tmin, torch.minimum(tmax, t_cut))
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

    intersect = compose(flat_part)
    if hasattr(flat_part, "primary"):
        intersect.primary = compose(flat_part.primary)
    # the soup's regroup gate, for reports (None: no regroup)
    intersect.livegate = getattr(flat_part, "livegate", None)
    return intersect


def make_intersect(dscene: DeviceScene, config: SceneConfig):
    """Closest-hit query of the plain versions, the reference the tests
    hold the intersectors to, for a scene on the CPU: the dense reference
    intersector (ops/traversal.py intersect_bruteforce) for <= 112 quads,
    else the worklist intersector's plain version. (The JAX package walks
    its BVH there, `intersect_bvh`, which is not ported; both are exact
    closest-hit queries.) Instanced scenes: make_intersect_instanced_ref,
    or the hybrid over the plain references. A scene on the card takes
    build_intersector."""
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
    return curve_wrap(intersect, dscene, config)


def build_intersector(dscene: DeviceScene, config: SceneConfig,
                      regroup: str = "auto",
                      regroup_min_prims: int = REGROUP_MIN_PRIMS):
    """The scene's intersector, on the device the scene lives on (the
    kernels for a scene on the card, their plain versions for one on the
    CPU), routed as the JAX package routes a scene (integrator.py:443-538):
      - instanced scenes: the hybrid (make_intersect_hybrid) when the build
        flattened a world-space soup, else the work-item intersector
        (ops/instanced_intersect.py);
      - <= 112 quads (or a leaf root): the dense kernel
        (ops/dense_intersect.py);
      - >= `regroup_min_prims` quads (150,000; was JRT_REGROUP_MIN) and
        `regroup` (was JRT_REGROUP) "on": the regroup intersector
        (ops/regroup_intersect.py) for bounce rays, its `.primary` (the
        worklist kernel over the same tables) for camera rays; "auto"
        takes it only when utils/kernel_select.py predicts a decisive win
        (and then, below a predicted ratio of 0.25, with the lower
        liveness gate 0.2), and prints the decision line; "off" keeps the
        worklist kernel;
      - otherwise the worklist cluster kernel (ops/worklist_intersect.py).
    Regroup is only a speed choice over the same closest hits."""
    _check_regroup(regroup)
    device = dscene.prim_verts.device
    if config.inst_tables is not None:
        if config.hyb_world_verts is not None:
            return make_intersect_hybrid(dscene, config, regroup=regroup,
                                         regroup_min_prims=regroup_min_prims)
        return make_instanced_intersect(config.inst_tables, device)
    verts, inst = _host_prims(dscene, config)
    return curve_wrap(
        _flat_intersector(verts, inst, device, config.n_prims,
                          config.root_is_leaf, regroup, regroup_min_prims,
                          "bounce kernel"),
        dscene, config)


def _vec(mask):
    return mask[..., None]


def _host_bool(t) -> bool:
    """Read a device scalar back to the host (one synchronization)."""
    trace_wavefront.host_syncs += 1
    return bool(t)


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


def trace_wavefront(dscene: DeviceScene, config: SceneConfig,
                    options: TraceOptions, ro, rd, rng_state, intersect=None,
                    intersect_primary=None):
    """Trace a batch of rays to completion.

    Returns (radiance [N,3], hit [N] bool, albedo [N,3], normal [N,3],
    rng_state [N] int32). `intersect` may be a prebuilt intersector; by
    default build_intersector's, on the scene's device (the kernels for a
    scene on the card, their plain versions for one on the CPU). Camera
    rays go through `intersect_primary` when given (the regroup
    intersector's `.primary`: the worklist kernel, as the JAX package
    routes them), else through `intersect`. The light pdf is the exact
    element sweep and traces nothing, so camera rays are the only primary
    dispatch."""
    if options.fixed_iterations:
        raise NotImplementedError(
            "fixed_iterations is not ported yet (ROADMAP.md queue 1, item 12)"
        )
    n = ro.shape[0]
    dev = ro.device
    if intersect is None:
        intersect = build_intersector(dscene, config)
    intersect_primary = intersect_primary or intersect
    do_sort = options.sort_rays
    is_path = options.sampler == "path"
    counts = config.light_counts
    has_lights = counts.total > 0
    present = config.present_types
    n_prim = dscene.prim_verts.shape[0]
    n_inst = dscene.inst_frame.shape[0]

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    idx0 = torch.arange(n, dtype=torch.int32, device=dev)
    if do_sort:
        scene_vmin, scene_vmax = sort_bounds(dscene, config)
        # camera rays arrive in scanline order: sort them too
        perm0 = torch.argsort(_sort_key(ro, rd, scene_vmin, scene_vmax),
                              stable=True)
        ro, rd, rng_state, idx0 = (x[perm0] for x in (ro, rd, rng_state, idx0))

    h0 = intersect_primary(ro, rd, full((n,), RAY_EPS), full((n,), F32_MAX))
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

    def body(s: TraceVars) -> TraceVars:
        # width-polymorphic: the two-phase dispatch re-enters with a
        # narrowed state, so lane-shaped constants derive from the state
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
            tpdf = bsdf_ops.sample_transmittance_pdf(s.vol_density, dist, s.isec_t)
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
        # folded per-instance material rows for small scenes
        dense_mats = 0 < config.n_instances <= 64
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
        nxt = intersect(new_ro, new_rd, full((n,), RAY_EPS), tmax)

        # ---- weight updates
        if is_path:
            lights_pdf = (
                lights_mod.sample_lights_pdf(
                    dscene, dscene.lights, counts, new_ro, new_rd
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
            denom_nd = 0.5 * pdf_b + 0.5 * lights_pdf
            w_nd = f_nd / torch.clamp(denom_nd, min=1e-30)[..., None]
            # delta
            f_d = dispatch.eval_delta(
                material, normal, outgoing, incoming, present=present
            )
            pdf_d = dispatch.sample_delta_pdf(
                material, normal, outgoing, incoming, present=present
            )
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
                denom_v = 0.5 * pdf_v + 0.5 * lights_pdf
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
            )
            f_d = dispatch.eval_delta(
                material, normal, outgoing, incoming, present=present
            )
            pdf_d = dispatch.sample_delta_pdf(
                material, normal, outgoing, incoming, present=present
            )
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
        rr_prob = torch.clamp(weight.amax(dim=-1), max=0.99)
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

    def run(s: TraceVars) -> TraceVars:
        while _host_bool(s.alive.any()):
            s = body(s)
        return s

    def drain(s: TraceVars, cap: int) -> TraceVars:
        while _host_bool(s.alive.sum() > cap):
            s = body(s)
        return s

    def outputs(s: TraceVars):
        return [s.radiance, s.hit_flag, s.hit_albedo, s.hit_normal, s.rng]

    def unsort(outs, idx):
        if not do_sort:
            return tuple(outs)
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
            s_a = body(drain(cur, c))
            snaps.append(s_a)
            cur, width = TraceVars(*(x[:c] for x in s_a)), c
        final = run(cur)
        outs, idx = outputs(final), final.idx
        for s_a in reversed(snaps):
            # contiguous update of the prefix the narrow loop replaced
            full_outs = outputs(s_a)
            c = idx.shape[0]
            outs = [torch.cat([nar, wide[c:]]) for nar, wide in zip(outs, full_outs)]
            idx = torch.cat([idx, s_a.idx[c:]])
        return unsort(outs, idx)

    snaps, cur, width = [], state, n
    for _ in range(levels):
        c = phase_cap(width)
        if c >= width or width % lane_compact.TILE:
            break
        s_a = drain(cur, c)
        total = s_a.alive.sum()
        planes, specs = lane_compact.leaves_to_planes(list(s_a))
        packed = lane_compact.compact_planes(planes, s_a.alive, c)
        s_n = TraceVars(*lane_compact.planes_to_leaves(packed, specs))
        # slack lanes past the survivor count hold unspecified bits; the
        # alive mask itself must be real
        s_n = s_n._replace(
            alive=s_n.alive & (torch.arange(c, device=dev) < total)
        )
        snaps.append(s_a)
        cur, width = s_n, c
    outs = outputs(run(cur))
    for s_a in reversed(snaps):
        narrow, specs = lane_compact.leaves_to_planes(outs)
        fallback, _ = lane_compact.leaves_to_planes(outputs(s_a))
        outs = lane_compact.planes_to_leaves(
            lane_compact.expand_planes(narrow, s_a.alive, fallback), specs
        )
    return tuple(outs)


trace_wavefront.host_syncs = 0
