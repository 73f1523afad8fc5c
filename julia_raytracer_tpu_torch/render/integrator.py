"""Wavefront path integrators (naive + MIS path tracing with volumes),
port of julia_raytracer_tpu/render/integrator.py.

The whole ray batch advances in lock-step: every lane carries its own
bounce counter, weight, RNG stream and a one-slot volume stack. The loop
carries the *current intersection* across iterations; each body computes
the NEXT ray's intersection at its end. The loop runs eagerly on the
host, one body per iteration, until no lane is alive; each loop test
reads one bool or count back from the device (`trace_wavefront.host_syncs`
counts them).

Two-phase dispatch (the unsorted compaction of the JAX package, on by
default for widths n >= 16,384 with n % 1024 == 0): the loop runs at full
width until the survivors fit width / compact_div, then the state is
packed by the lane compactor (ops/lane_compact.py, a CUDA kernel on the
card) and the loop continues narrow; up to compact_levels such
boundaries. The narrow loop's five outputs are scattered back by the
expander. Dead lanes' outputs are final at a boundary and the compactor
is bit-exact, so radiance, hit, albedo and normal equal the plain loop's
bit for bit. (The returned rng differs on lanes that died before a
boundary: the plain loop keeps advancing their streams.)

Control flow per bounce, as in the reference integrator: miss -> env
radiance unless (bounce == 0 and envhidden); volume transmittance;
stochastic opacity skip (cap 128, bounce not consumed); first-hit AOVs;
one-sample MIS, 50/50 bsdf/light, balance heuristic; delta materials
bypass MIS; volume push/pop on transmission; in-volume scattering with
the same MIS; weight zero/non-finite break; Russian roulette after
bounce 3.

Intersectors: the dense kernel (ops/dense_intersect.py) for scenes of
<= 112 quads, the worklist cluster kernel (ops/worklist_intersect.py) for
every larger non-instanced scene.

Not ported yet (NotImplementedError, see ROADMAP.md): the BVH walk
(`intersect_bvh`), the regroup intersector and its kernel selection,
instanced and hybrid intersectors, line/point primitives, the wavefront
sort, and the fixed-trip differentiable loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops import bsdf as bsdf_ops
from julia_raytracer_tpu_torch.ops import eval as eval_ops
from julia_raytracer_tpu_torch.ops import lane_compact
from julia_raytracer_tpu_torch.ops.dense_intersect import make_dense_intersect
from julia_raytracer_tpu_torch.ops.geometry import F32_MAX, RAY_EPS
from julia_raytracer_tpu_torch.ops.traversal import intersect_bruteforce
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import dispatch, lights as lights_mod
from julia_raytracer_tpu_torch.render.scene_device import DeviceScene, SceneConfig
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.vecmath import dot

# dense-kernel cutoff: scenes with more quads go to the worklist
# intersector
BRUTEFORCE_THRESHOLD = 112
# narrowest wavefront that takes the two-phase dispatch
COMPACT_MIN = 16384


class TraceOptions(NamedTuple):
    """Integrator options."""

    sampler: str = "path"  # "path" | "naive"
    bounces: int = 8
    envhidden: bool = False
    nocaustics: bool = False
    # fixed-trip differentiable loop and wavefront sorting: not ported yet
    # (any non-default value raises NotImplementedError)
    fixed_iterations: int = 0
    sort_rays: bool = False
    # two-phase dispatch: survivors must fit width // compact_div before a
    # boundary; at most compact_levels boundaries (the JAX package's
    # defaults for the unsorted tier: 4 and 3)
    compact: bool = True
    compact_div: int = 4
    compact_levels: int = 3


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
    when the config carries them)."""
    verts = config.host_prim_verts
    inst = config.host_prim_instance
    if verts is None:
        verts = dscene.prim_verts.cpu().numpy()
    if inst is None:
        inst = dscene.prim_instance.cpu().numpy()
    return verts, inst


def make_intersect(dscene: DeviceScene, config: SceneConfig):
    """Closest-hit query of the plain versions, the reference the tests
    hold the intersectors to, for a scene on the CPU: the dense reference
    intersector (ops/traversal.py intersect_bruteforce) for <= 112 quads,
    else the worklist intersector's plain version. (The JAX package walks
    its BVH there, `intersect_bvh`, which is not ported; both are exact
    closest-hit queries.) A scene on the card takes build_intersector."""
    if dscene.prim_verts.device.type != "cpu":
        raise ValueError(
            "make_intersect is the plain reference for a scene on the CPU; "
            "use build_intersector for a scene on "
            f"{dscene.prim_verts.device}"
        )
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


def build_intersector(dscene: DeviceScene, config: SceneConfig):
    """The scene's intersector, on the device the scene lives on: the
    dense kernel (ops/dense_intersect.py) for <= 112 quads (or a leaf
    root), else the worklist cluster kernel (ops/worklist_intersect.py;
    its plain version for CPU tensors).

    The JAX package also routes every non-instanced scene of 113 to
    150,000 quads to its worklist kernel. At >= 150,000 quads it may pick
    its regroup kernel instead when `kernel_select` predicts a decisive
    win; regroup is only a speed choice over the same closest hits, and
    neither it nor `kernel_select` is ported yet (ROADMAP.md queue 2,
    item 5), so the port takes the worklist kernel at every size."""
    verts, inst = _host_prims(dscene, config)
    device = dscene.prim_verts.device
    if config.root_is_leaf or config.n_prims <= BRUTEFORCE_THRESHOLD:
        intersect = make_dense_intersect(verts, inst, device)
    else:
        intersect = wl.make_worklist_intersect(verts, inst, device)
    return curve_wrap(intersect, dscene, config)


def _vec(mask):
    return mask[..., None]


def _host_bool(t) -> bool:
    """Read a device scalar back to the host (one synchronization)."""
    trace_wavefront.host_syncs += 1
    return bool(t)


def trace_wavefront(dscene: DeviceScene, config: SceneConfig,
                    options: TraceOptions, ro, rd, rng_state, intersect=None):
    """Trace a batch of rays to completion.

    Returns (radiance [N,3], hit [N] bool, albedo [N,3], normal [N,3],
    rng_state [N] int32). `intersect` may be a prebuilt intersector; by
    default build_intersector's, on the scene's device (the kernels for a
    scene on the card, their plain versions for one on the CPU)."""
    if options.fixed_iterations or options.sort_rays:
        raise NotImplementedError(
            "fixed_iterations and sort_rays are not ported yet (ROADMAP.md "
            "queue 1, items 10 and 12)"
        )
    n = ro.shape[0]
    dev = ro.device
    if intersect is None:
        intersect = build_intersector(dscene, config)
    is_path = options.sampler == "path"
    counts = config.light_counts
    has_lights = counts.total > 0
    present = config.present_types
    n_prim = dscene.prim_verts.shape[0]
    n_inst = dscene.inst_frame.shape[0]

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    h0 = intersect(ro, rd, full((n,), RAY_EPS), full((n,), F32_MAX))
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
        idx=torch.arange(n, dtype=torch.int32, device=dev),
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
                    s.vol_scattering, s.vol_density, s.vol_aniso, outgoing,
                    vol_incoming,
                )
                pdf_v = dispatch.sample_scattering_pdf(
                    s.vol_density, s.vol_aniso, outgoing, vol_incoming
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
        vol_density, vol_scattering = s.vol_density, s.vol_scattering
        vol_aniso, has_vol = s.vol_aniso, s.has_vol
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
            has_vol=has_vol, idx=s.idx,
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

    if not (options.compact and n >= COMPACT_MIN and n % lane_compact.TILE == 0):
        return tuple(outputs(run(state)))

    def phase_cap(width):
        c = max(4096, width // options.compact_div)
        return -(-c // 128) * 128

    snaps, cur, width = [], state, n
    for _ in range(options.compact_levels):
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
