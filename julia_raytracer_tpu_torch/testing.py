"""Test and smoke support (the tests and chip_smoke.py): scenes built in
code, since no scene files ship with the repository, and the agreement
criteria both use.

`cornell_scene()` is the path tracer's first main-path scene: a Cornell
box of 18 matte quads, under the dense intersector's 112-quad limit as
the corpus cornellbox is. `sphere_grid_scene()` is the mid-size path's:
the same room holding a grid of UV spheres, 102,406 quads at the default
size (classroom scale), which takes the worklist cluster intersector.
`instanced_scene()` and `hybrid_scene()` are the instanced paths': shared
sphere meshes instanced thousands of times, which take the two-level
build (pure, and hybrid with a flattened soup); `sphereflake_scene()`
is the benchmark's SPD sphereflake (7,381 instances of one sphere mesh,
a hybrid of 22,143 work items at full size). `hairball_scene()` puts
line and point primitives in the Cornell box; `many_lights_scene()`
lights the room with more emissive quads than the exact light pdf takes,
so its pdf marches; `write_cube_cage()` and `write_yocto_scene` give a
written scene whose shape is a subdivision cage.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.render.diff import (
    diff_options, make_param_loss, render_radiance,
)
from julia_raytracer_tpu_torch.render.integrator import (
    TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, camera_arrays,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.types import (
    MATERIAL_TYPES, CameraData, InstanceData, MaterialData, MaterialType,
    SceneData, ShapeData, SubdivData,
)
from julia_raytracer_tpu_torch.utils import rng as rng_mod


def require(ok, msg: str) -> None:
    """Raise AssertionError unless `ok`; unlike `assert`, never stripped
    by `python -O`."""
    if not ok:
        raise AssertionError(msg)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def check_hits(ref, got) -> float:
    """Intersector agreement with the tolerances of check() in
    tests/test_pallas_kernels.py: hit mask equal, > 99.9% same prim on hit
    lanes (rare 1-ulp tie flips on shared edges), t/u/position/normal
    close where the prim agrees; beyond check(), v close (as u) and the
    instance equal there. `ref`/`got` are Hit tuples of tensors or arrays.
    Returns max |dt| over the compared lanes."""
    h1, p1, u1, v1, t1, pos1, gn1, in1 = (_np(x) for x in ref[:8])
    h2, p2, u2, v2, t2, pos2, gn2, in2 = (_np(x) for x in got[:8])
    np.testing.assert_array_equal(h1, h2)
    m = h1 & h2
    require(not m.any() or (p1[m] == p2[m]).mean() > 0.999,
            "prim ids differ on > 0.1% of hits")
    mm = m & (p1 == p2)
    np.testing.assert_allclose(t1[mm], t2[mm], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u1[mm], u2[mm], atol=5e-3)
    np.testing.assert_allclose(v1[mm], v2[mm], atol=5e-3)
    np.testing.assert_array_equal(in1[mm], in2[mm])
    np.testing.assert_allclose(pos1[mm], pos2[mm], atol=5e-3)
    np.testing.assert_allclose(gn1[mm], gn2[mm], atol=1e-3)
    return float(np.abs(t1[mm] - t2[mm]).max()) if mm.any() else 0.0


def check_vs_flat(ref, got, max_t_mismatch: float = 0.0) -> dict:
    """An instanced intersector against the same scene flattened, with the
    contract of _check_vs_flat in tests/test_instanced.py (prim ids live
    in different layouts, so they are not compared): hit masks equal, t
    within rtol 2e-4, the instance equal on > 99.9% of hits, > 99.9% of
    |normal . normal| > 0.999, and positions within 5e-3 where t and the
    instance agree. `max_t_mismatch`: the share of hits whose t may fall
    outside the tolerance (0, the JAX test's contract, unless a caller
    has seen and explained such hits); they stay in the instance and
    normal checks. Returns max |dt| over the hits within the tolerance,
    the count of those outside it, and their lanes."""
    h1, t1, h2, t2 = _np(ref.hit), _np(ref.t), _np(got.hit), _np(got.t)
    np.testing.assert_array_equal(h1, h2)
    close = np.isclose(t2, t1, rtol=2e-4, atol=2e-4) | ~h1
    require((~close).sum() <= max_t_mismatch * h1.sum(),
            f"t differs beyond rtol 2e-4 on {(~close).sum()} of {h1.sum()} hits")
    i1, i2 = _np(ref.instance)[h1], _np(got.instance)[h1]
    require(not h1.any() or (i1 == i2).mean() > 0.999,
            "instance ids differ on > 0.1% of hits")
    dots = np.abs((_np(ref.gnormal)[h1] * _np(got.gnormal)[h1]).sum(axis=1))
    require(not h1.any() or (dots > 0.999).mean() > 0.999,
            "normals differ on > 0.1% of hits")
    same = h1 & close
    same[h1] &= i1 == i2
    np.testing.assert_allclose(_np(ref.position)[same], _np(got.position)[same],
                               atol=5e-3)
    ok = h1 & close
    return dict(max_dt=float(np.abs(t1[ok] - t2[ok]).max()) if ok.any() else 0.0,
                t_mismatch=int((~close).sum()),
                t_mismatch_other_instance=int(
                    (~close & h1)[h1][i1 != i2].sum()) if h1.any() else 0,
                t_mismatch_lanes=np.flatnonzero(~close).tolist())


def dense_soup(q: int = 112, seed: int = 3) -> np.ndarray:
    """[q, 4, 3] float32 random quads at mixed scales (edges from 1e-15
    to 1e15), a third of them degenerate (p3 == p4), quad 5 all zero, and
    quad 1 the 4 x 1 rectangle at z = 0 from the origin, where a ray down
    from x = -2^-149 gets u = -2^-151, which rounds to -0 and passes u >= 0
    (adversarial_rays sends it): the dense intersector's adversarial soup
    (112, its cap, by default)."""
    g = np.random.default_rng(seed)
    scale = 10.0 ** g.choice([-15, -3, 0, 0, 0, 2, 15], size=(q, 1))
    base = g.uniform(-1, 1, (q, 3)) * np.maximum(scale, 1.0)
    e1 = g.uniform(-1, 1, (q, 3)) * scale
    e2 = g.uniform(-1, 1, (q, 3)) * scale
    verts = np.stack([base, base + e1, base + e1 + e2, base + e2], axis=1)
    verts[::3, 3] = verts[::3, 2]
    verts[5:6] = 0.0
    verts[1:2] = [[0, 0, 0], [4, 0, 0], [4, 1, 0], [0, 1, 0]]
    return verts.astype(np.float32)


def adversarial_rays(verts: np.ndarray, g: np.random.Generator):
    """(origins, directions) [n, 3] float32 against the quads verts [q, 4,
    3]: rays through vertices, edge midpoints and inner points of their
    triangles, along an edge, parallel to a face (zero det) and nearly so
    (tiny det), from a vertex; with -0.0 components, NaN and +-inf
    entries; and, when verts has a quad 1 (dense_soup's), rays straight
    down onto it from x = -2^-148, -2^-149, -0.0 and 2^-149."""
    q = len(verts)
    tri = np.concatenate([verts[:, [0, 1, 3]], verts[:, [2, 3, 1]]])  # [2q, 3, 3]
    pick = g.integers(0, 2 * q, 400)
    a, b, c = (tri[pick, k].astype(np.float64) for k in range(3))
    n = np.cross(b - a, c - a)
    rays = []
    for target in (a, b, c, (a + b) / 2, (b + c) / 2, (a + c) / 2,
                   a + 0.3 * (b - a) + 0.7 * (c - a), (a + b + c) / 3):
        o = target + n * g.uniform(0.1, 3.0, (len(a), 1)) + g.normal(size=a.shape) * 1e-3
        rays.append((o, target - o))  # unnormalised: through the point
    rays.append((a - (b - a), b - a))  # along an edge, from behind it
    rays.append((a + n, b - a))  # parallel to the face: det == 0
    rays.append((a + n, (b - a) + n * 1e-12))  # tiny det
    rays.append((a, n))  # from a vertex, along the normal
    o = np.concatenate([r[0] for r in rays])
    d = np.concatenate([r[1] for r in rays])
    d[::11] = -0.0
    d[::11, 0] = 1.0
    o[::13, 1] = -0.0
    o[::17, 2] = np.nan
    d[::19, 1] = np.nan
    d[::23, 2] = np.inf
    o[::29, 0] = -np.inf
    if q > 1:
        x = np.array([-2.0**-148, -2.0**-149, -0.0, 2.0**-149])
        o = np.concatenate([o, np.stack([x, np.full(4, 0.25), np.ones(4)], 1)])
        d = np.concatenate([d, np.tile([0.0, 0.0, -1.0], (4, 1))])
    return o.astype(np.float32), d.astype(np.float32)


def cull_boxes(n: int, seed: int = 0) -> torch.Tensor:
    """n world boxes [n, 6] f32 for the candidate cull: sizes over four
    orders of magnitude in [-1, 1]^3, some flat in one axis, a few with a
    corner pair swapped (min > max)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-1.0, 1.0, (n, 3))
    h = np.exp(g.uniform(np.log(1e-4), np.log(0.5), (n, 1))) * g.uniform(
        0.2, 1.0, (n, 3))
    h[::7, 1] = 0.0
    box = np.concatenate([c - h, c + h], axis=1)
    box[::31] = box[::31][:, [3, 4, 5, 0, 1, 2]]
    return torch.tensor(box, dtype=torch.float32)


def cull_rays(lo, hi, n: int, seed: int = 0, device="cpu"):
    """n rays (ro, rd, tmin, tmax) for the candidate cull over a world of
    bounds lo, hi, in runs of 32 with nearby origins: a third from one eye
    outside the world towards nearby points in it (camera-like), a third
    from points in it towards nearby points (coherent bounces), a third
    in random directions; with zero, -0.0 and subnormal direction
    components (an infinite 1 / d), a NaN origin and direction; 10% dead
    (tmax -1), a fifth short, a few +inf."""
    g = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    span = hi - lo
    runs = -(-n // 32)

    def near(points):
        return (np.repeat(points, 32, axis=0)[:n]
                + g.normal(size=(n, 3)) * span * 0.01)

    ro = near(g.uniform(lo, hi, (runs, 3)))
    rd = near(g.uniform(lo, hi, (runs, 3))) - ro
    cam, rnd = n // 3, 2 * n // 3
    ro[:cam] = hi + span * 0.8
    rd[:cam] = near(g.uniform(lo, hi, (runs, 3)))[:cam] - ro[:cam]
    rd[rnd:] = g.normal(size=(n - rnd, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[cam::9, 0] = 0.0
    rd[cam + 1::9, 1] = -0.0
    rd[cam + 2::37, 2] = 1e-41
    ro[5::101, 0] = np.nan
    rd[7::103, 2] = np.nan
    tmax = np.where(g.random(n) < 0.1, -1.0, 3.4e38)
    tmax[::5] = g.uniform(0.05, 1.0, len(tmax[::5])) * np.linalg.norm(span)
    tmax[3::211] = np.inf
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (ro, rd, np.full(n, 1e-4), tmax)]


def same_lists(got, want) -> bool:
    """Two precull results (order, tlow, cnt) agree where they are read:
    cnt, and order[g, :cnt[g]] and tlow[g, :cnt[g]] bit for bit."""
    order, tlow, cnt = got
    if not torch.equal(cnt, want[2]):
        return False
    read = (torch.arange(order.shape[1], device=cnt.device)[None]
            < cnt[:, None].long())
    return (torch.equal(order[read], want[0][read])
            and torch.equal(tlow[read].view(torch.int32),
                            want[1][read].view(torch.int32)))


def regroup_bits(n_super: int, tiles: int = 4, padding: bool = True,
                 seed: int = 0) -> torch.Tensor:
    """Hand-built regroup bits [tiles, n_super, 1024] (bool) for the pack
    and unpack tests: pair (tile 0, super 0) has every lane set, (1, 0)
    only lane 1,023 and (2, 0) only lane 0; the middle super (if there
    are three or more) no set bit; lanes 600-631 of tiles 1 to T - 2 on no
    super; of the other pairs about 57% empty (as on the heavy scene's
    bounce rays) and the rest set at densities from 2% to 90%, with runs
    of whole words. Without `padding` the last tile tops every super up to
    whole 1024-slot groups, so no segment has a padding slot."""
    g = np.random.default_rng(seed)
    density = g.choice([0.02, 0.06, 0.3, 0.9], size=(tiles, n_super, 1))
    bits = g.random((tiles, n_super, 1024)) < density
    bits &= g.random((tiles, n_super, 1)) >= 0.57
    run = g.integers(0, 30, size=(tiles, n_super))
    runs = (np.arange(32)[None, None] >= run[..., None]) & (np.arange(32) < run[..., None] + 3)
    bits |= np.repeat(runs, 32, axis=-1) & (density > 0.5)
    bits[0, 0] = True
    bits[1:3, 0] = False
    bits[1, 0, 1023] = bits[2, 0, 0] = True
    if n_super > 2:
        bits[:, n_super // 2] = False
    bits[1:-1, :, 600:632] = False
    if not padding:
        bits[-1] = False
        short = -bits.sum(axis=(0, 2)) % 1024
        for s in np.flatnonzero(short):
            bits[-1, s, g.choice(1024, short[s], replace=False)] = True
    return torch.from_numpy(bits)


def adversarial_trires(n_slots: int, seed: int = 0) -> torch.Tensor:
    """[n_slots, 2] i32 (tri, t bits) for the unpack tests: t drawn from
    exact ties (0.5 and 0.25, so that a ray meets one t in several
    supers), misses at tmax (tri -1, t 3e38 and FLT_MAX), +0 and -0, two
    denormals (the least and 1e-40), NaN with two payloads and signs,
    +inf, -inf, negative t and random positives; tri random."""
    g = np.random.default_rng(seed)
    pool = np.array([0.5, 0.5, 0.25, 0.25, 3e38, np.finfo(np.float32).max,
                     0.0, -0.0, 1e-45, 1e-40, np.nan, np.inf, -np.inf, -1.5,
                     1.0, 2.0], np.float32).view(np.int32)
    pool[10] = np.int32(-4194303)  # 0xffc00001: a negative NaN
    pool = np.append(pool, np.int32(0x7FC00002))  # another payload
    t = pool[g.integers(0, len(pool), n_slots)]
    rand = g.random(n_slots) < 0.2
    t[rand] = g.uniform(0.01, 100.0, rand.sum()).astype(np.float32).view(np.int32)
    tri = g.integers(0, 1 << 20, n_slots).astype(np.int32)
    miss = (t == pool[4]) | (t == pool[5])
    tri[miss] = -1
    return torch.from_numpy(np.stack([tri, t], axis=1))


def image_close(got, want) -> tuple[float, float]:
    """Render agreement: image means within 1e-3 relative and >= 99% of
    pixels within 1e-3 absolute. Exact equality is not required: two
    devices' or frameworks' transcendentals differ by an ulp here and
    there, and a last-bit difference can flip a Russian-roulette or edge
    decision and send one path elsewhere. Returns (mean relative error,
    fraction of pixels within 1e-3)."""
    got, want = _np(got), _np(want)
    require(got.shape == want.shape, f"shapes {got.shape} != {want.shape}")
    require(np.isfinite(got).all(), "non-finite pixels")
    rel = float(abs(got.mean() - want.mean()) / abs(want.mean()))
    diff = np.abs(got - want).reshape(-1, got.shape[-1]).max(axis=1)
    frac = float((diff <= 1e-3).mean())
    require(rel <= 1e-3, f"image means differ by {rel:.3g} relative")
    require(frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3")
    return rel, frac


# card against CPU gradients of the pixel loss: the largest |card - CPU|
# over the entries, over the largest |CPU| entry. Not exact: the backward
# pass's scatters add with float atomics on the card, and the card's
# transcendentals, an ulp apart from the CPU's, may send a path elsewhere
# (image_close). On an H100 the Cornell box (64 x 64) and the sphere grid
# (128 x 128) measure 1e-7 to 2e-7 (PERF.md, section 6)
GRAD_TOL = 1e-4


def grads_close(got, want) -> float:
    """Hold gradients `got` to `want` within GRAD_TOL (normalised by the
    largest |want|); returns that normalised error."""
    got, want = _np(got), _np(want)
    require(got.shape == want.shape, f"shapes {got.shape} != {want.shape}")
    require(np.isfinite(got).all(), "non-finite gradients")
    scale = float(np.abs(want).max())
    require(scale > 0, "zero gradients")
    err = float(np.abs(got - want).max()) / scale
    require(err <= GRAD_TOL, f"gradients differ by {err:.3g} of the largest")
    return err


def _diff_scene(scene, res: int, device, bounces: int,
                hybrid_budget: int | None):
    """(dscene, config, options, camera arrays) of a gradient: the
    Renderer's, or with `hybrid_budget` the two-level build forced
    (build_device_scene(instancing=True, hybrid_budget=), as
    render_instanced forces it) with the path sampler's options."""
    if hybrid_budget is None:
        r = Renderer(scene, Params(resolution=res, bounces=bounces),
                     device=device)
        return r.dscene, r.config, r.options, r.cam_arrays
    d, cfg = build_device_scene(scene, instancing=True, device=device,
                                hybrid_budget=hybrid_budget)
    return (d, cfg, TraceOptions(sampler="path", bounces=bounces),
            camera_arrays(scene.cameras[0], device))


def param_grads(scene, res: int, device, bounces: int = 8,
                pixel_step: int = 1, seed: int = 0,
                hybrid_budget: int | None = None):
    """The pixel loss of render/diff.py make_param_loss on `scene` at res x
    res (every `pixel_step`-th pixel, one sample), against a target drawn
    from numpy with `seed`: (loss, d/d colour, d/d emission) on the CPU,
    the render on `device` through build_intersector's intersector (of
    the two-level build when `hybrid_budget` is given)."""
    d, cfg, opts, cam = _diff_scene(scene, res, device, bounces, hybrid_budget)
    pix = torch.arange(0, res * res, pixel_step, dtype=torch.int32,
                       device=device)
    target = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.0, 0.5, (len(pix), 3)).astype(np.float32), device=device)
    loss = make_param_loss(d, cfg, opts, cam, res, res)
    color = d.materials.color.clone().requires_grad_()
    emission = d.materials.emission.clone().requires_grad_()
    value = loss(color, emission, pix, target, 1, seed)
    value.backward()
    return float(value.detach()), color.grad.cpu(), emission.grad.cpu()


def vertex_grads(scene, res: int, device, hybrid_budget: int | None = None,
                 bounces: int = 8, seed: int = 0):
    """(mean squared radiance, its gradient with respect to
    dscene.prim_verts on the CPU) of one sample of res x res camera paths
    on `device` (render/diff.py render_radiance; shape-space quads for
    the two-level build of `hybrid_budget`)."""
    d, cfg, opts, cam = _diff_scene(scene, res, device, bounces, hybrid_budget)
    pv = d.prim_verts.clone().requires_grad_()
    rad = render_radiance(d._replace(prim_verts=pv), cfg,
                          diff_options(opts, cfg), cam, res, res,
                          torch.arange(res * res, dtype=torch.int32,
                                       device=device), 0, seed,
                          intersector=build_intersector(d, cfg))
    value = torch.mean(rad * rad)
    value.backward()
    return float(value.detach()), pv.grad.cpu()


def render_instanced(scene, res: int, spp: int, bounces: int,
                     hybrid_budget: int | None, device, seed: int = 0):
    """`scene` forced through the two-level build
    (build_device_scene(instancing=True, hybrid_budget=), as the JAX tests
    force small scenes) and traced with build_intersector's intersector
    through trace_wavefront: res x res camera rays, spp path-sampler
    samples of `bounces` bounces. Returns the mean radiance [res * res, 3]
    with non-finite samples zeroed, as the Renderer zeroes them."""
    d, cfg = build_device_scene(scene, instancing=True, device=device,
                                hybrid_budget=hybrid_budget)
    intersect = build_intersector(d, cfg)
    cam = camera_arrays(scene.cameras[0], device)
    pix = torch.arange(res * res, dtype=torch.int32, device=device)
    ij = torch.stack([pix % res, pix // res], dim=-1)
    total = torch.zeros((res * res, 3), device=device)
    for sample in range(spp):
        rng = rng_mod.seed_state(pix, sample, seed)
        puv, rng = rng_mod.rand2f(rng)
        luv, rng = rng_mod.rand2f(rng)
        ro, rd = sample_camera(cam, ij, (res, res), puv, luv, False)
        rad = trace_wavefront(
            d, cfg, TraceOptions(sampler="path", bounces=bounces), ro, rd,
            rng, intersector=intersect)[0]
        total += torch.where(torch.isfinite(rad), rad, 0.0)
    return total / spp


WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT = (17.0, 12.0, 4.0)


def _f32(x):
    return np.asarray(x, np.float32)


def _quads(corners) -> ShapeData:
    """Shape of independent quads; corners: [Q, 4, 3]."""
    corners = _f32(corners)
    q = len(corners)
    return ShapeData(
        quads=np.arange(4 * q, dtype=np.int32).reshape(q, 4),
        positions=corners.reshape(-1, 3),
    )


def _box(cx, cz, size, height, degrees) -> ShapeData:
    """Six-face box standing on the floor, rotated about +y."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    h = size / 2.0
    pts = []
    for y in (0.0, height):
        for dx, dz in ((-h, -h), (h, -h), (h, h), (-h, h)):
            pts.append((cx + c * dx + s * dz, y, cz - s * dx + c * dz))
    # outward-wound faces over the 8 corners (bottom 0-3, top 4-7)
    faces = [(0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1),
             (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 4, 0)]
    return ShapeData(quads=np.array(faces, np.int32), positions=_f32(pts))


def _camera() -> CameraData:
    return CameraData(
        frame=_f32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 3.9]]),
        lens=0.035, film=0.024, aspect=1.0, focus=3.9, name="camera",
    )


def _room() -> list[ShapeData]:
    """White floor + ceiling + back wall, red left, green right wall, and
    the 0.5 x 0.5 light just under the ceiling (shapes 0-3)."""
    white_walls = _quads([
        [[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],    # floor
        [[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]],    # ceiling
        [[-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]],  # back wall
    ])
    left = _quads([[[-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]]])
    right = _quads([[[1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]]])
    light = _quads([[[-0.25, 1.99, -0.25], [0.25, 1.99, -0.25],
                     [0.25, 1.99, 0.25], [-0.25, 1.99, 0.25]]])
    return [white_walls, left, right, light]


def cornell_scene() -> SceneData:
    """Cornell box: camera at (0, 1, 3.9) looking at (0, 1, 0); room
    x in [-1, 1], y in [0, 2], z in [-1, 1] with white floor, ceiling and
    back wall, red left and green right wall; two white boxes; a 0.5 x 0.5
    emissive quad just under the ceiling."""
    white_walls, left, right, light = _room()
    shapes = [
        white_walls, left, right,
        _box(0.33, 0.37, 0.6, 0.6, -17.0),
        _box(-0.34, -0.29, 0.6, 1.2, 17.0),
        light,
    ]
    materials = [
        MaterialData(color=_f32(WHITE)),
        MaterialData(color=_f32(RED)),
        MaterialData(color=_f32(GREEN)),
        MaterialData(emission=_f32(LIGHT)),
    ]
    shape_material = [0, 1, 2, 0, 0, 3]
    instances = [
        InstanceData(shape=i, material=m) for i, m in enumerate(shape_material)
    ]
    return SceneData(
        cameras=[_camera()], instances=instances, shapes=shapes,
        materials=materials,
    )


def _panel(y, x0, x1, z0, z1, nx, nz, triangles=False) -> ShapeData:
    """A horizontal nx x nz grid of quads at height y facing down, or
    each quad split in two triangles."""
    xs, zs = np.linspace(x0, x1, nx + 1), np.linspace(z0, z1, nz + 1)
    pos = _f32([(x, y, z) for z in zs for x in xs])
    i, k = np.meshgrid(np.arange(nx), np.arange(nz), indexing="xy")
    v = (k * (nx + 1) + i).reshape(-1)
    quads = np.stack([v, v + nx + 1, v + nx + 2, v + 1], axis=-1)
    if not triangles:
        return ShapeData(quads=quads.astype(np.int32), positions=pos)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return ShapeData(triangles=tris.astype(np.int32), positions=pos)


def lit_panels_scene() -> SceneData:
    """The Cornell room with the shading kernel's rarer inputs: the boxes
    carry vertex colours, the tall one glossy (a dense material row of a
    lobe other than matte); the light is two stacked emissive panels under
    the ceiling, 20 quads at y 1.97 over 18 triangles at y 1.93, 38 light
    elements, so the light pdf sums slabs of 16, 16 and 6, rays crossing
    both panels add two terms, and the triangles take the triangle warp."""
    white_walls, left, right, _ = _room()
    boxes = [_box(0.33, 0.37, 0.6, 0.6, -17.0),
             _box(-0.34, -0.29, 0.6, 1.2, 17.0)]
    for b in boxes:
        p = b.positions
        b.colors = _f32(np.concatenate(
            [0.4 + 0.5 * np.abs(np.sin(3.0 * p)), np.ones((len(p), 1))], 1))
    shapes = [white_walls, left, right, *boxes,
              _panel(1.97, -0.5, 0.5, -0.4, 0.4, 5, 4),
              _panel(1.93, -0.3, 0.6, -0.5, 0.3, 3, 3, triangles=True)]
    materials = [
        MaterialData(color=_f32(WHITE)),
        MaterialData(color=_f32(RED)),
        MaterialData(color=_f32(GREEN)),
        MaterialData(type=MaterialType.GLOSSY, color=_f32(WHITE),
                     roughness=0.2, ior=1.5),
        MaterialData(emission=_f32((4.0, 3.0, 2.0))),
    ]
    shape_material = [0, 1, 2, 0, 3, 4, 4]
    return SceneData(
        cameras=[_camera()], shapes=shapes, materials=materials,
        instances=[InstanceData(shape=i, material=m)
                   for i, m in enumerate(shape_material)])


SPHERE_RADIUS = 0.14
SPHERE_COLORS = ((0.8, 0.3, 0.2), (0.25, 0.5, 0.8), (0.85, 0.75, 0.4))


def uv_sphere(radius: float, segments: int) -> ShapeData:
    """UV sphere about the origin: segments x segments quads over a
    (segments + 1)^2 vertex grid, outward winding. The pole rows are
    degenerate quads: at the top p1 == p2 (first triangle empty), at the
    bottom p3 == p4 (second triangle empty)."""
    k = np.arange(segments + 1)
    theta = np.pi * k / segments
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_t[[0, -1]] = 0.0  # exact poles
    cos_t[[0, -1]] = (1.0, -1.0)
    phi = 2.0 * np.pi * (k % segments) / segments  # exact seam
    x = sin_t[:, None] * np.cos(phi)[None, :]
    z = sin_t[:, None] * np.sin(phi)[None, :]
    y = np.broadcast_to(cos_t[:, None], x.shape)
    positions = radius * np.stack([x, y, z], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(segments), np.arange(segments), indexing="ij")
    v00 = i * (segments + 1) + j
    quads = np.stack([v00, v00 + 1, v00 + segments + 2, v00 + segments + 1],
                     axis=-1).reshape(-1, 4)
    return ShapeData(quads=quads.astype(np.int32), positions=_f32(positions))


def sphere_grid_scene(grid: int = 5, segments: int = 64,
                      radius: float = SPHERE_RADIUS) -> SceneData:
    """The Cornell room (walls and light, no boxes) holding a grid x grid
    array of UV spheres of `radius` (0.14 by default) resting on the
    floor at x, z in linspace(-0.72, 0.72, grid). Each sphere is its own
    instance of one shared segments x segments mesh; materials cycle
    matte, glossy, metal (rough reflective). grid=5, segments=64:
    25 * 4,096 + 6 = 102,406 quads."""
    shapes = _room() + [uv_sphere(radius, segments)]
    materials = [
        MaterialData(color=_f32(WHITE)),
        MaterialData(color=_f32(RED)),
        MaterialData(color=_f32(GREEN)),
        MaterialData(emission=_f32(LIGHT)),
        MaterialData(type=MaterialType.MATTE, color=_f32(SPHERE_COLORS[0])),
        MaterialData(type=MaterialType.GLOSSY, color=_f32(SPHERE_COLORS[1]),
                     roughness=0.3),
        MaterialData(type=MaterialType.REFLECTIVE,
                     color=_f32(SPHERE_COLORS[2]), roughness=0.2),
    ]
    instances = [InstanceData(shape=i, material=i) for i in range(4)]
    centers = np.linspace(-0.72, 0.72, grid)
    for a, cx in enumerate(centers):
        for b, cz in enumerate(centers):
            frame = np.eye(4, 3, dtype=np.float32)
            frame[3] = (cx, radius, cz)
            instances.append(InstanceData(
                frame=frame, shape=4, material=4 + (a * grid + b) % 3))
    return SceneData(
        cameras=[_camera()], instances=instances, shapes=shapes,
        materials=materials,
    )


HAIR_CENTER = (0.05, 1.05, 0.25)


def hairball_scene(n_hairs: int = 1024, segments: int = 4,
                   n_points: int = 256, seed: int = 5) -> SceneData:
    """The Cornell box with a ball of hairs floating in its middle:
    n_hairs tapered polylines of `segments` segments each (n_hairs x
    segments lines), rooted on a sphere of radius 0.16 about HAIR_CENTER,
    0.2-0.3 long with a seeded random bend, radius 0.012 at the root to
    0.003 at the tip, per-vertex texcoords (along the hair, hair index)
    and colours (dark root, light tip); and n_points radius-points
    (radius 0.01-0.03, per-point colours) on a shell of radius 0.5 about
    the ball. No normals: lines carry their tangents. 1,024 hairs x 4
    segments: 4,096 lines; with 256 points, 4,352 curve primitives over
    the box's 18 quads, so the quads take the dense intersector."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n_hairs, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bend = g.normal(size=(n_hairs, 3)) * 0.08
    length = g.uniform(0.2, 0.3, (n_hairs, 1))
    f = np.linspace(0.0, 1.0, segments + 1)  # fraction along the hair
    pos = (np.asarray(HAIR_CENTER) + d[:, None] * 0.16
           + d[:, None] * length[:, None] * f[None, :, None]
           + bend[:, None] * (f * f)[None, :, None])  # [H, S+1, 3]
    nv = segments + 1
    base = np.arange(n_hairs)[:, None] * nv + np.arange(segments)[None, :]
    lines = np.stack([base, base + 1], axis=-1).reshape(-1, 2)
    texcoords = np.stack(np.broadcast_arrays(
        f[None, :], (np.arange(n_hairs) / max(n_hairs, 1))[:, None]), axis=-1)
    root, tip = np.array([0.25, 0.12, 0.05, 1.0]), np.array([0.9, 0.75, 0.5, 1.0])
    colors = root + (tip - root) * f[None, :, None]
    colors = np.broadcast_to(colors, (n_hairs, nv, 4))
    radius = np.broadcast_to(0.012 - 0.009 * f, (n_hairs, nv))
    hair = ShapeData(
        lines=lines.astype(np.int32), positions=_f32(pos.reshape(-1, 3)),
        texcoords=_f32(texcoords.reshape(-1, 2)),
        colors=_f32(colors.reshape(-1, 4)), radius=_f32(radius.reshape(-1)))
    pd = g.normal(size=(n_points, 3))
    pd /= np.linalg.norm(pd, axis=1, keepdims=True)
    points = ShapeData(
        points=np.arange(n_points, dtype=np.int32),
        positions=_f32(np.asarray(HAIR_CENTER) + pd * 0.5),
        colors=_f32(np.concatenate([g.uniform(0.2, 1.0, (n_points, 3)),
                                    np.ones((n_points, 1))], axis=1)),
        radius=_f32(g.uniform(0.01, 0.03, n_points)))
    scene = cornell_scene()
    scene.shapes += [hair, points]
    scene.materials += [
        MaterialData(color=_f32((0.9, 0.8, 0.7))),
        MaterialData(type=MaterialType.GLOSSY, color=_f32((0.8, 0.8, 0.8)),
                     roughness=0.2),
    ]
    n_shapes, n_mats = len(scene.shapes), len(scene.materials)
    scene.instances += [
        InstanceData(shape=n_shapes - 2, material=n_mats - 2),
        InstanceData(shape=n_shapes - 1, material=n_mats - 1),
    ]
    return scene


def many_lights_scene(panel=(64, 80), segments: int = 16) -> SceneData:
    """The Cornell room (walls, no boxes) lit by a panel of panel[0] x
    panel[1] small emissive quads just under the ceiling in place of its
    single light (one shape, so one light; each quad 80% of its cell of
    the 1.0 x 0.8 panel), with three UV spheres of segments x segments
    quads as occluders. (64, 80): 5,120 emissive quads, over the exact
    light pdf's EXACT_ELEMS (4,096), so the pdf marches; 5,893 quads in
    all, over the dense intersector's 112 and under the renderer's sort
    threshold (50,000): the worklist intersector with unsorted
    compaction."""
    nx, nz = panel
    x0 = -0.5 + np.arange(nx) / nx
    z0 = -0.4 + 0.8 * np.arange(nz) / nz
    cx, cz = 0.8 / nx, 0.8 * 0.8 / nz
    xa, za = np.meshgrid(x0, z0, indexing="ij")
    xa, za = xa.reshape(-1), za.reshape(-1)
    y = np.full_like(xa, 1.99)
    corners = np.stack([
        np.stack([xa, y, za], -1), np.stack([xa + cx, y, za], -1),
        np.stack([xa + cx, y, za + cz], -1), np.stack([xa, y, za + cz], -1),
    ], axis=1)
    white_walls, left, right, _ = _room()
    shapes = [white_walls, left, right, _quads(corners),
              uv_sphere(1.0, segments)]
    materials = _sphere_materials()
    materials[3] = MaterialData(emission=_f32(np.asarray(LIGHT) * 0.4))
    instances = [InstanceData(shape=i, material=i) for i in range(4)]
    for k, (x, z, r) in enumerate(((-0.45, -0.2, 0.3), (0.4, 0.1, 0.25),
                                   (0.0, 0.45, 0.2))):
        frame = np.eye(4, 3, dtype=np.float32) * r
        frame[3] = (x, r, z)
        instances.append(InstanceData(frame=frame, shape=4, material=4 + k))
    return SceneData(cameras=[_camera()], instances=instances, shapes=shapes,
                     materials=materials)


def write_cube_cage(path, center=(0.0, 0.0, 0.0), half: float = 0.5,
                    texcoords: bool = False) -> str:
    """Write a cube's Catmull-Clark control cage as an OBJ: 8 vertices and
    6 outward-wound quads of half-width `half` about `center`; with
    `texcoords`, face-varying texcoords (each face its own UV island, so
    the cage has UV seams). Returns `path`."""
    c, h = np.asarray(center, np.float64), half
    corners = [c + h * np.array(v) for v in (
        (-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
        (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1))]
    faces = ((1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5), (2, 3, 7, 6),
             (3, 4, 8, 7), (4, 1, 5, 8))
    lines = [f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}" for p in corners]
    if texcoords:
        for k in range(len(faces)):
            u0 = k / len(faces)
            u1 = (k + 0.9) / len(faces)
            lines += [f"vt {u0:.9g} 0", f"vt {u1:.9g} 0", f"vt {u1:.9g} 1",
                      f"vt {u0:.9g} 1"]
        lines += ["f " + " ".join(f"{v}/{4 * k + j + 1}" for j, v in enumerate(f))
                  for k, f in enumerate(faces)]
    else:
        lines += ["f " + " ".join(str(v) for v in f) for f in faces]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def subdiv_cube_scene(cage_path: str, levels: int = 4) -> SceneData:
    """The Cornell box with a subdivided cube floating above the boxes:
    the cube's shape is empty and a subdiv entry asks for its cage at
    `cage_path` (write_cube_cage) at `levels` levels of Catmull-Clark
    (6 x 4^levels quads: 1,536 at 4). Written by write_yocto_scene, the
    shape's PLY is empty, so both packages' loaders tessellate the cage
    by default."""
    scene = cornell_scene()
    scene.shapes.append(ShapeData())
    scene.materials.append(MaterialData(type=MaterialType.GLOSSY,
                                        color=_f32((0.3, 0.5, 0.8)),
                                        roughness=0.25))
    scene.instances.append(InstanceData(shape=len(scene.shapes) - 1,
                                        material=len(scene.materials) - 1))
    scene.subdivs.append(SubdivData(subdivisions=levels,
                                    shape=len(scene.shapes) - 1,
                                    uri=str(cage_path)))
    return scene


def heavy_scene() -> SceneData:
    """The heavy-scene path's scene: sphere_grid_scene(10, 124, radius=0.07),
    100 * 15,376 + 6 = 1,537,606 quads (the corpus kitchen's scale, 1.44M).
    100 instances of one shape, 1.5M flat: not instanced."""
    return sphere_grid_scene(10, 124, radius=0.07)


def _tilted_rotation(g: np.random.Generator) -> np.ndarray:
    """A seeded rotation by a random angle about an axis tilted at most
    ~27 degrees from +y (Rodrigues), as a 3 x 3 row-vector matrix."""
    phi, angle = g.uniform(0.0, 2.0 * np.pi, 2)
    axis = np.array([0.5 * np.sin(phi), 1.0, 0.5 * np.cos(phi)])
    kx, ky, kz = axis / np.linalg.norm(axis)
    k = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * (k @ k)


def _sphere_instance(g, center, radius, shape, material) -> InstanceData:
    """An instance of the unit sphere mesh `shape` with its lowest point
    at `center`: radius `radius` times a seeded uniform scale in
    [0.8, 1.0], and a seeded tilted rotation (no non-uniform scale:
    normals rotate by the forward matrix)."""
    r = radius * g.uniform(0.8, 1.0)
    frame = np.zeros((4, 3), np.float32)
    frame[:3] = _tilted_rotation(g) * r
    frame[3] = center
    frame[3, 1] += r
    return InstanceData(frame=frame, shape=shape, material=material)


def _sphere_materials() -> list[MaterialData]:
    return [
        MaterialData(color=_f32(WHITE)),
        MaterialData(color=_f32(RED)),
        MaterialData(color=_f32(GREEN)),
        MaterialData(emission=_f32(LIGHT)),
        MaterialData(type=MaterialType.MATTE, color=_f32(SPHERE_COLORS[0])),
        MaterialData(type=MaterialType.GLOSSY, color=_f32(SPHERE_COLORS[1]),
                     roughness=0.3),
        MaterialData(type=MaterialType.REFLECTIVE,
                     color=_f32(SPHERE_COLORS[2]), roughness=0.2),
    ]


INSTANCED_SEGMENTS = (160, 124, 96, 64)
# the full-size scenes' builds: work items, shape superclusters, padded
# shape-space prims and the flattened hybrid soup's quads
INSTANCED_COUNTS = dict(items=4_036, supers=32, n_prims=65_536, soup=0)
HYBRID_COUNTS = dict(items=12_288, supers=517, n_prims=1_058_816,
                     soup=1_048_582)


def instanced_scene(grid: int = 24, segments=INSTANCED_SEGMENTS,
                    seed: int = 0) -> SceneData:
    """The pure two-level instanced path's scene: the Cornell room (walls
    and light, 4 shapes) holding a grid x grid array of UV spheres on the
    floor that cycle over len(segments) shared meshes, each instance with
    a seeded tilted rotation and a uniform scale in [0.8, 1.0]. Defaults:
    576 spheres over meshes of 25,600 + 15,376 + 9,216 + 4,096 = 54,288
    quads; 7,817,478 world quads and 580 instances (under the hybrid's
    1,024), so the automatic rule instances it without a hybrid soup."""
    radius = 0.8 * 1.7 / (2 * max(grid - 1, 1))
    shapes = _room() + [uv_sphere(1.0, s) for s in segments]
    g = np.random.default_rng(seed)
    instances = [InstanceData(shape=i, material=i) for i in range(4)]
    centers = np.linspace(-0.85, 0.85, grid)
    for a, cx in enumerate(centers):
        for b, cz in enumerate(centers):
            k = a * grid + b
            instances.append(_sphere_instance(
                g, (cx, 0.0, cz), radius, 4 + k % len(segments), 4 + k % 3))
    return SceneData(cameras=[_camera()], instances=instances, shapes=shapes,
                     materials=_sphere_materials())


def hybrid_scene(small_grid: int = 32, small_segments: int = 32,
                 big_count: int = 24, big_segments: int = 1024,
                 seed: int = 1) -> SceneData:
    """The hybrid instanced path's scene: the Cornell room with a
    small_grid x small_grid carpet of small spheres (one small_segments
    mesh) on the floor and big_count big spheres (one big_segments mesh)
    floating in a 6-wide grid above it, seeded tilted rotations and
    uniform scales in [0.8, 1.0]. Defaults: 1,024 small spheres of 1,024
    quads (1,048,576 world quads) and 24 big ones of 1,048,576 quads
    (25,165,824 world quads): 26,214,406 world quads (above the 24M full
    flatten) in 1,052 instances (>= 1,024), so the automatic rule builds a
    hybrid with the 8M budget, flattening the room and the small spheres
    (1,048,582 quads) and keeping the big spheres as 24 x 512 work items."""
    small_r = 0.8 * 1.8 / (2 * max(small_grid - 1, 1))
    big_r = 0.12
    shapes = _room() + [uv_sphere(1.0, small_segments),
                        uv_sphere(1.0, big_segments)]
    g = np.random.default_rng(seed)
    instances = [InstanceData(shape=i, material=i) for i in range(4)]
    centers = np.linspace(-0.9, 0.9, small_grid)
    for a, cx in enumerate(centers):
        for b, cz in enumerate(centers):
            instances.append(_sphere_instance(
                g, (cx, 0.0, cz), small_r, 4, 4 + (a * small_grid + b) % 3))
    cols = 6
    rows = -(-big_count // cols)
    xs = np.linspace(-0.7, 0.7, cols)
    zs = np.linspace(-0.6, 0.3, max(rows, 1))
    for k in range(big_count):
        instances.append(_sphere_instance(
            g, (xs[k % cols], 0.45 + 0.5 * (k % 2), zs[k // cols]), big_r, 5,
            4 + k % 3))
    return SceneData(cameras=[_camera()], instances=instances, shapes=shapes,
                     materials=_sphere_materials())


# the full-size sphereflake's counts and hybrid build: spheres, instances
# (spheres, ground, three lights), work items and the flattened soup
SPHEREFLAKE_COUNTS = dict(spheres=7_381, instances=7_385, items=22_143,
                          soup=4, sphere_quads=6_144)


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """Right-handed rotation by `angle` about `axis` (column vectors)."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    t = 1.0 - c
    return np.array([[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                     [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                     [t * x * z - s * y, t * y * z + s * x, t * z * z + c]])


def sphereflake_spheres(size_factor: int = 4):
    """The SPD sphereflake (Haines 1987, balls.c): (centres [S, 3], radii
    [S], depths [S]) float64, depth first. Root at the origin, radius
    0.5; each sphere's nine children of a third its radius are tangent to
    it along balls.c's create_objset directions (a trio turned about
    (1, -1, 0) by asin(2 / sqrt 6), copied at 0, 120, 240 degrees about
    +z), a child's set turned by the least rotation taking +z to it."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]]) @ _axis_rotation(
        (1.0, -1.0, 0.0), math.asin(2.0 / math.sqrt(6.0))).T
    dirs = np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0),
                                                 k * 2.0 * math.pi / 3.0).T
                           for k in range(3)])
    out = ([], [], [])

    def grow(centre, radius, rot, depth):
        for lst, v in zip(out, (centre, radius, depth)):
            lst.append(v)
        if depth == size_factor:
            return
        for u in dirs @ rot.T:
            axis = np.cross((0.0, 0.0, 1.0), u)
            s = np.linalg.norm(axis)
            if s < 1e-12:  # straight up or down
                turn = np.diag([1.0, 1.0, 1.0] if u[2] > 0 else [1.0, -1.0, -1.0])
            else:
                turn = _axis_rotation(axis / s, math.atan2(s, u[2]))
            grow(centre + (radius + radius / 3.0) * u, radius / 3.0, turn,
                 depth + 1)

    grow(np.zeros(3), 0.5, np.eye(3), 0)
    return tuple(np.array(x) for x in out)


def cube_sphere(steps: int = 32) -> ShapeData:
    """Yocto/GL's make_sphere(steps): 6 x steps x steps quads of a cube
    with its positions normalised (radius 1), wound outward."""
    g = np.linspace(-1.0, 1.0, steps + 1)
    u, v = np.meshgrid(g, g, indexing="ij")
    one = np.ones_like(u)
    faces = [(one, u, v), (-one, v, u), (v, one, u), (u, -one, v),
             (u, v, one), (v, u, -one)]
    pos = np.concatenate([np.stack(f, -1).reshape(-1, 3) for f in faces])
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    i = np.arange(steps)
    a = (i[:, None] * (steps + 1) + i[None, :]).reshape(-1)
    quad = np.stack([a, a + steps + 1, a + steps + 2, a + 1], -1)
    quads = np.concatenate([quad + k * (steps + 1) ** 2 for k in range(6)])
    return ShapeData(quads=quads.astype(np.int32), positions=_f32(pos))


def sphereflake_scene(size_factor: int = 4, sphere_steps: int = 32) -> SceneData:
    """The SPD sphereflake as a Yocto/GL scene (Z-up): one
    cube_sphere(sphere_steps) instanced once a sphere (a uniform scale by
    its radius and a translation), a matte ground quad at z = -0.5 of
    corners (+-12, +-12), the SPD's three point lights as 0.5 x 0.5
    emissive quads (40) facing the origin, glossy spheres (1.0, 0.75,
    0.33; roughness 0.1), the SPD view (from (2.1, 1.3, 1.7) at the
    origin, 45 degrees). Defaults: SPHEREFLAKE_COUNTS, 45,348,864 sphere
    quads in the world, which the automatic rule builds as a hybrid that
    flattens the ground and lights and keeps the spheres as work items."""
    centres, radii, _ = sphereflake_spheres(size_factor)
    shapes = [cube_sphere(sphere_steps),
              _quads([[[-12, -12, -0.5], [12, -12, -0.5], [12, 12, -0.5],
                       [-12, 12, -0.5]]])]
    for p in ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0)):
        c = np.asarray(p)
        z = -c / np.linalg.norm(c)
        x = np.cross((0.0, 0.0, 1.0), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        shapes.append(_quads([[c + 0.25 * (sx * x + sy * y) for sx, sy in
                               ((-1, -1), (1, -1), (1, 1), (-1, 1))]]))
    instances = []
    for c, r in zip(centres, radii):
        frame = np.zeros((4, 3), np.float32)
        frame[:3] = np.eye(3) * r
        frame[3] = c
        instances.append(InstanceData(frame=frame, shape=0, material=0))
    instances += [InstanceData(shape=1, material=1)]
    instances += [InstanceData(shape=2 + k, material=2) for k in range(3)]
    materials = [
        MaterialData(type=MaterialType.GLOSSY, color=_f32((1.0, 0.75, 0.33)),
                     roughness=0.1, ior=1.5),
        MaterialData(color=_f32((0.8, 0.8, 0.8)), ior=1.5),
        MaterialData(emission=_f32((40.0, 40.0, 40.0)), ior=1.5),
    ]
    eye = np.asarray((2.1, 1.3, 1.7))
    focus = float(np.linalg.norm(eye))
    z = eye / focus
    x = np.cross((0.0, 0.0, 1.0), z)
    x /= np.linalg.norm(x)
    camera = CameraData(frame=_f32([x, np.cross(z, x), z, eye]),
                        lens=0.024 / (2.0 * math.tan(math.radians(22.5))),
                        film=0.024, aspect=1.0, focus=focus, aperture=0.0,
                        name="camera")
    return SceneData(cameras=[camera], instances=instances, shapes=shapes,
                     materials=materials)


_MATERIAL_NAMES ={int(t): name for name, t in MATERIAL_TYPES.items()
                   if name != "volume"}


def _ply_bytes(shape: ShapeData) -> bytes:
    """A shape as binary little-endian PLY: float vertex properties
    (positions, normals, u/v with v flipped as the loader flips it back,
    rgba colors, radius) and uchar-counted int index lists (faces as
    quads when it has any, else triangles; lines; points)."""
    n = len(shape.positions)
    cols = [(name, shape.positions[:, k]) for k, name in enumerate("xyz")]
    if len(shape.normals):
        cols += [(name, shape.normals[:, k]) for k, name in enumerate(
            ("nx", "ny", "nz"))]
    if len(shape.texcoords):
        cols += [("u", shape.texcoords[:, 0]),
                 ("v", np.float32(1.0) - shape.texcoords[:, 1])]
    if len(shape.colors):
        cols += [(name, shape.colors[:, k]) for k, name in enumerate(
            ("red", "green", "blue", "alpha"))]
    if len(shape.radius):
        cols.append(("radius", shape.radius))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    vert = np.zeros(n, np.dtype([(name, "<f4") for name, _ in cols]))
    for name, col in cols:
        vert[name] = col
    body = [vert.tobytes()]
    faces = shape.quads if len(shape.quads) else shape.triangles
    for element, idx in (("face", faces), ("line", shape.lines),
                         ("point", np.asarray(shape.points).reshape(-1, 1))):
        if not len(idx):
            continue
        rec = np.zeros(len(idx), np.dtype([("n", "u1"),
                                           ("i", "<i4", (idx.shape[1],))]))
        rec["n"], rec["i"] = idx.shape[1], idx
        header += [f"element {element} {len(idx)}",
                   "property list uchar int vertex_indices"]
        body.append(rec.tobytes())
    return ("\n".join(header + ["end_header"]) + "\n").encode() + b"".join(body)


def write_yocto_scene(scene: SceneData, directory) -> str:
    """Write an in-code scene as a Yocto JSON scene in `directory`:
    scene.json, shapes/shape<i>.ply (binary PLY) and textures/
    texture<i>.png (through save_png, which stores a byte texture's
    pixels exactly), and each subdiv's cage (its `uri`, an OBJ file) copied
    to subdivs/subdiv<i>.obj. Both packages' load_scene read it back field
    for field, texcoords up to the rounding of the loader's v flip. Linear
    (HDR) textures are refused: nothing here writes them. Returns the
    path of scene.json."""
    import json
    import os
    import shutil

    from julia_raytracer_tpu_torch.utils.imgio import save_png

    os.makedirs(os.path.join(directory, "shapes"), exist_ok=True)
    os.makedirs(os.path.join(directory, "textures"), exist_ok=True)

    def floats(a):
        return [float(v) for v in np.asarray(a, np.float32).reshape(-1)]

    textures = []
    for i, tex in enumerate(scene.textures):
        if tex.linear:
            raise ValueError("write_yocto_scene writes byte (PNG) textures only")
        uri = f"textures/texture{i}.png"
        save_png(os.path.join(directory, uri),
                 tex.pixels.reshape(tex.height, tex.width, 4), linear=False)
        textures.append({"uri": uri})
    shapes = []
    for i, shape in enumerate(scene.shapes):
        uri = f"shapes/shape{i}.ply"
        with open(os.path.join(directory, uri), "wb") as f:
            f.write(_ply_bytes(shape))
        shapes.append({"uri": uri})
    subdivs = []
    for i, sd in enumerate(scene.subdivs):
        uri = f"subdivs/subdiv{i}.obj"
        os.makedirs(os.path.join(directory, "subdivs"), exist_ok=True)
        shutil.copyfile(sd.uri, os.path.join(directory, uri))
        subdivs.append({
            "uri": uri, "shape": int(sd.shape),
            "subdivisions": int(sd.subdivisions),
            "catmullclark": bool(sd.catmullclark), "smooth": bool(sd.smooth),
            "displacement": float(sd.displacement),
            "displacement_tex": int(sd.displacement_tex),
        })
    doc = {
        "asset": {"generator": "julia_raytracer_tpu_torch.testing"},
        "cameras": [{
            "name": c.name, "frame": floats(c.frame),
            "orthographic": bool(c.orthographic), "lens": float(c.lens),
            "film": float(c.film), "aspect": float(c.aspect),
            "focus": float(c.focus), "aperture": float(c.aperture),
        } for c in scene.cameras],
        "textures": textures,
        "materials": [{
            "type": _MATERIAL_NAMES[int(m.type)],
            "emission": floats(m.emission), "color": floats(m.color),
            "roughness": float(m.roughness), "metallic": float(m.metallic),
            "ior": float(m.ior), "scattering": floats(m.scattering),
            "scanisotropy": float(m.scanisotropy),
            "trdepth": float(m.trdepth), "opacity": float(m.opacity),
            "emission_tex": int(m.emission_tex), "color_tex": int(m.color_tex),
            "roughness_tex": int(m.roughness_tex),
            "scattering_tex": int(m.scattering_tex),
            "normal_tex": int(m.normal_tex),
        } for m in scene.materials],
        "shapes": shapes,
        "instances": [{"frame": floats(i.frame), "shape": int(i.shape),
                       "material": int(i.material)} for i in scene.instances],
        "environments": [{"frame": floats(e.frame),
                          "emission": floats(e.emission),
                          "emission_tex": int(e.emission_tex)}
                         for e in scene.environments],
        "subdivs": subdivs,
    }
    path = os.path.join(directory, "scene.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path
