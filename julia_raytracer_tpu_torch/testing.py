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
build (pure, and hybrid with a flattened soup).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.render.integrator import (
    TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.renderer import camera_arrays
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.types import (
    CameraData, InstanceData, MaterialData, MaterialType, SceneData,
    ShapeData,
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
            rng, intersect=intersect,
            intersect_primary=getattr(intersect, "primary", None))[0]
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
