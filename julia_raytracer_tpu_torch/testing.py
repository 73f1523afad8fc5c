"""Test and smoke support (the tests and chip_smoke.py): scenes built in
code, since no scene files ship with the repository, and the agreement
criteria both use.

`cornell_scene()` is the path tracer's first main-path scene: a Cornell
box of 18 matte quads, under the dense intersector's 112-quad limit as
the corpus cornellbox is. `sphere_grid_scene()` is the mid-size path's:
the same room holding a grid of UV spheres, 102,406 quads at the default
size (classroom scale), which takes the worklist cluster intersector.
"""

from __future__ import annotations

import math

import numpy as np

from julia_raytracer_tpu_torch.scene.types import (
    CameraData, InstanceData, MaterialData, MaterialType, SceneData,
    ShapeData,
)


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
