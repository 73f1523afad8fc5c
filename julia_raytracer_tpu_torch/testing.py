"""Test and smoke support (the tests and chip_smoke.py): scenes built in
code, since no scene files ship with the repository, and the agreement
criteria both use.

`cornell_scene()` is the path tracer's main-path scene: a Cornell box of
18 matte quads, under the dense intersector's 112-quad limit as the
corpus cornellbox is.
"""

from __future__ import annotations

import math

import numpy as np

from julia_raytracer_tpu_torch.scene.types import (
    CameraData, InstanceData, MaterialData, SceneData, ShapeData,
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
    close where the prim agrees. `ref`/`got` are Hit tuples of tensors or
    arrays. Returns max |dt| over the compared lanes."""
    h1, p1, u1, _, t1, pos1, gn1 = (_np(x) for x in ref[:7])
    h2, p2, u2, _, t2, pos2, gn2 = (_np(x) for x in got[:7])
    np.testing.assert_array_equal(h1, h2)
    m = h1 & h2
    require((p1[m] == p2[m]).mean() > 0.999, "prim ids differ on > 0.1% of hits")
    mm = m & (p1 == p2)
    np.testing.assert_allclose(t1[mm], t2[mm], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u1[mm], u2[mm], atol=5e-3)
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


def cornell_scene() -> SceneData:
    """Cornell box: camera at (0, 1, 3.9) looking at (0, 1, 0); room
    x in [-1, 1], y in [0, 2], z in [-1, 1] with white floor, ceiling and
    back wall, red left and green right wall; two white boxes; a 0.5 x 0.5
    emissive quad just under the ceiling."""
    camera = CameraData(
        frame=_f32([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 3.9]]),
        lens=0.035, film=0.024, aspect=1.0, focus=3.9, name="camera",
    )
    white_walls = _quads([
        [[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],    # floor
        [[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]],    # ceiling
        [[-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]],  # back wall
    ])
    left = _quads([[[-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]]])
    right = _quads([[[1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]]])
    light = _quads([[[-0.25, 1.99, -0.25], [0.25, 1.99, -0.25],
                     [0.25, 1.99, 0.25], [-0.25, 1.99, 0.25]]])
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
        cameras=[camera], instances=instances, shapes=shapes,
        materials=materials,
    )
