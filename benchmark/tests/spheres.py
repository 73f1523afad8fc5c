"""A test scene: the Cornell room (walls and light, no boxes) holding a
grid x grid array of UV spheres resting on the floor, materials cycling
matte, glossy and rough metal, as plain numpy. Large enough at small
sizes to take the reference's two-level acceleration and the program's
worklist intersector, and to hold glossy and reflective materials, which
the Cornell box has not.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes.cornell import camera, identity, material, room, room_materials

SPHERE_COLORS = ((0.8, 0.3, 0.2), (0.25, 0.5, 0.8), (0.85, 0.75, 0.4))


def uv_sphere(radius: float, segments: int) -> dict:
    """UV sphere about the origin: segments x segments quads over a
    (segments + 1)^2 vertex grid, outward winding; the pole rows are
    degenerate quads."""
    k = np.arange(segments + 1)
    theta = np.pi * k / segments
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_t[[0, -1]] = 0.0
    cos_t[[0, -1]] = (1.0, -1.0)
    phi = 2.0 * np.pi * (k % segments) / segments
    x = sin_t[:, None] * np.cos(phi)[None, :]
    z = sin_t[:, None] * np.sin(phi)[None, :]
    y = np.broadcast_to(cos_t[:, None], x.shape)
    positions = radius * np.stack([x, y, z], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(segments), np.arange(segments), indexing="ij")
    v00 = i * (segments + 1) + j
    quads = np.stack([v00, v00 + 1, v00 + segments + 2, v00 + segments + 1],
                     axis=-1).reshape(-1, 4)
    return {"quads": quads.astype(np.int32),
            "positions": positions.astype(np.float32)}


def build(grid: int = 5, segments: int = 64, radius: float = 0.14) -> dict:
    shapes = room() + [uv_sphere(radius, segments)]
    materials = room_materials() + [
        material(color=SPHERE_COLORS[0]),
        material("glossy", SPHERE_COLORS[1], roughness=0.3),
        material("reflective", SPHERE_COLORS[2], roughness=0.2),
    ]
    instances = [{"shape": i, "material": i, "frame": identity()}
                 for i in range(4)]
    centers = np.linspace(-0.72, 0.72, grid)
    for a, cx in enumerate(centers):
        for b, cz in enumerate(centers):
            frame = identity()
            frame[3] = (cx, radius, cz)
            instances.append({"shape": 4, "material": 4 + (a * grid + b) % 3,
                              "frame": frame})
    return {"camera": camera(), "shapes": shapes, "materials": materials,
            "instances": instances}
