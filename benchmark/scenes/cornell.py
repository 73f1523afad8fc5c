"""The Cornell box: 18 matte quads and one 0.5 x 0.5 area light.

A frozen copy of the program's in-code box, as plain numpy, so that a
later change to the program's own test scenes does not move the
yardstick. Camera at (0, 1, 3.9) looking down -z; room x in [-1, 1],
y in [0, 2], z in [-1, 1]; white floor, ceiling and back wall, red left
and green right wall, two white boxes, the light just under the ceiling.
"""

from __future__ import annotations

import math

import numpy as np

WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)
LIGHT = (17.0, 12.0, 4.0)


def quads(corners) -> dict:
    """A shape of independent quads; corners [Q, 4, 3]."""
    corners = np.asarray(corners, np.float32)
    q = len(corners)
    return {"quads": np.arange(4 * q, dtype=np.int32).reshape(q, 4),
            "positions": corners.reshape(-1, 3)}


def box(cx, cz, size, height, degrees) -> dict:
    """Six-face box standing on the floor, rotated about +y."""
    a = math.radians(degrees)
    c, s = math.cos(a), math.sin(a)
    h = size / 2.0
    pts = []
    for y in (0.0, height):
        for dx, dz in ((-h, -h), (h, -h), (h, h), (-h, h)):
            pts.append((cx + c * dx + s * dz, y, cz - s * dx + c * dz))
    faces = [(0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1),
             (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 4, 0)]
    return {"quads": np.array(faces, np.int32),
            "positions": np.asarray(pts, np.float32)}


def camera() -> dict:
    return {"frame": np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 3.9]],
                                np.float32),
            "lens": 0.035, "film": 0.024, "aspect": 1.0, "focus": 3.9,
            "aperture": 0.0}


def room() -> list[dict]:
    """White floor + ceiling + back wall, red left, green right wall, and
    the light (shapes 0-3)."""
    white_walls = quads([
        [[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],
        [[-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]],
        [[-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]],
    ])
    left = quads([[[-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]]])
    right = quads([[[1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]]])
    light = quads([[[-0.25, 1.99, -0.25], [0.25, 1.99, -0.25],
                    [0.25, 1.99, 0.25], [-0.25, 1.99, 0.25]]])
    return [white_walls, left, right, light]


def material(kind="matte", color=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
             roughness=0.0) -> dict:
    return {"type": kind, "color": np.asarray(color, np.float32),
            "emission": np.asarray(emission, np.float32),
            "roughness": float(roughness), "ior": 1.5}


def room_materials() -> list[dict]:
    return [material(color=WHITE), material(color=RED),
            material(color=GREEN), material(emission=LIGHT)]


def identity() -> np.ndarray:
    return np.eye(4, 3, dtype=np.float32)


def build() -> dict:
    white_walls, left, right, light = room()
    shapes = [white_walls, left, right, box(0.33, 0.37, 0.6, 0.6, -17.0),
              box(-0.34, -0.29, 0.6, 1.2, 17.0), light]
    shape_material = [0, 1, 2, 0, 0, 3]
    return {
        "camera": camera(),
        "shapes": shapes,
        "materials": room_materials(),
        "instances": [{"shape": i, "material": m, "frame": identity()}
                      for i, m in enumerate(shape_material)],
    }
