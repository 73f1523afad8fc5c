"""The Standard Procedural Databases' tree (`tree`), as a Yocto/GL scene of
lines and points over a ground quad.

Eric Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A,
Nov. 1987 (code: github.com/erich666/StandardProceduralDatabases,
tree.c), which grows the tree by Aono and Kunii's binary branching
("Botanical Tree Image Generation", IEEE CG&A, May 1984): every branch is
a cone with a sphere at its end, and bears two child branches, down to
depth `size_factor`: 2^(size_factor + 1) - 1 cones and as many spheres
(4,095 of each at the SPD's default 11), over one square polygon.

Z-up. A branch is the unit segment from (0, 0, 0) to (0, 0, 1) of its own
frame; the trunk's frame is a uniform scale by TRUNK_LENGTH. A child's
frame is its parent's composed with a scale by the contraction ratio
(BR_CONTR_0 or BR_CONTR_1), a turn about y by the branching angle (+40 or
-25 degrees), a turn about z by the divergence angle (140 degrees, or
140 + 180 for the second child) and a lift to the parent's end, as
tree.c composes its matrices: so each child starts at its parent's end,
leaning away from its axis, the two on opposite sides, their plane
turned by the divergence angle from one level to the next. The width
contracts by WIDTH_CONTR a level (Aono and Kunii's width ratio): a branch
of depth k has radius TRUNK_RADIUS WIDTH_CONTR^k at its base and
WIDTH_CONTR times that at its end, its children's base radius, and the
sphere at its end has its end radius.

As Yocto/GL primitives: a cone is one line segment carrying its base and
end radii at its two vertices (Yocto's `intersect_line` interpolates the
radius along the segment), and a sphere is one point of its radius, a
disc that faces the ray (Yocto/GL has no sphere primitive). The ground is
one matte quad at z = 0. Yocto/GL has no point lights: each light is one
0.5 x 0.5 emissive quad facing the tree. The background is black (the
plain reference has no environment light). Every constant below that
tree.c's procedure does not fix is an assumption, listed in
benchmark/configs/spd_tree.json under `assumed`.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes.sphereflake import axis_rotation, material, quad_facing

SIZE_FACTOR = 11  # the SPD's default: 4,095 cones and 4,095 spheres
BR_ANGLE_0, BR_ANGLE_1 = 40.0, 25.0  # degrees from the parent's axis
BR_CONTR_0, BR_CONTR_1 = 0.65, 0.70  # length contraction of each child
DIV_ANGLE = 140.0  # degrees about the parent's axis
WIDTH_CONTR = 0.707  # radius contraction a level
TRUNK_LENGTH = 1.0
TRUNK_RADIUS = 0.06
BARK_COLOR = (0.55, 0.4, 0.2)
GROUND_COLOR = (0.4, 0.55, 0.25)
GROUND_HALF = 10.0
LIGHTS = ((5.0, 3.0, 6.0), (-4.0, 5.0, 5.0), (1.0, -6.0, 4.0))
LIGHT_SIZE = 0.5
LIGHT_EMISSION = (60.0, 60.0, 60.0)
LIGHT_TARGET = (-0.6, 0.55, 1.35)
EYE, TARGET, UP = (2.6, -2.4, 1.9), (-0.6, 0.55, 1.35), (0.0, 0.0, 1.0)
FOV_DEGREES = 45.0
FILM = 0.024


def counts(size_factor: int) -> int:
    """Cones (and spheres) of a tree of `size_factor`, the SPD's law."""
    return 2 ** (size_factor + 1) - 1


def _frame(scale: float, rot: np.ndarray, lift: float) -> np.ndarray:
    """4 x 4 matrix acting on column vectors: scale, then rot, then a lift
    along z."""
    m = np.eye(4)
    m[:3, :3] = rot * scale
    m[2, 3] = lift
    return m


def child_frames() -> tuple[np.ndarray, np.ndarray]:
    """The two children's frames in their parent's (tree.c's rst_mx1 and
    rst_mx2, as column-vector matrices)."""
    z = (0.0, 0.0, 1.0)
    y = (0.0, 1.0, 0.0)
    r1 = (axis_rotation(z, math.radians(DIV_ANGLE))
          @ axis_rotation(y, math.radians(BR_ANGLE_0)))
    r2 = (axis_rotation(z, math.radians(DIV_ANGLE + 180.0))
          @ axis_rotation(y, math.radians(-BR_ANGLE_1)))
    return _frame(BR_CONTR_0, r1, 1.0), _frame(BR_CONTR_1, r2, 1.0)


def branches(size_factor: int = SIZE_FACTOR):
    """(base [B, 3], end [B, 3], base radius [B], end radius [B]) float64,
    depth first from the trunk, parents before their children."""
    m1, m2 = child_frames()
    base, end, rb, re = [], [], [], []

    def grow(mx, depth, radius):
        base.append(mx[:3, 3].copy())
        end.append((mx @ np.array([0.0, 0.0, 1.0, 1.0]))[:3])
        rb.append(radius)
        re.append(radius * WIDTH_CONTR)
        if depth > 0:
            grow(mx @ m1, depth - 1, radius * WIDTH_CONTR)
            grow(mx @ m2, depth - 1, radius * WIDTH_CONTR)

    grow(_frame(TRUNK_LENGTH, np.eye(3), 0.0), size_factor, TRUNK_RADIUS)
    return np.array(base), np.array(end), np.array(rb), np.array(re)


def camera() -> dict:
    """A Yocto/GL pinhole from EYE at TARGET, 45 degrees across the film."""
    eye = np.asarray(EYE, np.float64)
    z = eye - np.asarray(TARGET, np.float64)
    focus = float(np.linalg.norm(z))
    z /= focus
    x = np.cross(UP, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    lens = FILM / (2.0 * math.tan(math.radians(FOV_DEGREES) / 2.0))
    return {"frame": np.asarray([x, y, z, eye], np.float32), "lens": lens,
            "film": FILM, "aspect": 1.0, "focus": focus, "aperture": 0.0}


def build(size_factor: int = SIZE_FACTOR) -> dict:
    base, end, rb, re = branches(size_factor)
    b = len(base)
    if b != counts(size_factor):
        raise AssertionError(f"{b} cones, the SPD's law gives "
                             f"{counts(size_factor)}")
    if size_factor == SIZE_FACTOR and b != 4095:
        raise AssertionError(f"{b} cones at the default size, not 4,095")
    # one line a cone, its own two vertices (radius base, end)
    bark = {"lines": np.arange(2 * b, dtype=np.int32).reshape(b, 2),
            "positions": np.stack([base, end], 1).reshape(-1, 3)
            .astype(np.float32),
            "radius": np.stack([rb, re], 1).reshape(-1).astype(np.float32)}
    # one point a sphere, at the cone's end, of its end radius
    spheres = {"points": np.arange(b, dtype=np.int32),
               "positions": end.astype(np.float32),
               "radius": re.astype(np.float32)}
    g = GROUND_HALF
    ground = {"quads": np.arange(4, dtype=np.int32).reshape(1, 4),
              "positions": np.asarray([[-g, -g, 0.0], [g, -g, 0.0],
                                       [g, g, 0.0], [-g, g, 0.0]],
                                      np.float32)}
    lights = [quad_facing(p, LIGHT_SIZE, LIGHT_TARGET) for p in LIGHTS]
    shapes = [bark, spheres, ground] + lights
    materials = [material(color=BARK_COLOR), material(color=GROUND_COLOR),
                 material(emission=LIGHT_EMISSION)]
    eye = np.eye(4, 3, dtype=np.float32)
    instances = ([{"shape": 0, "material": 0, "frame": eye},
                  {"shape": 1, "material": 0, "frame": eye},
                  {"shape": 2, "material": 1, "frame": eye}]
                 + [{"shape": 3 + k, "material": 2, "frame": eye}
                    for k in range(len(LIGHTS))])
    return {"camera": camera(), "shapes": shapes, "materials": materials,
            "instances": instances}
