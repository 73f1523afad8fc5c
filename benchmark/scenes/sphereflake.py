"""The Standard Procedural Databases' sphereflake (`balls`), as a Yocto/GL
scene of one sphere mesh instanced once per sphere.

Eric Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A,
Nov. 1987 (code: github.com/erich666/StandardProceduralDatabases,
balls.c). Z-up. The root sphere has centre (0, 0, 0) and radius 0.5;
each sphere of radius r has nine children of radius r / 3, tangent to
it (centre distance r + r / 3), down to depth `size_factor`:
1 + 9 + ... + 9^size_factor spheres (7,381 at the SPD's default 4).

The nine directions follow balls.c's `create_objset`: the trio
(1, 1, 0) / sqrt 2, (1, 0, -1) / sqrt 2, (0, 1, -1) / sqrt 2 turned about
the axis (1, -1, 0) / sqrt 2 by asin(2 / sqrt 6), then copied under turns
of 0, 120 and 240 degrees about +z: six on the equator, three at 54.7
degrees elevation. A child's own set is turned by the rotation that
takes +z to its direction from its parent (the least rotation, about
z x d), so that its children point away from the parent.

Yocto/GL has no analytic sphere: every sphere is an instance of
`make_sphere(sphere_steps)`, a cube of 6 x steps x steps quads with its
positions normalised (radius 1, outward winding), framed by a uniform
scale by the sphere's radius and a translation to its centre. The
ground is one quad at z = -0.5 (the root's lowest point), corners
(+-12, +-12). Yocto/GL has no point lights: each of the SPD's three
becomes one 0.5 x 0.5 emissive quad centred on it and facing the origin.
The background is black (the plain reference has no environment light).
"""

from __future__ import annotations

import math

import numpy as np

SPHERE_COLOR = (1.0, 0.75, 0.33)  # the SPD's "diffuse + specular" surface
SPHERE_ROUGHNESS = 0.1
GROUND_COLOR = (0.8, 0.8, 0.8)
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
LIGHT_SIZE = 0.5
LIGHT_EMISSION = (40.0, 40.0, 40.0)
GROUND_Z = -0.5
GROUND_HALF = 12.0
EYE, TARGET, UP = (2.1, 1.3, 1.7), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)
FOV_DEGREES = 45.0
FILM = 0.024


def axis_rotation(axis, angle: float) -> np.ndarray:
    """Rotation matrix (acting on column vectors) by `angle` about the
    unit `axis`, right-handed."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    t = 1.0 - c
    return np.array([[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                     [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                     [t * x * z - s * y, t * y * z + s * x, t * z * z + c]])


def objset() -> np.ndarray:
    """The nine unit child directions of a sphere whose parent lies
    toward -z [9, 3] (balls.c create_objset)."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    turn = axis_rotation((1.0, -1.0, 0.0), math.asin(2.0 / math.sqrt(6.0)))
    trio = trio @ turn.T
    return np.concatenate([
        trio @ axis_rotation((0.0, 0.0, 1.0), k * 2.0 * math.pi / 3.0).T
        for k in range(3)])


def z_to(direction) -> np.ndarray:
    """The least rotation taking +z to the unit `direction`."""
    d = np.asarray(direction, np.float64)
    axis = np.cross((0.0, 0.0, 1.0), d)
    s, c = np.linalg.norm(axis), d[2]
    if s < 1e-12:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    return axis_rotation(axis / s, math.atan2(s, c))


def spheres(size_factor: int = 4) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(centres [S, 3], radii [S], depths [S]) float64, depth-first from
    the root, parents before their children."""
    dirs = objset()
    centres, radii, depths = [], [], []

    def grow(centre, radius, rot, depth):
        centres.append(centre)
        radii.append(radius)
        depths.append(depth)
        if depth == size_factor:
            return
        for d in dirs @ rot.T:
            grow(centre + (radius + radius / 3.0) * d, radius / 3.0, z_to(d),
                 depth + 1)

    grow(np.zeros(3), 0.5, np.eye(3), 0)
    return np.array(centres), np.array(radii), np.array(depths)


def make_sphere(steps: int = 32) -> dict:
    """Yocto/GL's make_sphere(steps): a cube of 6 x steps x steps quads,
    positions normalised to radius 1, quads wound outward."""
    g = np.linspace(-1.0, 1.0, steps + 1)
    u, v = np.meshgrid(g, g, indexing="ij")  # [steps + 1, steps + 1]
    one = np.ones_like(u)
    # (position of a face's (u, v) grid point), each face's u x v outward
    faces = [np.stack(f, -1) for f in (
        (one, u, v), (-one, v, u), (v, one, u), (u, -one, v),
        (u, v, one), (v, u, -one))]
    i = np.arange(steps)
    a = (i[:, None] * (steps + 1) + i[None, :]).reshape(-1)
    quad = np.stack([a, a + steps + 1, a + steps + 2, a + 1], -1)
    n = (steps + 1) ** 2
    pos = np.concatenate([f.reshape(-1, 3) for f in faces])
    pos = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    quads = np.concatenate([quad + k * n for k in range(6)])
    return {"quads": quads.astype(np.int32), "positions": pos.astype(np.float32)}


def quad_facing(centre, size: float, toward) -> dict:
    """One size x size quad centred on `centre`, its normal toward the
    point `toward`."""
    c = np.asarray(centre, np.float64)
    z = np.asarray(toward, np.float64) - c
    z /= np.linalg.norm(z)
    x = np.cross((0.0, 0.0, 1.0), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    h = size / 2.0
    corners = [c + h * (sx * x + sy * y)
               for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    return {"quads": np.arange(4, dtype=np.int32).reshape(1, 4),
            "positions": np.asarray(corners, np.float32)}


def material(kind="matte", color=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
             roughness=0.0) -> dict:
    return {"type": kind, "color": np.asarray(color, np.float32),
            "emission": np.asarray(emission, np.float32),
            "roughness": float(roughness), "ior": 1.5}


def camera() -> dict:
    """The SPD view as a Yocto/GL pinhole: 45 degrees across the film."""
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


def frame(scale: float, centre) -> np.ndarray:
    """4 x 3 instance frame: a uniform scale, then a translation."""
    f = np.zeros((4, 3), np.float32)
    f[:3] = np.eye(3) * scale
    f[3] = centre
    return f


def build(size_factor: int = 4, sphere_steps: int = 32) -> dict:
    centres, radii, _ = spheres(size_factor)
    g = GROUND_HALF
    ground = {"quads": np.arange(4, dtype=np.int32).reshape(1, 4),
              "positions": np.asarray([[-g, -g, GROUND_Z], [g, -g, GROUND_Z],
                                       [g, g, GROUND_Z], [-g, g, GROUND_Z]],
                                      np.float32)}
    lights = [quad_facing(p, LIGHT_SIZE, TARGET) for p in LIGHTS]
    shapes = [make_sphere(sphere_steps), ground] + lights
    materials = [material("glossy", SPHERE_COLOR, roughness=SPHERE_ROUGHNESS),
                 material(color=GROUND_COLOR),
                 material(emission=LIGHT_EMISSION)]
    eye = np.eye(4, 3, dtype=np.float32)
    instances = ([{"shape": 0, "material": 0, "frame": frame(r, c)}
                  for c, r in zip(centres, radii)]
                 + [{"shape": 1, "material": 1, "frame": eye}]
                 + [{"shape": 2 + k, "material": 2, "frame": eye}
                    for k in range(len(LIGHTS))])
    return {"camera": camera(), "shapes": shapes, "materials": materials,
            "instances": instances}
