"""Veach's multiple-importance-sampling test scene, as a Yocto/GL scene of
quads: four sphere lights of equal power in a row above four rough metal
plates, a fifth light off to the side, a matte floor and back wall.

Eric Veach and Leonidas Guibas, "Optimally Combining Sampling Techniques
for Monte Carlo Rendering", SIGGRAPH 1995, Fig. 1; Veach's thesis, 1997,
Fig. 9.2; distributed as "Veach, MIS" in Bitterli's Rendering Resources.
The scene's files are not in the repository: every number here is
recalled from the published description and is listed under `assumed`
in benchmark/configs/veach_mis.json.

Y-up. The four lights sit on the x axis at x = -3.75, -1.25, 1.25, 3.75
with radii 0.0333, 0.1, 0.3, 0.9 and radiances 901.803, 100, 11.1111,
1.23457 (radius squared times radiance is the same, so is the power);
a fifth of radius 0.5 and radiance 800 sits at (10, 10, 4). Yocto/GL has
no analytic sphere: each light is an instance of the sphereflake's
`make_sphere(sphere_steps)` (6 x steps x steps quads), framed by a
uniform scale by its radius and a translation to its centre, with a
matte black material that emits. So every light is a mesh of 6,144
emissive quads at the default 32 steps, 30,720 in all.

The plates are Yocto `reflective` (a GGX conductor) quads of 8 x 1.4,
their GGX alpha 0.005, 0.02, 0.05 and 0.1 given as Yocto roughness
sqrt(alpha), the smoothest farthest from the camera. Each is centred on
the plane x = 0 and tilted so that the camera's ray through its centre
reflects toward the middle of the light row (its normal halves the
angle between the directions to the camera and to the origin). The floor
(y = -4) and the back wall (z = -2) are matte 0.4. The camera is a
pinhole at (0, 2, 15) looking at (0, -2, 2.5), 28 degrees across a
square film. The background is black (the plain reference has no
environment light).
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes.sphereflake import frame, make_sphere, material

LIGHT_X = (-3.75, -1.25, 1.25, 3.75)
LIGHT_RADII = (0.0333, 0.1, 0.3, 0.9)
LIGHT_RADIANCE = (901.803, 100.0, 11.1111, 1.23457)
FIFTH_LIGHT = ((10.0, 10.0, 4.0), 0.5, 800.0)  # centre, radius, radiance
PLATE_ALPHA = (0.005, 0.02, 0.05, 0.1)  # far to near
PLATE_CENTRES = ((0.0, -1.3, 1.2), (0.0, -1.9, 2.4), (0.0, -2.5, 3.6),
                 (0.0, -3.1, 4.8))
PLATE_HALF = (4.0, 0.7)  # across (x), along the tilt
PLATE_COLOR = (0.8, 0.8, 0.8)
MATTE = (0.4, 0.4, 0.4)
FLOOR_Y, WALL_Z, ROOM_HALF, ROOM_FRONT, ROOM_TOP = -4.0, -2.0, 12.0, 16.0, 12.0
EYE, TARGET, UP = (0.0, 2.0, 15.0), (0.0, -2.0, 2.5), (0.0, 1.0, 0.0)
FOV_DEGREES = 28.0
FILM = 0.024


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def rect(corners) -> dict:
    """One quad of four corners [4, 3]."""
    return {"quads": np.arange(4, dtype=np.int32).reshape(1, 4),
            "positions": np.asarray(corners, np.float32)}


def plate(centre) -> dict:
    """A PLATE_HALF-sized quad at `centre` whose normal halves the angle
    between the directions to the eye and to the origin (the light row's
    middle), wound so that the normal faces them."""
    c = np.asarray(centre, np.float64)
    n = _unit(_unit(np.subtract(EYE, c)) + _unit(-c))
    x = np.array([1.0, 0.0, 0.0])
    s = _unit(np.cross(n, x))
    hx, hs = PLATE_HALF
    return rect([c + a * hx * x + b * hs * s
                 for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1))])


def camera() -> dict:
    """A Yocto/GL pinhole from EYE at TARGET, FOV_DEGREES across the
    square film."""
    eye = np.asarray(EYE, np.float64)
    z = eye - np.asarray(TARGET, np.float64)
    focus = float(np.linalg.norm(z))
    z /= focus
    x = _unit(np.cross(UP, z))
    y = np.cross(z, x)
    lens = FILM / (2.0 * math.tan(math.radians(FOV_DEGREES) / 2.0))
    return {"frame": np.asarray([x, y, z, eye], np.float32), "lens": lens,
            "film": FILM, "aspect": 1.0, "focus": focus, "aperture": 0.0}


def lights() -> list[tuple[tuple, float, float]]:
    """(centre, radius, radiance) of the five sphere lights."""
    row = [((x, 0.0, 0.0), r, e)
           for x, r, e in zip(LIGHT_X, LIGHT_RADII, LIGHT_RADIANCE)]
    return row + [FIFTH_LIGHT]


def build(sphere_steps: int = 32) -> dict:
    h, f = ROOM_HALF, FLOOR_Y
    floor = rect([[-h, f, ROOM_FRONT], [h, f, ROOM_FRONT], [h, f, WALL_Z],
                  [-h, f, WALL_Z]])
    wall = rect([[-h, f, WALL_Z], [h, f, WALL_Z], [h, ROOM_TOP, WALL_Z],
                 [-h, ROOM_TOP, WALL_Z]])
    shapes = ([make_sphere(sphere_steps), floor, wall]
              + [plate(c) for c in PLATE_CENTRES])
    spheres = lights()
    materials = ([material(emission=(e, e, e)) for _, _, e in spheres]
                 + [material("reflective", PLATE_COLOR, roughness=math.sqrt(a))
                    for a in PLATE_ALPHA]
                 + [material(color=MATTE)])
    matte = len(materials) - 1
    eye = np.eye(4, 3, dtype=np.float32)
    instances = ([{"shape": 0, "material": k, "frame": frame(r, c)}
                  for k, (c, r, _) in enumerate(spheres)]
                 + [{"shape": 1, "material": matte, "frame": eye},
                    {"shape": 2, "material": matte, "frame": eye}]
                 + [{"shape": 3 + k, "material": len(spheres) + k,
                     "frame": eye} for k in range(len(PLATE_CENTRES))])
    return {"camera": camera(), "shapes": shapes, "materials": materials,
            "instances": instances}
