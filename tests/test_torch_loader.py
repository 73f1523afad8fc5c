"""The port's Yocto JSON + PLY loader (scene/loader.py, scene/ply.py,
utils/imgio.py) against the JAX package's, field for field, on a small
scene written in tmp_path: an ASCII PLY of quads with normals and float
texcoords, a binary little-endian PLY of triangles with byte colors, a
PNG texture (PIL) and an HDR texture (cv2), lookat and frame transforms.
Scenes written by testing.write_yocto_scene read back field for field in
both packages.
"""

import dataclasses
import json

import numpy as np
import pytest

from julia_raytracer_tpu.scene.loader import load_scene as jax_load_scene
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.scene.loader import load_scene
from julia_raytracer_tpu_torch.scene.types import (
    EnvironmentData, MaterialData, MaterialType, ShapeData, TextureData,
)
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, sphere_grid_scene, write_yocto_scene,
)
from torch_parity import to_jax_scene


def _ascii_quads(path):
    verts = [(-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1),
             (-1, 1, -1), (1, 1, -1)]
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             "property float nx", "property float ny", "property float nz",
             "property float u", "property float v",
             "element face 2", "property list uchar int vertex_indices",
             "end_header"]
    for k, (x, y, z) in enumerate(verts):
        lines.append(f"{x} {y} {z} 0 1 0 {0.25 * k} {0.1 * k + 0.05}")
    lines += ["4 0 1 2 3", "4 0 4 5 1"]
    path.write_text("\n".join(lines) + "\n")


def _binary_triangles(path, g):
    n = 9
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    vert = np.zeros(n, dtype)
    pos = g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    for k, name in enumerate("xyz"):
        vert[name] = pos[:, k]
    for name in ("red", "green", "blue"):
        vert[name] = g.integers(0, 256, n)
    faces = np.zeros(3, np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    faces["n"] = 3
    faces["i"] = np.arange(9).reshape(3, 3)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        "element face 3", "property list uchar int vertex_indices",
        "end_header"]) + "\n"
    path.write_bytes(header.encode() + vert.tobytes() + faces.tobytes())


def _write_scene(tmp_path):
    from PIL import Image
    import cv2

    g = np.random.default_rng(3)
    _ascii_quads(tmp_path / "quads.ply")
    _binary_triangles(tmp_path / "tris.ply", g)
    Image.fromarray(g.integers(0, 256, (4, 5, 4), dtype=np.uint8), "RGBA").save(
        tmp_path / "color.png")
    cv2.imwrite(str(tmp_path / "sky.hdr"),
                g.uniform(0.0, 4.0, (3, 6, 3)).astype(np.float32))
    scene = {
        "asset": {"generator": "test"},
        "cameras": [{"name": "camera", "lookat": [0, 1, 4, 0, 0.5, 0, 0, 1, 0],
                     "lens": 0.035, "aspect": 1.0, "film": 0.024}],
        "textures": [{"uri": "color.png"}, {"uri": "sky.hdr"}],
        "materials": [
            {"type": "matte", "color": [0.7, 0.6, 0.5], "color_tex": 0},
            {"type": "glossy", "color": [0.2, 0.3, 0.9], "roughness": 0.25},
            {"type": "reflective", "color": [0.9, 0.8, 0.4], "roughness": 0.1},
        ],
        "shapes": [{"uri": "quads.ply"}, {"uri": "tris.ply"}],
        "instances": [
            {"shape": 0, "material": 0},
            {"shape": 1, "material": 1,
             "frame": [1, 0, 0, 0, 1, 0, 0, 0, 1, 0.2, 0.3, -0.1]},
            {"shape": 1, "material": 2, "lookat": [0.5, 0.4, 0.2, 0, 0, 0, 0, 1, 0]},
        ],
        "environments": [{"emission": [0.5, 0.5, 0.5], "emission_tex": 1}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene))
    return path


def _assert_same(got, want, where):
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(got):
            _assert_same(getattr(got, f.name), getattr(want, f.name),
                         f"{where}.{f.name}")
    elif isinstance(got, list):
        assert len(got) == len(want), where
        for k, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{k}]")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("parallel", [False, True])
def test_load_scene_matches_jax(tmp_path, parallel):
    path = _write_scene(tmp_path)
    got = load_scene(str(path), parallel=parallel)
    want = jax_load_scene(str(path), parallel=parallel)
    _assert_same(got, want, "scene")
    assert got.shapes[0].quads.shape == (2, 4)
    assert got.shapes[1].triangles.shape == (3, 3)
    assert got.textures[0].width == 5 and got.textures[1].linear
    assert len(got.shapes[1].colors) == 9 and got.shapes[1].colors.max() <= 1.0


def test_loaded_scene_renders_on_cpu(tmp_path):
    scene = load_scene(str(_write_scene(tmp_path)))
    params = tren.Params(resolution=8, samples=1, bounces=2)
    r = tren.Renderer(scene, params, device="cpu")
    st = tren.make_trace_state(scene, params, device="cpu")
    r.trace_samples(st)
    assert np.isfinite(r.get_image(st)).all()


def test_tessellation_is_refused(tmp_path):
    """Where the JAX package tessellates by default (an empty shape whose
    subdivision cage exists), the port now tessellates too, as the JAX
    loader does; without the cage the shape stays empty."""
    path = _write_scene(tmp_path)
    j = json.loads(path.read_text())
    (tmp_path / "empty.ply").write_text(
        "ply\nformat binary_little_endian 1.0\nelement vertex 0\nproperty float x\n"
        "property float y\nproperty float z\nend_header\n")
    (tmp_path / "cage.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                       "f 1 2 3 4\n")
    j["shapes"].append({"uri": "empty.ply"})
    j["subdivs"] = [{"shape": 2, "uri": "cage.obj", "subdivisions": 1}]
    path.write_text(json.dumps(j))
    got = load_scene(str(path))
    want = jax_load_scene(str(path))
    assert got.shapes[2].quads.shape == (4, 4)
    np.testing.assert_array_equal(got.shapes[2].positions,
                                  want.shapes[2].positions)
    np.testing.assert_array_equal(got.shapes[2].quads, want.shapes[2].quads)
    j["subdivs"][0]["uri"] = "missing.obj"  # no cage: nothing to tessellate
    path.write_text(json.dumps(j))
    assert len(load_scene(str(path)).shapes[2].positions) == 0


def _attribute_scene():
    """The Cornell box plus a textured, coloured shape with normals,
    texcoords (multiples of 1/8, which the v flip keeps exact), lines,
    points and radii, every material type, and an environment."""
    g = np.random.default_rng(4)
    scene = cornell_scene()
    pos = g.uniform(-1, 1, (6, 3)).astype(np.float32)
    scene.shapes.append(ShapeData(
        quads=np.array([[0, 1, 2, 3], [2, 3, 4, 4]], np.int32),
        lines=np.array([[0, 5], [5, 1]], np.int32),
        points=np.array([4, 5], np.int32), positions=pos,
        normals=g.normal(size=(6, 3)).astype(np.float32),
        texcoords=(g.integers(0, 9, (6, 2)) / 8).astype(np.float32),
        colors=g.uniform(0, 1, (6, 4)).astype(np.float32),
        radius=g.uniform(0, 0.1, 6).astype(np.float32)))
    pixels = g.integers(0, 256, (3 * 5, 4)).astype(np.float32) / 255.0
    scene.textures.append(TextureData(width=5, height=3, pixels=pixels))
    for t in MaterialType:
        scene.materials.append(MaterialData(
            type=t, color=g.uniform(0, 1, 3).astype(np.float32),
            roughness=float(g.uniform()), color_tex=0, ior=1.33))
    scene.environments.append(EnvironmentData(
        emission=np.array([0.5, 0.25, 2.0], np.float32), emission_tex=0))
    return scene


@pytest.mark.parametrize("make", [cornell_scene, lambda: sphere_grid_scene(2, 8),
                                  _attribute_scene])
def test_written_scene_reads_back(tmp_path, make):
    scene = make()
    path = write_yocto_scene(scene, tmp_path)
    _assert_same(load_scene(path), scene, "port")
    _assert_same(jax_load_scene(path), to_jax_scene(scene), "jax")
