"""Subdivision tessellation in the port (scene/objio.py, scene/subdiv.py,
the loader's _apply_subdivs) against the JAX package's, on cages written
to tmp_path by testing.write_cube_cage (no corpus): a cube, and a cube
with face-varying texcoords (a UV island a face) and a displacement
texture.

  - load_obj_cage, catmull_clark and tessellate_subdiv bit-equal to the
    JAX functions at 0-3 levels, smooth or not, displaced or not;
  - the loader tessellates a shape whose PLY is empty, and under
    load_scene(tessellate=True) every subdiv's shape, as the JAX loader
    does by default and under JRT_TESSELLATE=1: the scenes equal field
    for field, and the warnings printed are the same;
  - the tessellated scene renders on the CPU through the worklist
    intersector's plain version (over 112 quads)."""

import dataclasses
import os

import numpy as np
import pytest

from julia_raytracer_tpu.scene import loader as jloader
from julia_raytracer_tpu.scene import objio as jobjio
from julia_raytracer_tpu.scene import subdiv as jsubdiv
from julia_raytracer_tpu.scene import types as jt
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.scene import loader as tloader
from julia_raytracer_tpu_torch.scene import objio, subdiv
from julia_raytracer_tpu_torch.scene.types import TextureData
from julia_raytracer_tpu_torch.testing import (
    subdiv_cube_scene, write_cube_cage, write_yocto_scene,
)
from torch_parity import _mirror


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """Written scenes get disk-cache keys: keep the cache in tmp_path."""
    monkeypatch.setenv("JRT_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture(params=["cube", "uv_cube"])
def cage(request, tmp_path):
    return write_cube_cage(str(tmp_path / f"{request.param}.obj"),
                           center=(0.1, 0.2, -0.3), half=0.4,
                           texcoords=request.param == "uv_cube")


def _disp_texture():
    g = np.random.default_rng(2)
    w, h = 7, 5
    return TextureData(width=w, height=h,
                       pixels=g.random((w * h, 4)).astype(np.float32))


def test_load_obj_cage_matches_jax(cage):
    got, want = objio.load_obj_cage(cage), jobjio.load_obj_cage(cage)
    _same(got, want)
    assert (got[3] is not None) == cage.endswith("uv_cube.obj")


@pytest.mark.parametrize("levels", [0, 1, 3])
def test_catmull_clark_matches_jax(cage, levels):
    pos, faces, nsides, uvs, vt_faces = objio.load_obj_cage(cage)
    _same(subdiv.catmull_clark(pos, faces, nsides, levels),
          jsubdiv.catmull_clark(pos, faces, nsides, levels))
    if uvs is not None:
        _same(subdiv.catmull_clark(uvs, vt_faces, nsides, levels, True),
              jsubdiv.catmull_clark(uvs, vt_faces, nsides, levels, True))


@pytest.mark.parametrize("levels", [0, 2])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("displaced", [False, True])
def test_tessellate_subdiv_matches_jax(cage, levels, smooth, displaced):
    kw = {}
    if displaced:
        tex = _disp_texture()
        kw = dict(displacement=0.05, disp_tex=tex)
        jkw = dict(displacement=0.05, disp_tex=_mirror(tex, jt.TextureData))
    else:
        jkw = {}
    got = subdiv.tessellate_subdiv(cage, levels, smooth, **kw)
    want = jsubdiv.tessellate_subdiv(cage, levels, smooth, **jkw)
    _same(got, want)
    assert len(got[1]) == 6 * 4 ** levels


def _write_subdiv_scene(tmp_path, levels=2, box_uvs=False):
    """The Cornell box with subdiv_cube_scene's empty cube (its cage at
    `levels`), and a second subdiv over the short box (shape 3), which has
    a mesh and so is tessellated only when forced: with a UV cage, or
    with `box_uvs` (the box given texcoords) a cage without texcoords."""
    cage = write_cube_cage(str(tmp_path / "cage.obj"), center=(0.3, 1.4, 0.3),
                           half=0.18)
    box_cage = write_cube_cage(str(tmp_path / "box_cage.obj"), half=0.2,
                               texcoords=not box_uvs)
    scene = subdiv_cube_scene(cage, levels)
    if box_uvs:
        box = scene.shapes[3]
        box.texcoords = np.zeros((len(box.positions), 2), np.float32)
    scene.subdivs.append(dataclasses.replace(scene.subdivs[0], subdivisions=1,
                                             shape=3, uri=box_cage))
    return write_yocto_scene(scene, str(tmp_path / "scene"))


def _assert_same_scene(got, want):
    assert len(got.shapes) == len(want.shapes)
    for a, b in zip(got.shapes, want.shapes):
        for name in ("positions", "quads", "triangles", "normals",
                     "texcoords", "colors"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("force", [False, True])
def test_loader_tessellates_like_jax(tmp_path, monkeypatch, capsys, force):
    path = _write_subdiv_scene(tmp_path)
    if force:
        monkeypatch.setenv("JRT_TESSELLATE", "1")
    else:
        monkeypatch.delenv("JRT_TESSELLATE", raising=False)
    want = jloader.load_scene(path)
    want_err = capsys.readouterr().err
    got = tloader.load_scene(path, tessellate=force)
    got_err = capsys.readouterr().err
    _assert_same_scene(got, want)
    assert got_err == want_err
    cube = got.shapes[-1]
    assert len(cube.quads) == 6 * 4 ** 2 and len(cube.normals) == len(cube.positions)
    short_box = got.shapes[3]
    assert len(short_box.quads) == (6 * 4 if force else 6)
    assert ("loses its UVs" in got_err) is False
    # untessellated, the empty shape stays empty only without its cage
    os.remove(os.path.join(os.path.dirname(path), "subdivs", "subdiv0.obj"))
    assert len(tloader.load_scene(path, tessellate=force).shapes[-1].positions) == 0


def test_loader_warnings_match_jax(tmp_path, monkeypatch, capsys):
    """A cage that fails (a 5-gon face) and, forced, a cage without
    texcoords over a textured shape: the JAX loader's warnings, and the
    same scene (the failed shape stays empty)."""
    path = _write_subdiv_scene(tmp_path, box_uvs=True)
    cage = os.path.join(os.path.dirname(path), "subdivs", "subdiv0.obj")
    with open(cage, "a") as f:
        f.write("f 1 2 3 4 5\n")
    monkeypatch.setenv("JRT_TESSELLATE", "1")
    want = jloader.load_scene(path)
    want_err = capsys.readouterr().err
    got = tloader.load_scene(path, tessellate=True)
    got_err = capsys.readouterr().err
    _assert_same_scene(got, want)
    assert "subdiv tessellation failed" in got_err
    assert "loses its UVs" in got_err
    assert got_err == want_err
    assert len(got.shapes[-1].positions) == 0


def test_tessellated_scene_renders(tmp_path):
    scene = tloader.load_scene(_write_subdiv_scene(tmp_path))
    params = tren.Params(resolution=8, samples=1, bounces=2)
    r = tren.Renderer(scene, params, device="cpu")
    assert r.config.n_prims == 18 + 6 * 4 ** 2
    assert isinstance(r.intersect.tables, wl.WorklistTables)  # not dense
    st = tren.make_trace_state(scene, params, device="cpu")
    r.trace_samples(st)
    img = r.get_image(st)
    assert np.isfinite(img).all() and img[..., :3].mean() > 0
