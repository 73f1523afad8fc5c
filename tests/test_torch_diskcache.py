"""utils/diskcache.py and the disk cache through the scene set-up
(render/renderer.py, render/scene_device.py, ops/cluster_tables.py,
utils/kernel_select.py, render/integrator.py), every test with
JRT_CACHE_DIR in tmp_path.

  - the content key equals the JAX package's scene_cache_key for the same
    scene file and tokens when the version token is made equal, and
    differs with the port's own token;
  - editing a PLY of the scene changes the key;
  - a second Renderer on a written scene, with the save threshold
    lowered to 0, reads every product and calls no builder (the builders
    that make cached products are replaced by functions that raise), and
    its sample is bit-equal to the first's: the flat build (products
    "geom", "clusters", "kernel_select") and the hybrid build
    ("hybrid300", the soup's "clusters" and "kernel_select");
  - the kernel-select product's key changes with the SelectCosts, so new
    costs never read an old decision;
  - a hybrid soup or kernel choice saved for another source under the
    same key (a tessellated load, a scene edited in code) is rebuilt,
    not reused;
  - four processes saving the same product at once leave one whole
    product and no temporary file.

Tolerance: none; keys and images are compared for equality."""

import os
import subprocess
import sys

import numpy as np
import pytest

from julia_raytracer_tpu.utils import diskcache as jax_diskcache
from julia_raytracer_tpu_torch.ops import cluster_tables as ct
from julia_raytracer_tpu_torch.render import scene_device
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.scene.loader import load_scene
from julia_raytracer_tpu_torch.testing import (
    hybrid_scene, sphere_grid_scene, write_yocto_scene,
)
from julia_raytracer_tpu_torch.utils import diskcache, kernel_select

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    path = tmp_path / "cache"
    monkeypatch.setenv("JRT_CACHE_DIR", str(path))
    return path


@pytest.fixture(scope="module")
def grid_path(tmp_path_factory):
    return write_yocto_scene(sphere_grid_scene(2, 8),
                             tmp_path_factory.mktemp("grid"))


def test_key_matches_jax(grid_path, monkeypatch):
    tokens = ("mid", "sky0:env-")
    ours = diskcache.scene_cache_key(grid_path, *tokens)
    assert ours and ours != jax_diskcache.scene_cache_key(grid_path, *tokens)
    monkeypatch.setattr(diskcache, "BUILDER_VERSION",
                        jax_diskcache.BUILDER_VERSION)
    assert (diskcache.scene_cache_key(grid_path, *tokens)
            == jax_diskcache.scene_cache_key(grid_path, *tokens))
    assert diskcache.scene_cache_key(str(grid_path) + ".missing") == ""


def test_editing_a_ply_changes_the_key(tmp_path):
    path = write_yocto_scene(sphere_grid_scene(2, 8), tmp_path / "scene")
    before = diskcache.scene_cache_key(path, "mid")
    plys = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "scene")
            for f in fs if f.endswith(".ply")]
    assert plys
    with open(plys[0], "ab") as f:
        f.write(b"\0")
    assert diskcache.scene_cache_key(path, "mid") != before


def _raises(*_args, **_kwargs):
    raise AssertionError("a builder ran on a warm build")


def _sample(scene, params):
    r = Renderer(scene, params, device="cpu")
    st = make_trace_state(scene, params, device="cpu")
    r.trace_samples(st)
    return r, r.get_image(st)


@pytest.mark.parametrize("case", ["flat", "hybrid"])
def test_warm_build_calls_no_builder(case, tmp_path, cache, monkeypatch):
    monkeypatch.setattr(diskcache, "CACHE_MIN_PRIMS", 0)
    if case == "flat":
        path = write_yocto_scene(sphere_grid_scene(2, 8), tmp_path / "scene")
        fields, builders = {}, [
            (scene_device, "build_bvh"), (scene_device, "build_lights_np"),
            (ct, "build_cluster_tables"), (kernel_select, "predict_ratio")]
        tags = {"geom", "clusters", "kernel_select"}
    else:
        monkeypatch.setattr(scene_device, "INSTANCING_MIN_FLAT", 0)
        monkeypatch.setattr(scene_device, "INSTANCING_MIN_RATIO", 1.0)
        path = write_yocto_scene(hybrid_scene(4, 4, 3, 12), tmp_path / "scene")
        fields, builders = {"hybrid_budget": 300}, [
            (scene_device, "build_world_flat"), (ct, "build_cluster_tables"),
            (kernel_select, "predict_ratio")]
        tags = {"hybrid300", "clusters", "kernel_select"}
    params = Params(scene=path, resolution=16, samples=1, batch=1, bounces=2,
                    regroup_min_prims=0, **fields)
    cold, img_cold = _sample(load_scene(path), params)
    if case == "hybrid":
        assert cold.config.hyb_world_verts is not None
    saved = {f.split("_", 1)[1][:-4] for f in os.listdir(cache)}
    assert tags <= saved, saved
    for module, name in builders:
        monkeypatch.setattr(module, name, _raises)
    warm, img_warm = _sample(load_scene(path), params)
    assert warm.config.cache_key == cold.config.cache_key != ""
    np.testing.assert_array_equal(img_warm, img_cold)


def test_scene_without_file_is_not_cached(cache, monkeypatch):
    monkeypatch.setattr(diskcache, "CACHE_MIN_PRIMS", 0)
    params = Params(scene="", resolution=8, samples=1, batch=1, bounces=1)
    r = Renderer(sphere_grid_scene(2, 8), params, device="cpu")
    assert r.config.cache_key == ""
    assert not cache.exists() or not os.listdir(cache)


def test_select_key_covers_costs(monkeypatch):
    base = kernel_select.H100_COSTS
    other = base._replace(us_wl_pass=base.us_wl_pass * 2)
    assert kernel_select.select_cache_key("", base) == ""
    assert (kernel_select.select_cache_key("k", base)
            != kernel_select.select_cache_key("k", other))
    calls = []

    def predict(*args, **kwargs):
        calls.append(kwargs["costs"])
        return dict(ratio=0.1 if kwargs["costs"] == base else 0.9)

    monkeypatch.setattr(kernel_select, "predict_ratio", predict)
    verts = np.zeros((4, 4, 3), np.float32)
    first = kernel_select.select_bounce_kernel(verts, None, base, cache_key="k")
    again = kernel_select.select_bounce_kernel(verts, None, base, cache_key="k")
    refit = kernel_select.select_bounce_kernel(verts, None, other,
                                               cache_key="k")
    assert first == again and first["kernel"] == "regroup"
    assert refit["kernel"] == "worklist"
    assert calls == [base, other]


@pytest.mark.parametrize("product", ["hybrid", "kernel_select"])
def test_product_of_another_source_is_rebuilt(product, monkeypatch):
    monkeypatch.setattr(diskcache, "CACHE_MIN_PRIMS", 0)
    if product == "hybrid":
        def build(scene, key):
            return scene_device.build_device_scene_instanced(
                scene, hybrid_budget=300, device="cpu",
                cache_key=key)[1].hyb_world_verts

        first = build(hybrid_scene(4, 4, 3, 12), "k")
        edited = hybrid_scene(3, 4, 3, 12)
        want = build(edited, "")
        assert first is not None and len(want) != len(first)
        np.testing.assert_array_equal(build(edited, "k"), want)
        return
    calls = []

    def predict(verts, *args, **kwargs):
        calls.append(len(verts))
        return dict(ratio=0.1)

    monkeypatch.setattr(kernel_select, "predict_ratio", predict)
    for q in (4, 6, 6):
        kernel_select.select_bounce_kernel(np.zeros((q, 4, 3), np.float32),
                                           None, cache_key="k")
    assert calls == [4, 6]


SAVER = r"""
import numpy as np
from julia_raytracer_tpu_torch.utils import diskcache
a = np.arange(1 << 20, dtype=np.float32)
for _ in range(10):
    diskcache.save_arrays("key", "product", dict(a=a, b=a[::7].copy()))
"""


def test_concurrent_saves_leave_a_whole_product(cache):
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", SAVER], env=env, cwd=ROOT)
             for _ in range(4)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = diskcache.load_arrays("key", "product")
    want = np.arange(1 << 20, dtype=np.float32)
    np.testing.assert_array_equal(got["a"], want)
    np.testing.assert_array_equal(got["b"], want[::7])
    assert os.listdir(cache) == ["key_product.npz"]
