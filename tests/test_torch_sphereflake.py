"""The SPD sphereflake (testing.sphereflake_scene, the benchmark's
`sphereflake` configuration) on the CPU: the generator's geometry, the
automatic route at full size (a hybrid of a 4-quad soup and 22,143 work
items, built without the world expansion), and the program's render
against the benchmark's plain reference (benchmark/reference/tracer.py)
at size factor 2, forced through the full cell's route, with the render
mode's own comparison and the cell's limits."""

import math
import time

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.render import scene_device
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    SPHEREFLAKE_COUNTS, cube_sphere, sphereflake_scene, sphereflake_spheres,
)


def _parents(depths):
    """Each sphere's parent (-1 for the root): the spheres come depth
    first, so it is the last one before it a level up."""
    last, out = {}, []
    for i, d in enumerate(depths):
        out.append(last.get(d - 1, -1))
        last[d] = i
    return np.array(out)


@pytest.mark.parametrize("size_factor,count", [(2, 91), (4, 7_381)])
def test_generator_counts_radii_tangency_no_overlap(size_factor, count):
    c, r, depth = sphereflake_spheres(size_factor)
    assert len(c) == count == sum(9 ** k for k in range(size_factor + 1))
    np.testing.assert_allclose(r, 0.5 / 3.0 ** depth, rtol=1e-12)
    par = _parents(depth)
    kids = par >= 0
    assert (np.bincount(par[kids], minlength=count)[depth < size_factor]
            == 9).all()
    gap = np.linalg.norm(c[kids] - c[par[kids]], axis=1) - r[kids] - r[par[kids]]
    assert np.abs(gap).max() < 1e-6  # each child tangent to its parent
    # no two spheres overlap (tangent pairs touch: a gap of -1e-9 at most)
    worst = np.inf
    for s in range(0, count, 1024):
        d = np.linalg.norm(c[s:s + 1024, None] - c[None], axis=-1)
        d -= r[s:s + 1024, None] + r[None]
        d[np.arange(len(d)), np.arange(s, s + len(d))] = np.inf
        worst = min(worst, d.min())
    assert worst > -1e-9
    assert (c[:, 2] - r).min() == pytest.approx(-0.5)  # on the ground


def test_sphere_mesh_is_yocto_make_sphere():
    s = cube_sphere(32)
    assert s.quads.shape == (SPHEREFLAKE_COUNTS["sphere_quads"], 4)
    np.testing.assert_allclose(np.linalg.norm(s.positions, axis=1), 1.0,
                               rtol=1e-6)
    # wound outward: each quad's normal points away from the centre
    p = s.positions[s.quads].astype(np.float64)
    n = np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 1])
    assert ((n * p.mean(axis=1)).sum(axis=1) > 0).all()


def test_full_size_route_is_the_hybrid():
    scene = sphereflake_scene()
    assert len(scene.instances) == SPHEREFLAKE_COUNTS["instances"]
    assert scene_device._should_instance(scene)
    t0 = time.perf_counter()
    _, cfg = build_device_scene(scene, device="cpu")
    assert time.perf_counter() - t0 < 10.0
    assert cfg.n_instances == SPHEREFLAKE_COUNTS["instances"]
    assert cfg.hyb_world_verts.shape == (SPHEREFLAKE_COUNTS["soup"], 4, 3)
    tables = cfg.inst_tables
    assert len(tables.wi_sup) == SPHEREFLAKE_COUNTS["items"]
    # every sphere's three superclusters, the ground and lights in the soup
    assert (np.bincount(tables.wi_inst) == 3).sum() == SPHEREFLAKE_COUNTS["spheres"]
    assert tables.tab.shape[1:] == (32, 16, 128)


def test_program_matches_the_plain_reference(monkeypatch):
    """Size factor 2 with make_sphere(4): the automatic rule would not
    instance 8,740 world quads, so the full cell's route is forced: two
    levels, a hybrid budget that flattens the ground and the lights, the
    spheres kept as work items. Three frames of 32 x 32 pixels against
    the reference on the same (pixel, sample, seed) paths."""
    from benchmark.modes.common import load_json, to_program_scene
    from benchmark.modes.render import check_pixels, compare, reference
    from benchmark.scenes import sphereflake as bench_flake

    desc = bench_flake.build(2, 4)
    scene = to_program_scene(desc)
    monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
    seed, frames = 2 ** 31 + 77, 3
    params = Params(resolution=32, samples=1 << 30, batch=1, bounces=8,
                    sampler="path", clamp=10.0, seed=seed, hybrid_budget=8)
    r = Renderer(scene, params, device="cpu")
    cfg = r.config
    assert cfg.hyb_world_verts.shape == (4, 4, 3)
    assert len(cfg.inst_tables.wi_sup) == 91
    st = make_trace_state(scene, params, device="cpu")
    for _ in range(frames):
        r.trace_samples(st)
    assert st.samples == frames
    pixels = check_pixels(seed, st.width * st.height, 256)
    idx = torch.as_tensor(pixels)
    prog = {k: getattr(st, k)[idx].double().numpy()
            for k in ("image", "albedo", "normal")}
    prog["hits"] = st.hits[idx].long().numpy()
    traffic = {"bounces": 8, "clamp": 10.0}
    ref_mean, ref_hits = reference(desc, traffic, pixels, frames, seed,
                                   st.width, st.height, "cpu")
    got = compare(prog, ref_mean, ref_hits, frames)
    limits = load_json("limits", "flake-path8")
    for name, value in got.items():
        assert math.isfinite(value) and value <= limits[name], (name, value)
    assert prog["hits"].sum() > 0 and np.abs(prog["image"]).sum() > 0
