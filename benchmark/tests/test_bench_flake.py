"""The `sphereflake` configuration and its cell `flake-path8`: its files
are found from BENCHMARK.json, the benchmark's generator is the
program's test scene (testing.sphereflake_scene) field for field, and
the instanced intersector's three readers read nothing on a Cornell run
and numbers on a tiny flake run (size factor 2, forced through the two
levels) on the CPU."""

import json

import numpy as np
import pytest

from benchmark import run
from benchmark.modes import render
from benchmark.modes.common import build_scene, load_json, to_program_scene
from benchmark.tests.test_bench_files import bench, config, n_quads

READERS = ("precull_ms_per_frame.render", "inst_walk_ms_per_frame.render",
           "candidate_share.render")
TINY = {"resolution": 16, "check_pixels": 64}


def test_files_found_from_the_benchmark():
    b = bench()
    cell = {w["name"]: w for w in b["workloads"]}["flake-path8"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "sphereflake", "path8", 1)
    cfg = config("sphereflake")
    assert cfg["scene"] == "sphereflake" and cfg["reduced"] == []
    assert cfg["scene_args"] == {"size_factor": 4, "sphere_steps": 32}
    limits = load_json("limits", "flake-path8")
    assert set(limits) == {"frames_gap", "rgb_err", "aov_err", "hits_err"}
    frame = {m["name"]: m for m in b["end_to_end"]}["frame_ms_p90"]
    assert "flake-path8" in frame["workloads"]
    layer = {m["name"]: m for m in b["per_layer"]}
    for name in READERS:
        m = layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "instanced intersect", "frame_ms_p90", ["flake-path8"])


def test_full_size_counts():
    cfg = config("sphereflake")
    desc = build_scene(cfg)
    assert len(desc["instances"]) == cfg["instances"] == 7_385
    assert n_quads(desc) == cfg["quads"] == 45_348_868
    assert len(desc["shapes"][0]["quads"]) == cfg["sphere_quads"] == 6_144


@pytest.mark.parametrize("args", [(2, 4), (4, 32)])
def test_generator_is_the_programs_test_scene(args):
    from julia_raytracer_tpu_torch.testing import sphereflake_scene

    got = to_program_scene(render.build_scene({"scene": "sphereflake",
                                               "scene_args": dict(zip(
                                                   ("size_factor",
                                                    "sphere_steps"), args))}))
    want = sphereflake_scene(*args)
    assert len(got.shapes) == len(want.shapes)
    for a, b in zip(got.shapes, want.shapes):
        np.testing.assert_array_equal(a.quads, b.quads)
        np.testing.assert_array_equal(a.positions, b.positions)
    assert len(got.instances) == len(want.instances)
    for a, b in zip(got.instances, want.instances):
        assert (a.shape, a.material) == (b.shape, b.material)
        np.testing.assert_array_equal(a.frame, b.frame)
    for a, b in zip(got.materials, want.materials):
        assert (a.type, a.roughness, a.ior) == (b.type, b.roughness, b.ior)
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.emission, b.emission)
    a, b = got.cameras[0], want.cameras[0]
    np.testing.assert_array_equal(a.frame, b.frame)
    assert (a.lens, a.film, a.aspect, a.focus, a.aperture) == (
        b.lens, b.film, b.aspect, b.focus, b.aperture)


def _run(capsys, monkeypatch, cell):
    """run.main on the CPU at a tiny size, trace 1; (result line, Run)."""
    runs = []
    real = render.run

    def keep(r):
        runs.append(r)
        real(r)

    monkeypatch.setattr(render, "run", keep)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                   "--seconds", "0.3", "--trace", "1"], device="cpu",
                  traffic_overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), runs[0]


def test_readers_none_on_cornell(capsys, monkeypatch):
    _, r = _run(capsys, monkeypatch, "cornell-path8")
    for name in READERS:
        assert run.load_reader(name)(r) is None, name


def test_readers_read_a_tiny_flake_run(capsys, monkeypatch):
    from julia_raytracer_tpu_torch.render import scene_device

    def small(cfg):
        return build_scene(dict(cfg, scene_args={"size_factor": 2,
                                                 "sphere_steps": 4}))

    monkeypatch.setattr(render, "build_scene", small)
    monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
    out, _ = _run(capsys, monkeypatch, "flake-path8")
    assert out["correct"] is True
    for name in READERS:
        value = out["metrics"][name]["value"]
        assert value > 0, name
    assert out["metrics"]["candidate_share.render"]["value"] <= 100.0
