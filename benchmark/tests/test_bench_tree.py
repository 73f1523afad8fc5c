"""The `spd-tree` configuration and its cell `tree-path8`: BENCHMARK.json
names every file the cell adds and they load (configuration, scene,
traffic, mode, limits, readers), the traffic is path8's with the
render_curves mode, the mode runs end to end at a tiny size on the CPU,
the curve readers read nothing on a Cornell run and numbers on a tiny
tree run with the culled walk forced onto the CPU, and the control and
a planted fault fail the cell's limits."""

import importlib
import json
import os

import pytest

from benchmark import control_curves, run
from benchmark.modes import render_curves
from benchmark.modes.common import load_json
from benchmark.tests.test_bench_files import ROOT, bench, config

READERS = ("curve_walk_ms_per_frame.render", "curve_tested_share.render",
           "curve_cull_ms_per_frame.render")
ROOFLINE = "curve_walk_roofline.render"
TINY = {"resolution": 16, "check_pixels": 64}


def test_files_named_by_the_benchmark():
    b = bench()
    cell = {w["name"]: w for w in b["workloads"]}["tree-path8"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "spd-tree", "path8-curves", 1)
    c = {c["name"]: c for c in b["configs"]}["spd-tree"]
    assert c["file"] == "benchmark/configs/spd_tree.json"
    cfg = config("spd-tree")
    assert cfg["scene"] == "spd_tree" and cfg["reduced"] == []
    assert cfg["scene_args"] == {"size_factor": 11}
    assert importlib.import_module("benchmark.scenes.spd_tree")
    traffic = load_json("workloads", "path8-curves")
    assert importlib.import_module("benchmark.modes." + traffic["mode"])
    assert set(load_json("limits", "tree-path8")) == {
        "frames_gap", "rgb_err", "aov_err", "hits_err"}
    frame = {m["name"]: m for m in b["end_to_end"]}["frame_ms_p90"]
    assert "tree-path8" in frame["workloads"]
    layer = {m["name"]: m for m in b["per_layer"]}
    for name in READERS + (ROOFLINE,):
        m = layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "curve intersect", "frame_ms_p90", ["tree-path8"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           name + ".py"))
    for path in ("benchmark/reference/curves.py", "benchmark/control_curves.py",
                 "benchmark/metrics/_curve_cost.py"):
        assert os.path.exists(os.path.join(ROOT, path))


def test_traffic_is_path8_with_the_curves_mode():
    path8 = load_json("workloads", "path8")
    curves = load_json("workloads", "path8-curves")
    assert curves.pop("mode") == "render_curves" and path8.pop("mode") == "render"
    curves.pop("why"), path8.pop("why")
    assert curves == path8


def test_config_assumes_the_points():
    cfg = config("spd-tree")
    assumed = " ".join(cfg["assumed"])
    for word in ("branching angles", "contraction ratios",
                 "divergence angle", "width contraction", "trunk", "camera",
                 "lights", "materials", "Yocto/GL points"):
        assert word in assumed, word


def _run(capsys, monkeypatch, cell, trace=1):
    """run.main on the CPU at a tiny size; (result line, Run)."""
    runs = []
    mode = render_curves if cell == "tree-path8" else importlib.import_module(
        "benchmark.modes.render")
    real = mode.run

    def keep(r):
        runs.append(r)
        real(r)

    monkeypatch.setattr(mode, "run", keep)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 7),
                   "--seconds", "0.3", "--trace", str(trace)], device="cpu",
                  traffic_overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), runs[0]


def _small_tree(monkeypatch):
    from benchmark.modes import common

    real = common.build_scene

    def small(cfg):
        return real(dict(cfg, scene_args={"size_factor": 4}))

    monkeypatch.setattr(render_curves, "build_scene", small)


@pytest.mark.parametrize("trace", [0, 1])
def test_mode_end_to_end(capsys, monkeypatch, trace):
    _small_tree(monkeypatch)
    out, _ = _run(capsys, monkeypatch, "tree-path8", trace)
    assert out["correct"] is True and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"frame_ms_p90", "setup_s"}


def test_readers_none_on_cornell(capsys, monkeypatch):
    _, r = _run(capsys, monkeypatch, "cornell-path8")
    for name in READERS + (ROOFLINE,):
        assert run.load_reader(name)(r) is None, name


def test_readers_read_a_tiny_tree_run(capsys, monkeypatch):
    """The culled walk forced onto the CPU: the span readers read numbers;
    the roofline, which needs the card's device trace, reads none."""
    from julia_raytracer_tpu_torch.render import integrator

    _small_tree(monkeypatch)
    monkeypatch.setattr(integrator, "CURVE_WALK_DEVICES", ("cpu", "cuda"))
    out, _ = _run(capsys, monkeypatch, "tree-path8")
    assert out["correct"] is True
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["curve_tested_share.render"]["value"] < 100.0
    assert ROOFLINE not in out["metrics"]


def test_roofline_share_is_a_floor():
    """The walk's least work a call: the rays and hits, the table once,
    one line and one point test a ray."""
    from benchmark.metrics import _curve_cost

    n_bytes, ops = _curve_cost.cost(1 << 20, 8190)
    assert n_bytes == (1 << 20) * 56 + 8190 * 32 and ops == (1 << 20) * 100
    assert _curve_cost.bound_s(1 << 20, 8190) == pytest.approx(
        n_bytes / 3.35e12)


def test_control_and_fault_fail():
    w = {w["name"]: w for w in bench()["workloads"]}["tree-path8"]
    traffic = dict(load_json("workloads", w["traffic"]), resolution=24,
                   check_pixels=96)
    cfg = dict(config(w["config"]), scene_args={"size_factor": 4})
    got = control_curves.control(cfg, traffic, 2 ** 31 + 3, 4, "cpu")
    limits = load_json("limits", "tree-path8")
    for reading in ("control", "altered"):
        assert any(v > limits[k] for k, v in got[reading].items()), reading
