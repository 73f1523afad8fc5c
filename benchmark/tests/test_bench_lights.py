"""The `veach-mis` configuration and its cell `manylights-path8`:
BENCHMARK.json names every file the cell adds and they load
(configuration, scene, traffic, mode, limits, readers), the scene has
the configuration's counts, the traffic is path8's with the
render_lights mode, the mode runs end to end at a tiny size on the CPU
and stops on a route it does not measure, the span readers read numbers
there and nothing on a Cornell run, the reference samples the lights'
quads in the order it is given and refuses one that is not the light's
own quads (tests/test_torch_veach_mis.py holds its pdf to the loop's),
and the control and the planted faults fail the cell's limits."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark import control_lights, run
from benchmark.modes import render_lights
from benchmark.modes.common import load_json
from benchmark.reference import lights
from benchmark.scenes import veach_mis
from benchmark.tests.test_bench_files import ROOT, bench, config, n_quads

SPANS = ("march_ms_per_frame.render", "march_live_share.render",
         "worklist_ms_per_frame.render")
ROOFLINE = "worklist_roofline.render"
LAYERS = {"march_ms_per_frame.render": "light pdf march",
          "march_live_share.render": "light pdf march",
          "worklist_ms_per_frame.render": "worklist intersect",
          ROOFLINE: "worklist intersect"}
TINY = {"resolution": 16, "check_pixels": 64}
# the smallest sphere whose five lights are still past EXACT_ELEMS
SMALL = {"sphere_steps": 16}


def test_files_named_by_the_benchmark():
    b = bench()
    cell = {w["name"]: w for w in b["workloads"]}["manylights-path8"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "veach-mis", "path8-lights", 1)
    c = {c["name"]: c for c in b["configs"]}["veach-mis"]
    assert c["file"] == "benchmark/configs/veach_mis.json"
    assert c["reduced"] == []
    cfg = config("veach-mis")
    assert cfg["scene"] == "veach_mis" and cfg["reduced"] == []
    assert cfg["scene_args"] == {"sphere_steps": 32}
    traffic = load_json("workloads", "path8-lights")
    assert importlib.import_module("benchmark.modes." + traffic["mode"])
    assert set(load_json("limits", "manylights-path8")) == {
        "frames_gap", "rgb_err", "aov_err", "hits_err"}
    frame = {m["name"]: m for m in b["end_to_end"]}["frame_ms_p90"]
    assert frame["workloads"][-1] == "manylights-path8"
    layer = {m["name"]: m for m in b["per_layer"]}
    for name, want in LAYERS.items():
        m = layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            want, "frame_ms_p90", ["manylights-path8"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           name + ".py"))
    for path in ("benchmark/reference/lights.py", "benchmark/control_lights.py",
                 "benchmark/metrics/_worklist_cost.py"):
        assert os.path.exists(os.path.join(ROOT, path))


def test_config_counts():
    cfg = config("veach-mis")
    desc = veach_mis.build(**cfg["scene_args"])
    emissive = [i for i in desc["instances"]
                if np.abs(desc["materials"][i["material"]]["emission"]).sum()]
    assert len(emissive) == cfg["spheres"] == 5
    assert {i["shape"] for i in emissive} == {0}
    assert len(desc["shapes"][0]["quads"]) == cfg["sphere_quads"] == 6144
    assert cfg["emissive_quads"] == 5 * 6144 == 30720
    assert n_quads(desc) == cfg["quads"]
    radiance = [float(desc["materials"][i["material"]]["emission"][0])
                for i in emissive]
    power = [r * r * e for r, e in zip(veach_mis.LIGHT_RADII, radiance)]
    assert max(power) / min(power) < 1.001  # the row's four emit alike
    assumed = " ".join(cfg["assumed"])
    for word in ("light row", "radii and radiances", "fifth light",
                 "sqrt(alpha)", "plates' rectangles", "floor and wall",
                 "camera", "background", "float32"):
        assert word in assumed, word


def test_traffic_is_path8_with_the_lights_mode():
    path8 = load_json("workloads", "path8")
    mine = load_json("workloads", "path8-lights")
    assert mine.pop("mode") == "render_lights" and path8.pop("mode") == "render"
    mine.pop("why"), path8.pop("why")
    assert mine == path8


def _run(capsys, monkeypatch, cell, trace=1):
    """run.main on the CPU at a tiny size; (result line, Run)."""
    runs = []
    mode = render_lights if cell == "manylights-path8" else \
        importlib.import_module("benchmark.modes.render")
    real = mode.run

    def keep(r):
        runs.append(r)
        real(r)

    monkeypatch.setattr(mode, "run", keep)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 11),
                   "--seconds", "0.3", "--trace", str(trace)], device="cpu",
                  traffic_overrides=TINY)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), runs[0]


def _small_scene(monkeypatch):
    from benchmark.modes import common

    real = common.build_scene

    def small(cfg):
        return real(dict(cfg, scene_args=SMALL))

    monkeypatch.setattr(render_lights, "build_scene", small)


@pytest.mark.parametrize("trace", [0, 1])
def test_mode_end_to_end(capsys, monkeypatch, trace):
    _small_scene(monkeypatch)
    out, _ = _run(capsys, monkeypatch, "manylights-path8", trace)
    assert out["correct"] is True and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"frame_ms_p90", "setup_s"}
        return
    for name in SPANS:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["march_live_share.render"]["value"] <= 100.0
    # the roofline needs the card's device trace
    assert ROOFLINE not in out["metrics"]


def test_mode_refuses_another_route(monkeypatch):
    """A march budget other than the one measured stops the run."""
    _small_scene(monkeypatch)
    real = render_lights.params
    monkeypatch.setattr(render_lights, "params", lambda tr, seed: real(
        tr, seed, light_pdf_extra_steps=4))
    with pytest.raises(SystemExit, match="8 steps"):
        run.main(["--workload", "manylights-path8", "--seed", "3",
                  "--seconds", "0.1"], device="cpu", traffic_overrides=TINY)


def test_readers_none_on_cornell(capsys, monkeypatch):
    _, r = _run(capsys, monkeypatch, "cornell-path8")
    for name in SPANS + (ROOFLINE,):
        assert run.load_reader(name)(r) is None, name


def test_light_order_permutes_the_sampled_quads():
    """The reference in a given light order samples the quads that order
    lists; an order that lists another light's quads is refused."""
    desc = veach_mis.build(sphere_steps=4)
    own = lights.emissive_quads(desc).astype(np.float64).mean(1)
    per = len(own) // 5
    g = np.random.default_rng(1)
    perms = [g.permutation(per) for _ in range(5)]
    order = [own[k * per:(k + 1) * per][p] for k, p in enumerate(perms)]
    sc = lights.Scene(desc, "cpu", light_order=order)
    for k, p in enumerate(perms):
        assert torch.equal(sc.light_pick[k], torch.as_tensor(p + k * per))
    with pytest.raises(ValueError, match="own quads"):
        lights.Scene(desc, "cpu", light_order=[order[1]] + order[1:])


def test_roofline_bound():
    from benchmark.metrics import _worklist_cost

    assert _worklist_cost.bound_s(67e12, 0) == pytest.approx(1.0)
    assert _worklist_cost.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_cost_frames_left_out(monkeypatch):
    """The frames run under the cost count, the last ones, are not the
    window readers'; none left reads None."""
    import types

    from benchmark.metrics import _units, _worklist_cost

    monkeypatch.setattr(_units, "window_units", lambda run, name: [1, 2, 3])
    run_ = types.SimpleNamespace(counters={"worklist_cost_units": 2})
    assert _worklist_cost.window_frames(run_) == [1]
    run_.counters = {}
    assert _worklist_cost.window_frames(run_) == [1, 2, 3]
    run_.counters = {"worklist_cost_units": 3}
    assert _worklist_cost.window_frames(run_) is None


def test_control_and_faults_fail():
    w = {w["name"]: w for w in bench()["workloads"]}["manylights-path8"]
    traffic = dict(load_json("workloads", w["traffic"]), resolution=16,
                   check_pixels=96)
    cfg = dict(config(w["config"]), scene_args=SMALL)
    got = control_lights.control(cfg, traffic, 2 ** 31 + 3, 2, "cpu")
    limits = load_json("limits", "manylights-path8")
    for reading in ("control", "altered", "march0"):
        assert any(v > limits[k] for k, v in got[reading].items()), reading
