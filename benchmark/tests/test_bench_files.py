"""The benchmark's files: every configuration, traffic mix, limit file and
metric reader that BENCHMARK.json names exists and loads, the scene
copies have their quad counts, and the file keeps the contract's shape."""

import importlib
import json
import os
import re

import pytest

from benchmark.modes.common import build_scene, load_json

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name):
    c = {c["name"]: c for c in bench()["configs"]}[name]
    with open(os.path.join(ROOT, c["file"])) as f:
        return json.load(f)


def n_quads(desc):
    return sum(len(desc["shapes"][i["shape"]]["quads"]) for i in desc["instances"])


@pytest.mark.parametrize("name,quads", [("cornellbox", 18)])
def test_scene_copies_quad_counts(name, quads):
    desc = build_scene(config(name))
    assert n_quads(desc) == quads == config(name)["quads"]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_names_existing_files(cell):
    b = bench()
    w = {w["name"]: w for w in b["workloads"]}[cell]
    cfg = config(w["config"])
    assert importlib.import_module("benchmark.scenes." + cfg["scene"])
    traffic = load_json("workloads", w["traffic"])
    assert importlib.import_module("benchmark.modes." + traffic["mode"])
    limits = load_json("limits", cell)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = [m for m in b["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layer = [m for m in b["per_layer"]
             if "workloads" not in m or cell in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in [x["name"] for x in e2e]


def test_metric_readers_load():
    from benchmark.run import load_reader

    for m in bench()["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 10 <= b["run_seconds"] <= 51
    names = ([c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                              "device_trace")
    for m in b["per_layer"]:
        assert m["better"] in ("lower", "higher") and "bound" not in m
    for c in b["configs"]:
        assert c["reduced"] == config(c["name"])["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
