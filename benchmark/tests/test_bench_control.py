"""The output check's control, at a size a test run holds: the plain
reference in bfloat16 put in the program's place fails the cell's
limits, for a render cell and for a train cell."""

import pytest

from benchmark import control
from benchmark.modes.common import load_json
from benchmark.tests.test_bench_files import bench, config


def test_render_control_fails():
    w = {w["name"]: w for w in bench()["workloads"]}["cornell-path8"]
    traffic = dict(load_json("workloads", w["traffic"]), resolution=24,
                   check_pixels=96)
    got = control.render_control(config(w["config"]), traffic, 2 ** 31 + 3,
                                 4, "cpu")
    limits = load_json("limits", "cornell-path8")
    assert any(v > limits[k] for k, v in got["control"].items())


def test_train_control_and_faults_fail():
    w = {w["name"]: w for w in bench()["workloads"]}["cornell-train"]
    traffic = dict(load_json("workloads", w["traffic"]), resolution=16)
    got = control.train_control(config(w["config"]), traffic, 2 ** 31 + 3,
                                "cpu")
    limits = load_json("limits", "cornell-train")
    for reading in ("control", "half", "altered", "unchanged"):
        assert any(v > limits[k] for k, v in got[reading].items()), reading
