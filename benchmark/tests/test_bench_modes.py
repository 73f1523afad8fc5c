"""The render and train modes end to end on the CPU at a tiny size
(run.main's test-only entry), the command line's refusal without a card,
and the output check failing on a broken timed path."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"render": {"resolution": 16, "check_pixels": 64},
        "train": {"resolution": 16}}
CELLS = {"cornell-path8": "render", "cornell-train": "train"}


def result(capsys, cell, trace=0, seed=2 ** 31 + 11):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
                   "--trace", str(trace)], device="cpu",
                  traffic_overrides=TINY[CELLS[cell]])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["cornell-path8", "cornell-train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_mode_end_to_end(capsys, cell, trace):
    out = result(capsys, cell, trace)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        # no device metric from a CPU run: host clock and counters only
        from benchmark.tests.test_bench_files import bench

        src = {m["name"]: m["source"] for m in bench()["per_layer"]}
        assert "scene_build_s" in out["metrics"]
        assert all(src[k] != "device_trace" for k in out["metrics"])
    else:
        want = ({"frame_ms_p90", "setup_s"}
                if CELLS[cell] == "render" else {"train_step_ms", "setup_s"})
        assert set(out["metrics"]) == want


def test_command_line_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell-path8", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _half_sample(orig):
    def patched(self, state, chunk, pixel0, sample):
        return orig(self, state, chunk // 2, pixel0, sample)
    return patched


def _scaled(orig):
    def patched(*a, **k):
        out = orig(*a, **k)
        return (out[0] * 1.02,) + tuple(out[1:])
    return patched


def test_render_faults_fail_the_check(capsys, monkeypatch):
    from julia_raytracer_tpu_torch.render import renderer

    faults = {
        "unchanged": ("Renderer.trace_samples", lambda self, state: state),
        "half": ("Renderer._sample", _half_sample(renderer.Renderer._sample)),
        "altered": ("trace_wavefront", _scaled(renderer.trace_wavefront)),
    }
    for name, (attr, fn) in faults.items():
        with monkeypatch.context() as m:
            owner, _, leaf = attr.rpartition(".")
            m.setattr(getattr(renderer, owner) if owner else renderer, leaf, fn)
            out = result(capsys, "cornell-path8")
        assert out["correct"] is False, name


def test_train_faults_fail_the_check(capsys, monkeypatch):
    from julia_raytracer_tpu_torch.parallel import mesh

    orig = mesh.shard_train_step

    def broken(kind):
        def make(*a, **k):
            step = orig(*a, **k)

            def patched(color, emission, pixel_ids, target, n, seed=0):
                if kind == "half":
                    h = pixel_ids.shape[0] // 2
                    return step(color, emission, pixel_ids[:h], target[:h], n,
                                seed)
                loss, c, e = step(color, emission, pixel_ids, target, n, seed)
                if kind == "unchanged":
                    return loss, color, emission
                return loss * 1.01, c, e
            return patched
        return make

    for kind in ("unchanged", "half", "altered"):
        with monkeypatch.context() as m:
            m.setattr(mesh, "shard_train_step", broken(kind))
            out = result(capsys, "cornell-train")
        assert out["correct"] is False, kind


@pytest.mark.parametrize("parted", [1, 2])
def test_train_judge_sets_aside_one_parted_step(parted):
    """One step whose loss and gradient read apart (a lane that rounding
    sent across an edge) is set aside by the median; two are not."""
    import numpy as np

    from benchmark.modes import train

    lr, grad = 0.5, [np.full((4, 3), 0.1), np.full((4, 3), 0.2)]
    tables, losses = [(np.ones((4, 3)), np.ones((4, 3)))], []
    for j in range(3):
        scale = 1.5 if j < parted else 1.0
        tables.append(tuple(t - lr * scale * g
                            for t, g in zip(tables[-1], grad)))
        losses.append(2.0 * scale)
    got = train.judge(losses, tables, [2.0] * 3, [grad] * 3, lr)
    want = 0.0 if parted == 1 else 0.5
    assert got["loss_gap"] == pytest.approx(want)
    assert got["grad_gap"] == pytest.approx(want)
