"""The port's CLI (julia_raytracer_tpu_torch/cli.py) end to end on the CPU,
on the Cornell box written by testing.write_yocto_scene, 32 x 32, 4
bounces: the parser against the JAX package's, the PNG against save_png
of the Renderer's image, checkpoint/resume byte for byte, the adaptive,
denoise, AOV, sky, environment and profiler flags, the refusal without a
card, and one run of the JAX package's CLI on the same scene.

Against the JAX CLI (2 samples, --checkpoint in both): the checkpoints'
keys, dtypes and shapes are equal, the images meet the slice criterion
(testing.image_close: means within 1e-3 relative, >= 99% of pixels
within 1e-3), and the port resumes the JAX checkpoint."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from julia_raytracer_tpu import cli as jax_cli
from julia_raytracer_tpu_torch import cli
from julia_raytracer_tpu_torch.render.renderer import (
    Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.testing import (
    cornell_scene, image_close, write_yocto_scene,
)
from julia_raytracer_tpu_torch.utils.imgio import save_png

SMALL = ["--resolution", "32", "--bounces", "4", "--sampler", "path"]


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """Written scenes get disk-cache keys: keep the cache in tmp_path."""
    monkeypatch.setenv("JRT_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_yocto_scene(cornell_scene(), tmp_path_factory.mktemp("cornell"))


def _run(scene_path, tmp_path, name, *extra, samples=4, batch=2):
    out = str(tmp_path / f"{name}.png")
    argv = (["--scene", scene_path, "--output", out, "--samples", str(samples),
             "--batch", str(batch), "--device", "cpu"] + SMALL + list(extra))
    assert cli.main(argv) == 0
    return out


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    got, want = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert len(want) == 25  # every flag of the JAX parser
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device"}
    assert got["device"][1] == "cuda"


def test_main_png_equals_renderer_image(scene_path, tmp_path, capsys):
    out = _run(scene_path, tmp_path, "cli")
    printed = capsys.readouterr().out
    assert "sample   4/  4" in printed and "saved image to" in printed
    params, _ = cli.parse_cli_args(["--scene", scene_path, "--samples", "4",
                                    "--batch", "2"] + SMALL)
    scene = cornell_scene()
    r = Renderer(scene, params, device="cpu")
    state = make_trace_state(scene, params, device="cpu")
    while state.samples < params.samples:
        r.trace_samples(state)
    save_png(str(tmp_path / "direct.png"), r.get_image(state))
    with open(out, "rb") as f, open(tmp_path / "direct.png", "rb") as g:
        assert f.read() == g.read()


def test_checkpoint_resume_byte_equal(scene_path, tmp_path):
    whole = _run(scene_path, tmp_path, "whole")
    ck = str(tmp_path / "ck.npz")
    _run(scene_path, tmp_path, "half", "--checkpoint", ck, samples=2)
    assert int(np.load(ck)["samples"]) == 2
    resumed = _run(scene_path, tmp_path, "resumed", "--resume", ck)
    with open(whole, "rb") as f, open(resumed, "rb") as g:
        assert f.read() == g.read()


def test_adaptive_denoise_aovs(scene_path, tmp_path):
    prefix = str(tmp_path / "aov")
    ck = str(tmp_path / "ada.npz")
    out = _run(scene_path, tmp_path, "ada", "--adaptive", "--adaptive-warmup",
               "2", "--denoise", "--aov-prefix", prefix, "--checkpoint", ck,
               samples=6)
    for path in (out, prefix + "_albedo.png", prefix + "_normal.png"):
        img = np.asarray(Image.open(path))
        assert img.shape == (32, 32, 4) and img[..., 3].min() == 255
    z = np.load(ck)
    assert int(z["counts"].sum()) == 6 * 32 * 32 and int(z["counts"].min()) >= 2
    assert np.isfinite(z["image"]).all()


@pytest.mark.parametrize("flag", ["--addsky", "--envname"])
def test_sky_and_environment_add_one_light(scene_path, tmp_path, monkeypatch,
                                           flag):
    built = []

    class Recording(Renderer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(cli, "Renderer", Recording)
    extra = [flag]
    if flag == "--envname":
        pano = str(tmp_path / "pano.png")
        save_png(pano, np.full((8, 16, 4), 0.8, np.float32), linear=False)
        extra.append(pano)
    _run(scene_path, tmp_path, "env", *extra, "--checkpoint",
         str(tmp_path / "env.npz"), samples=2)
    assert built[0].config.n_envs == 1
    hits = np.load(tmp_path / "env.npz")["hits"]
    assert hits.min() == 2  # every camera sample hits the box or the sky


def test_trace_profile_writes_trace(scene_path, tmp_path):
    prof = tmp_path / "prof"
    _run(scene_path, tmp_path, "prof", "--trace-profile", str(prof))
    assert os.path.getsize(prof / "trace.json") > 0
    with open(prof / "spans.json") as f:
        spans = json.load(f)
    paths = {r["path"] for r in spans["records"]}
    assert {"frame", "frame/chunk", "frame/chunk/wavefront/body"} <= paths
    lo, hi = spans["window_ns"]
    assert all(lo <= r["start_ns"] <= r["end_ns"] <= hi
               for r in spans["records"])
    # no device on the CPU: the frame is idle throughout, by span
    assert spans["idle_by_span_s"] and all(
        k in paths for k in spans["idle_by_span_s"])
    assert sum(spans["idle_by_span_s"].values()) == pytest.approx(
        spans["idle_s"]) == pytest.approx((hi - lo) / 1e9)
    assert spans["table"]["frame/chunk/wavefront/body"]["n"] > 0


def test_main_refuses_without_card(scene_path, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", scene_path, "--output", str(tmp_path / "x.png"),
                  "--samples", "1"] + SMALL)
    assert not (tmp_path / "x.png").exists()


def test_cli_matches_jax_cli(scene_path, tmp_path, monkeypatch):
    # keep the JAX CLI off its persistent compile cache and disk cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("JRT_CACHE_DIR", str(tmp_path / "jrt"))
    jck, tck = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    argv = ["--scene", scene_path, "--samples", "2", "--batch", "2"] + SMALL
    assert jax_cli.main(argv + ["--output", str(tmp_path / "jax.png"),
                                "--checkpoint", jck]) == 0
    assert cli.main(argv + ["--output", str(tmp_path / "port.png"),
                            "--checkpoint", tck, "--device", "cpu"]) == 0
    j, t = np.load(jck), np.load(tck)
    assert sorted(j.files) == sorted(t.files)
    for key in j.files:
        assert j[key].dtype == t[key].dtype and j[key].shape == t[key].shape, key
    image_close(t["image"], j["image"])
    np.testing.assert_array_equal(t["hits"], j["hits"])
    # the port resumes the JAX checkpoint, and continues as from its own
    resumed = _run(scene_path, tmp_path, "from_jax", "--resume", jck,
                   "--checkpoint", str(tmp_path / "from_jax.npz"))
    own = _run(scene_path, tmp_path, "own", "--resume", tck, "--checkpoint",
               str(tmp_path / "own.npz"))
    assert os.path.exists(resumed) and os.path.exists(own)
    a, b = np.load(tmp_path / "from_jax.npz"), np.load(tmp_path / "own.npz")
    assert int(a["samples"]) == 4
    image_close(a["image"], b["image"])
