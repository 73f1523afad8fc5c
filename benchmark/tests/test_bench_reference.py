"""The plain reference agrees with itself: across blocks of lanes, between
its two-level acceleration and testing every quad, and its train step
across blocks; and its float32 render agrees with the program's on the
CPU at a small size."""

import numpy as np
import pytest
import torch

from benchmark.modes import train
from benchmark.reference import tracer
from benchmark.scenes import cornell
from benchmark.tests import spheres


def test_render_same_across_blocks():
    desc = cornell.build()
    sc = tracer.Scene(desc, "cpu")
    pix = torch.tensor([0, 77, 500, 1023, 612])
    a, ha = tracer.render_pixels(sc, desc["camera"], pix, 6, 9, 32, 32, 8, 10.0)
    b, hb = tracer.render_pixels(sc, desc["camera"], pix, 6, 9, 32, 32, 8, 10.0,
                                 block=7)
    assert torch.equal(ha, hb)
    assert torch.allclose(a, b, rtol=0, atol=1e-12)


def test_accel_equals_every_quad(monkeypatch):
    desc = spheres.build(3, 32)
    sc = tracer.Scene(desc, "cpu")
    assert sc.n_quads > tracer.BRUTE
    g = torch.Generator().manual_seed(1)
    ro = torch.rand(300, 3, generator=g) * torch.tensor([1.8, 1.9, 1.8]) \
        - torch.tensor([0.9, 0.0, 0.9])
    rd = tracer.normalize(torch.randn(300, 3, generator=g))
    tmax = torch.full((300,), tracer.FMAX)
    got = sc.intersect(ro, rd, tmax, block=64)
    monkeypatch.setattr(tracer, "BRUTE", 10 ** 9)
    want = sc.intersect(ro, rd, tmax)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_train_same_across_blocks():
    desc = cornell.build()
    sc = tracer.Scene(desc, "cpu")
    c0, e0 = train.start_tables(desc, 4, 0.25)
    tgt = torch.as_tensor(train.target_image(4, 16, 16))
    runs = [tracer.train_steps(sc, desc["camera"], 16, 16, tgt,
                               torch.as_tensor(c0), torch.as_tensor(e0),
                               [4, 5], 0.05, 8, block=b) for b in (256, 37)]
    (la, ga, ta), (lb, gb, tb) = runs
    assert np.allclose(la, lb, rtol=1e-6)
    for x, y in zip([g for gs in ga for g in gs] + list(ta[-1]),
                    [g for gs in gb for g in gs] + list(tb[-1])):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["cornell", "spheres"])
def test_reference_agrees_with_program_on_cpu(name):
    from benchmark.modes import render
    from benchmark.modes.common import to_program_scene
    from julia_raytracer_tpu_torch.render.renderer import (
        Params, Renderer, make_trace_state,
    )

    desc = cornell.build() if name == "cornell" else spheres.build(3, 32)
    sd = to_program_scene(desc)
    p = Params(resolution=24, samples=4, batch=1, bounces=8, clamp=10.0,
               seed=2 ** 31 + 5)
    r = Renderer(sd, p, device="cpu")
    st = make_trace_state(sd, p, device="cpu")
    for _ in range(4):
        r.trace_samples(st)
    pix = np.arange(24 * 24)
    prog = {k: getattr(st, k)[:576].double().numpy()
            for k in ("image", "albedo", "normal")}
    prog["hits"] = st.hits[:576].long().numpy()
    mean, hits = render.reference(desc, {"bounces": 8, "clamp": 10.0}, pix, 4,
                                  2 ** 31 + 5, 24, 24, "cpu")
    got = render.compare(prog, mean, hits, 4)
    assert got["rgb_err"] < 1e-5 and got["aov_err"] < 1e-6
    assert got["hits_err"] == 0
