"""The slice end to end: the port's Renderer against the JAX package's on
the in-code Cornell box at 32 x 32, 2 samples, 4 bounces, same seed (one
JAX compile, in a module fixture). test_torch_wavefront.py holds
trace_wavefront to the same criterion.

Criterion: image mean within 1e-3 relative, and >= 99% of pixels within
1e-3 absolute. Exact equality is not required: the two frameworks' CPU
transcendentals (sin, cos, sqrt-based warps, pow) differ by an ulp here
and there, and a last-bit difference can flip a Russian-roulette or
edge decision and send one path elsewhere."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu.render import renderer as jren
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.testing import cornell_scene, image_close
from torch_parity import BOUNCES, RES, cornell_scene_jax

SPP = 2


@pytest.fixture(scope="module")
def renders():
    jp = jren.Params(resolution=RES, samples=SPP, batch=SPP, bounces=BOUNCES,
                     sampler="path", seed=5)
    js = cornell_scene_jax()
    jr = jren.Renderer(js, jp)
    jst = jren.make_trace_state(js, jp)
    jr.trace_samples(jst)
    tp = tren.Params(resolution=RES, samples=SPP, batch=SPP, bounces=BOUNCES,
                     sampler="path", seed=5)
    ts = cornell_scene()
    tr = tren.Renderer(ts, tp)
    tst = tren.make_trace_state(ts, tp)
    tr.trace_samples(tst)
    return jr, jst, tr, tst


def test_renderer_matches_jax(renders):
    jr, jst, tr, tst = renders
    assert tst.samples == jst.samples == SPP
    img = tr.get_image(tst)
    assert img.shape == (RES, RES, 4)
    image_close(img, jr.get_image(jst))
    ja, ta = jr.get_aovs(jst), tr.get_aovs(tst)
    np.testing.assert_array_equal(ta["hits"], ja["hits"])
    for k in ("albedo", "normal"):
        np.testing.assert_allclose(ta[k], ja[k], atol=1e-5)


def test_renderer_rejects_unported_options():
    with pytest.raises(NotImplementedError):
        tren.Renderer(cornell_scene(), tren.Params(adaptive=True))
    r = tren.Renderer(cornell_scene(), tren.Params(resolution=8))
    ro = torch.zeros((4, 3))
    for opts in (r.options._replace(sort_rays=True),
                 r.options._replace(fixed_iterations=9)):
        with pytest.raises(NotImplementedError):
            tint.trace_wavefront(r.dscene, r.config, opts, ro, ro,
                                 torch.zeros(4, dtype=torch.int32))
