"""Veach's MIS scene (benchmark/scenes/veach_mis.py), its lights' quads
past the exact light pdf's EXACT_ELEMS, on the CPU:

  - the scene routes to the worklist with no sort and an 8-step march;
  - Renderer.trace_samples on the scene at 16 steps a sphere (7,680
    emissive quads, still past EXACT_ELEMS, so the pdf marches), 24 x 24,
    2 frames, 8 bounces, matches the benchmark's plain reference with the
    blocked light pdf (benchmark/reference/lights.py, each light's quads
    in the program's order) under the manylights-path8 cell's limits;
  - the blocked pdf equals tracer.Scene.light_pdf's loop on a scene small
    enough for the loop;
  - the `light_march` span's fields: `steps` the budget a call,
    `marching` at most `lanes` x `steps`, `truncated` at most `lanes`,
    and with no extra step no marching lane and every first hit
    truncated; the `worklist` span filed once a call;
  - neither span moves trace_wavefront.host_syncs;
  - a scene at or under EXACT_ELEMS opens no `light_march` span."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.modes import render, render_lights
from benchmark.modes.common import to_program_scene
from benchmark.reference import lights as ref_lights
from benchmark.reference import tracer
from benchmark.scenes import veach_mis
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import lights as tlights
from julia_raytracer_tpu_torch.render.renderer import (
    Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAFFIC = {"resolution": 24, "batch": 1, "bounces": 8, "sampler": "path",
           "clamp": 10.0}
SEED = 2 ** 31 + 29
FRAMES = 2


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def _renderer(steps: int, **params):
    desc = veach_mis.build(sphere_steps=steps)
    scene = to_program_scene(desc)
    p = render_lights.params(TRAFFIC, SEED, **params)
    r = Renderer(scene, p, device="cpu")
    return desc, r, make_trace_state(scene, p, device="cpu")


def _frames(r, state, n=FRAMES) -> list[dict]:
    """n frames; their span tables."""
    for _ in range(n):
        r.trace_samples(state)
    return [u["table"] for u in timing.units()][-n:]


def _rows(tables, name):
    return [row for t in tables for path, row in t.items()
            if path.endswith("/" + name)]


@pytest.fixture(scope="module")
def small():
    """The scene at 16 steps a sphere, FRAMES frames traced: (description,
    renderer, state, the frames' span tables)."""
    timing.reset()
    desc, r, state = _renderer(16)
    return desc, r, state, _frames(r, state)


def test_full_scene_routes_to_the_march():
    """The cell's scene: 30,720 emissive quads, the worklist, no sort,
    8 extra steps (render_lights.check_route passes)."""
    _, r, _ = _renderer(32)
    assert r.config.light_counts.total_inst_elems == 30720
    assert r.config.light_counts.n_instance == 5
    assert isinstance(r.intersect.tables, wl.WorklistTables)
    assert r.options.sort_rays is False
    assert r.options.light_pdf_extra_steps == render_lights.MARCH_STEPS == 8
    render_lights.check_route(r)


def test_program_matches_the_reference_under_the_cell_limits(small):
    desc, r, state, _ = small
    assert r.config.light_counts.total_inst_elems == 7680 > tlights.EXACT_ELEMS
    assert state.samples == FRAMES
    w = state.width
    pixels = render.check_pixels(SEED, w * w, 2048)
    prog = render_lights.program_pixels(state, pixels)
    ref = render_lights.reference(desc, dict(TRAFFIC), pixels, FRAMES, SEED,
                                  w, w, "cpu", render_lights.light_order(r))
    got = render.compare(prog, *ref, FRAMES)
    with open(os.path.join(ROOT, "benchmark", "limits",
                           "manylights-path8.json")) as f:
        limits = json.load(f)
    assert prog["image"][:, :3].sum() > 0
    for name, value in got.items():
        assert value <= limits[name], (name, value)


def test_blocked_pdf_equals_the_loop():
    """4 steps a sphere (480 emissive quads): rays from the plates and the
    floor at the lights, and a fifth anywhere."""
    desc = veach_mis.build(sphere_steps=4)
    loop, blocked = tracer.Scene(desc, "cpu"), ref_lights.Scene(desc, "cpu")
    g = torch.Generator().manual_seed(5)
    n = 1500
    pos = (torch.rand(n, 3, generator=g) * torch.tensor([8.0, 3.0, 6.0])
           - torch.tensor([4.0, 3.9, -0.5]))
    centre = torch.tensor([c for c, _, _ in veach_mis.lights()])
    d = centre[torch.randint(0, 5, (n,), generator=g)] - pos
    d = d + 0.3 * torch.randn(n, 3, generator=g)
    d[::5] = torch.randn(len(d[::5]), 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    want, got = loop.light_pdf(pos, d), blocked.light_pdf(pos, d)
    assert (want > 0).sum() > n // 4
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


def test_light_march_span_fields(small):
    _, r, _, tables = small
    rows = _rows(tables, "light_march")
    assert rows
    budget = r.options.light_pdf_extra_steps
    for row in rows:
        assert row["steps"] == budget * row["n"]
        assert 0 < row["marching"] <= row["lanes"] * budget
        assert 0 <= row["truncated"] <= row["lanes"]
        assert 0 < row["emitter_hits"] <= row["marching"]
        assert row["device_ns"] > 0


def test_march_without_extra_steps():
    """Budget 0: no lane marches a step, and every lane whose first hit
    hit is truncated."""
    _, r, state = _renderer(16, light_pdf_extra_steps=0)
    n = 256
    g = torch.Generator().manual_seed(2)
    pos = torch.rand(n, 3, generator=g) * 2.0 - torch.tensor([1.0, 3.0, -1.0])
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    d[:, 1] = d[:, 1].abs()  # up, toward the light row
    f = r.intersect.primary
    first = f(pos, d, torch.full((n,), 1e-4), torch.full((n,), 3.4e38))
    with timing.span("frame"):
        tlights.sample_lights_pdf(r.dscene, r.dscene.lights,
                                  r.config.light_counts, pos, d,
                                  intersect_fn=f, first_hit=first,
                                  extra_steps=0)
    (row,) = _rows([timing.units()[-1]["table"]], "light_march")
    assert (row["lanes"], row["steps"], row["marching"]) == (n, 0, 0)
    assert row["truncated"] == int(first.hit.sum()) > 0
    assert row["emitter_hits"] == 0


def test_worklist_span_filed_once_a_call(small):
    _, r, _, tables = small
    rows = _rows(tables, "worklist")
    assert rows and all(row["device_ns"] > 0 for row in rows)
    # every call of the worklist: camera rays, bounce rays, march steps
    calls = sum(row["n"] for row in rows)
    bodies = sum(row["n"] for row in _rows(tables, "body"))
    chunks = sum(row["n"] for row in _rows(tables, "chunk"))
    assert calls == chunks + bodies * (1 + r.options.light_pdf_extra_steps)
    # nested where the trace calls it
    assert {p.rsplit("/", 2)[-2] for t in tables for p in t
            if p.endswith("/worklist")} == {"primary_hit", "intersect",
                                            "light_march"}


class _NoSpan:
    """A device_span that is not there."""

    def __init__(self, name, device, **counts):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


def test_spans_add_no_host_sync(monkeypatch):
    """The host syncs of the same frame with the two spans and with them
    gone are the same: the loop tests alone."""
    desc, r, _ = _renderer(16)
    p = r.params

    def syncs():
        state = make_trace_state(to_program_scene(desc), p, device="cpu")
        before = tint.trace_wavefront.host_syncs
        table = _frames(r, state, 1)[0]
        return tint.trace_wavefront.host_syncs - before, table

    with_spans, table = syncs()
    assert _rows([table], "light_march") and _rows([table], "worklist")
    loop_tests = sum(row["n"] for row in _rows([table], "loop_test"))
    monkeypatch.setattr(timing, "device_span", _NoSpan)
    without, table = syncs()
    assert not _rows([table], "light_march")
    assert not _rows([table], "worklist")
    assert with_spans == without == loop_tests


def test_exact_scene_opens_no_march_span():
    """4 steps a sphere: 480 emissive quads, the exact sweep; the worklist
    still runs (486 quads), the march does not."""
    _, r, state = _renderer(4)
    assert r.config.light_counts.total_inst_elems <= tlights.EXACT_ELEMS
    tables = _frames(r, state, 1)
    assert _rows(tables, "worklist")
    assert not _rows(tables, "light_march")
    assert not np.isnan(state.image.numpy()).any()
