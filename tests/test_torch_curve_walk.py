"""The culled curve walk (ops/curve_intersect.py) on the CPU, and the SPD
tree that its benchmark cell renders (benchmark/scenes/spd_tree.py):

  - curve_walk_plain, after the work items' cull, merged by merge_curves,
    gives the plain sweep's hits bit for bit on seeded random lines and
    points, with equal-t ties (duplicated elements), elements behind
    tmin, a quad hit closer than every element, zero-radius ends and rays
    parallel to a segment (det == 0); and the whole route forced onto the
    CPU gives the sweep route's hits;
  - the element boxes hold every element's hits;
  - the generator's counts follow the SPD's law, 2^(SF + 1) - 1 cones and
    as many spheres, at size factors 2-5 and 4,095 / 4,095 / 1 at the
    default;
  - a small tree (size factor 3) rendered by Renderer.trace_samples on the
    CPU, through the sweep and through the forced walk, matches the
    benchmark's plain reference (benchmark/reference/curves.py) under the
    tree-path8 cell's limits, with the render mode's own comparison."""

import numpy as np
import pytest
import torch

from julia_raytracer_tpu_torch.ops import curve_intersect as cw
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops.geometry import intersect_line, intersect_point
from julia_raytracer_tpu_torch.ops.traversal import Hit, intersect_bruteforce
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render.renderer import (
    Params, Renderer, make_trace_state,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.scene.types import (
    InstanceData, MaterialData, SceneData, ShapeData,
)
from julia_raytracer_tpu_torch.testing import cornell_scene

F32_MAX = 3.4028234663852886e38


def _curve_scene(seed: int) -> SceneData:
    """A wall quad at z = -1 and, in [-1, 1]^3, 300 random lines (40 of
    them axis-aligned along x, 20 exact duplicates, 30 with a zero-radius
    end) and 200 random points (20 duplicates, 20 of radius 0)."""
    g = np.random.default_rng(seed)
    p1 = g.uniform(-1, 1, (300, 3))
    p2 = p1 + g.normal(0, 0.3, (300, 3))
    p2[:40] = p1[:40] + [[0.4, 0.0, 0.0]]  # along x
    p1[280:], p2[280:] = p1[100:120], p2[100:120]  # duplicates, later
    r = g.uniform(0.005, 0.05, (300, 2))
    r[280:] = r[100:120]
    r[40:70, 1] = 0.0  # cone tips
    pts = g.uniform(-1, 1, (200, 3))
    pr = g.uniform(0.01, 0.06, 200)
    pts[180:], pr[180:] = pts[50:70], pr[50:70]
    pr[100:120] = 0.0
    lines = ShapeData(
        lines=np.arange(600, dtype=np.int32).reshape(300, 2),
        positions=np.stack([p1, p2], 1).reshape(-1, 3).astype(np.float32),
        radius=r.reshape(-1).astype(np.float32))
    points = ShapeData(points=np.arange(200, dtype=np.int32),
                       positions=pts.astype(np.float32),
                       radius=pr.astype(np.float32))
    wall = ShapeData(quads=np.arange(4, dtype=np.int32).reshape(1, 4),
                     positions=np.float32([[-3, -3, -1], [3, -3, -1],
                                           [3, 3, -1], [-3, 3, -1]]))
    scene = cornell_scene()
    scene.shapes, scene.instances = [lines, points, wall], [
        InstanceData(shape=k, material=0) for k in range(3)]
    scene.materials = [MaterialData(color=np.float32([0.5, 0.5, 0.5]))]
    return scene


def _rays(seed: int, n: int = 3000):
    """Rays through the cloud from outside it and from inside it (some
    elements behind tmin), 300 along +-x (parallel to the x segments, 100
    of them from those segments' own origins), 200 down at the wall (the
    quad's hit nearer than every element on the lanes the wall is hit
    first from below the cloud)."""
    g = np.random.default_rng(seed + 1)
    ro = g.uniform(-1.5, 1.5, (n, 3))
    ro[: n // 2] *= 2.0
    rd = g.uniform(-1, 1, (n, 3)) - 0.3 * ro
    rd[:300] = [[1.0, 0.0, 0.0]]
    rd[150:300] *= -1.0
    rd[300:500] = [[0.0, 0.0, -1.0]]
    ro[300:500, 2] = -0.9  # under the cloud: the wall comes first
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4)
    tmin[500:800] = 0.5  # a part of each cloud behind tmin
    return (torch.tensor(ro, dtype=torch.float32),
            torch.tensor(rd, dtype=torch.float32),
            torch.tensor(tmin, dtype=torch.float32),
            torch.full((n,), F32_MAX))


@pytest.fixture(scope="module", params=[0, 1])
def built(request):
    scene = _curve_scene(request.param)
    dscene, config = build_device_scene(scene, device="cpu")
    # 100 of the x rays start on the x segments' first ends
    ro, rd, tmin, tmax = _rays(request.param)
    ro[:40] = dscene.line_verts[:40, 0]
    ro[150:190] = dscene.line_verts[:40, 1]
    return dscene, config, (ro, rd, tmin, tmax)


def _quad_hit(dscene, rays):
    h = intersect_bruteforce(dscene.prim_verts, *rays)
    return h._replace(t=torch.where(h.hit, h.t, rays[3]))


def test_walk_equals_sweep(built):
    dscene, config, rays = built
    tables = cw.upload(dscene.line_verts, dscene.line_radius,
                       dscene.point_pos, dscene.point_radius, "cpu")
    best = _quad_hit(dscene, rays)
    got = tint.merge_curves(dscene, config, best, *rays, tables)
    want = tint.merge_curves(dscene, config, best, *rays)
    for f, a, b in zip(Hit._fields, got, want, strict=True):
        assert torch.equal(a, b), f
    q = dscene.prim_verts.shape[0]
    lines = (want.prim >= q) & (want.prim < q + config.n_lines)
    assert lines.sum() > 100 and (want.prim >= q + config.n_lines).sum() > 50
    assert (want.hit & (want.prim < q)).sum() > 50  # the wall
    # the duplicates never win over their first copies
    assert not ((want.prim >= q + 280) & (want.prim < q + 300)).any()
    assert not (want.prim >= q + config.n_lines + 180).any()


def test_walk_counts_and_ties(built):
    """The walk's own outputs: lower indices win equal t among lines and
    among points; it tests fewer pairs than every ray against every
    element, and more than none."""
    dscene, config, rays = built
    tables = cw.upload(dscene.line_verts, dscene.line_radius,
                       dscene.point_pos, dscene.point_radius, "cpu")
    bt = _quad_hit(dscene, rays).t
    lists = ii.precull(rays[0], rays[1], rays[2], bt, tables.clusters)
    best, tested = cw.curve_walk_plain(tables, rays[0], rays[1], rays[2], bt,
                                       *lists)
    n, e = rays[0].shape[0], tables.elems.shape[0]
    assert 0 < int(tested) < n * e
    assert best.line.max() < 280 and best.point.max() < 180
    none = best.line < 0
    assert (best.line_t[none] == F32_MAX).all()
    assert (best.line_t[~none] < bt[~none]).all()


def test_boxes_hold_every_hit(built):
    """Each element's hit point (the closest approach on the ray) lies in
    its box, for every (ray, element) pair the element tests report."""
    dscene, _, (ro, rd, tmin, tmax) = built
    boxes = cw.element_boxes(dscene.line_verts, dscene.line_radius,
                             dscene.point_pos, dscene.point_radius)
    lv, lr = dscene.line_verts, dscene.line_radius
    h, _, _, t = intersect_line(ro[:, None], rd[:, None], tmin[:, None],
                                tmax[:, None], lv[None, :, 0], lv[None, :, 1],
                                lr[None, :, 0], lr[None, :, 1])
    hp, tp = intersect_point(ro[:, None], rd[:, None], tmin[:, None],
                             tmax[:, None], dscene.point_pos[None],
                             dscene.point_radius[None])
    hit = torch.cat([h, hp], 1)
    at = ro[:, None] + rd[:, None] * torch.cat([t, tp], 1)[..., None]
    inside = ((at >= boxes[None, :, :3]) & (at <= boxes[None, :, 3:])).all(-1)
    assert hit.sum() > 100 and inside[hit].all()


def test_forced_route_equals_sweep_route(built, monkeypatch):
    dscene, config, rays = built
    sweep = tint.build_intersector(dscene, config)
    monkeypatch.setattr(tint, "CURVE_WALK_DEVICES", ("cpu",))
    walk = tint.build_intersector(dscene, config)
    assert sweep.curves is None and isinstance(walk.curves, cw.CurveTables)
    assert walk.graph_safe == sweep.graph_safe
    for a, b in zip(walk(*rays), sweep(*rays), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size_factor", [2, 3, 4, 5])
def test_tree_counts_follow_the_spd_law(size_factor):
    from benchmark.scenes import spd_tree

    desc = spd_tree.build(size_factor)
    n = 2 ** (size_factor + 1) - 1
    assert spd_tree.counts(size_factor) == n
    assert len(desc["shapes"][0]["lines"]) == n
    assert len(desc["shapes"][1]["points"]) == n


def test_tree_default_size():
    from benchmark.modes.common import build_scene, load_json
    from benchmark.scenes import spd_tree

    cfg = load_json("configs", "spd_tree")
    desc = build_scene(cfg)
    lines, points, ground = desc["shapes"][:3]
    assert (len(lines["lines"]), len(points["points"]),
            len(ground["quads"])) == (4095, 4095, 1)
    assert (cfg["cones"], cfg["spheres"], cfg["squares"]) == (4095, 4095, 1)
    b, e, rb, re = spd_tree.branches()
    # each child starts at its parent's end, with its parent's end radius
    np.testing.assert_allclose(b[1], e[0])
    np.testing.assert_allclose(rb[1], re[0])
    assert np.asarray(points["radius"]).min() > 0


@pytest.mark.parametrize("walk", [False, True])
def test_small_tree_matches_reference(walk, monkeypatch):
    """Size factor 3 (15 lines, 15 points), 24 x 24, 3 frames, traced by
    the program on the CPU (the sweep, or the walk forced onto the CPU)
    and by the plain reference, compared by the render mode's numbers
    under tree-path8's limits."""
    from benchmark.modes import render_curves
    from benchmark.modes.common import load_json
    from benchmark.modes.render import check_pixels, compare
    from benchmark.scenes import spd_tree

    if walk:
        monkeypatch.setattr(tint, "CURVE_WALK_DEVICES", ("cpu",))
    desc = spd_tree.build(3)
    scene = render_curves.to_program_scene(desc)
    res, frames, seed = 24, 3, 2 ** 31 + 5
    p = Params(resolution=res, samples=1 << 20, batch=1, bounces=8,
               clamp=10.0, seed=seed)
    r = Renderer(scene, p, device="cpu")
    assert (r.intersect.curves is not None) == walk
    st = make_trace_state(scene, p, device="cpu")
    for _ in range(frames):
        r.trace_samples(st)
    pixels = check_pixels(seed, res * res, 256)
    prog = {k: getattr(st, k)[pixels].double().numpy()
            for k in ("image", "albedo", "normal")}
    prog["hits"] = st.hits[pixels].long().numpy()
    traffic = load_json("workloads", "path8-curves")
    ref_mean, ref_hits = render_curves.reference(desc, traffic, pixels,
                                                 frames, seed, res, res, "cpu")
    limits = load_json("limits", "tree-path8")
    got = compare(prog, ref_mean, ref_hits, frames)
    assert prog["hits"].sum() > 0 and ref_hits.sum() > 0
    for name, value in got.items():
        assert value <= limits[name], (name, value)
