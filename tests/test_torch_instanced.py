"""The port's instanced-scene path against the JAX package's on the CPU:
the non-expanded flatten, the instanced host tables, the hybrid's soup,
the routing rules (and the counts of testing.py's two instanced scenes),
the work-item intersector's plain version and the reference loop, and
the hybrid intersector. The renders are in test_torch_instanced_render.py.

The scene is tests/test_instanced.py's (two random triangle soups, five
rotated and scaled instances), built from the same numpy seed for both
packages (torch_parity.instanced_test_scene). Tolerances: index arrays
equal, float tables within rtol 2e-6 (the JAX package may build them with
its C++ helper, the port in numpy: the same math, rounded apart);
intersectors: hit masks equal, >= 99.9% of prim and instance ids equal, t
within rtol 1e-4 (the TPU kernel's order of operations differs); against
the flattened brute force, the _check_vs_flat contract of
tests/test_instanced.py (testing.check_vs_flat: t rtol 2e-4, normals
|dot| > 0.999)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.pallas_cluster import make_cluster_intersect_instanced
from julia_raytracer_tpu.render import integrator as jint
from julia_raytracer_tpu.render import scene_device as jsd
from julia_raytracer_tpu.scene import flatten as jflat
from julia_raytracer_tpu.scene import instanced as jinst
from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops.diff_hit import instanced_diff
from julia_raytracer_tpu_torch.ops.traversal import intersect_bruteforce
from julia_raytracer_tpu_torch.render import integrator as tint
from julia_raytracer_tpu_torch.render import scene_device as tsd
from julia_raytracer_tpu_torch.scene import flatten as tflat
from julia_raytracer_tpu_torch.scene import instanced as tinst
from julia_raytracer_tpu_torch.scene.types import (
    CameraData, InstanceData, MaterialData, SceneData, ShapeData,
)
from julia_raytracer_tpu_torch.testing import (
    HYBRID_COUNTS, INSTANCED_COUNTS, check_vs_flat, hybrid_scene,
    instanced_scene,
)
from torch_parity import (
    frame, icosphere_like, instanced_test_rays, instanced_test_scene,
    to_jax_scene,
)

def _both(rays):
    return ([jnp.asarray(x) for x in rays], [torch.from_numpy(x) for x in rays])


def _port_flat_ref(scene, rays):
    d, _ = tsd.build_device_scene(scene, instancing=False, device="cpu")
    return intersect_bruteforce(d.prim_verts, *rays,
                                prim_instance=d.prim_instance)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_vs_jax(want, got):
    """Hit masks equal, >= 99.9% of prim and instance ids equal, t within
    rtol 1e-4 where both hit."""
    h1, h2 = _np(want.hit), _np(got.hit)
    np.testing.assert_array_equal(h1, h2)
    m = h1
    assert m.any()
    assert (_np(want.prim)[m] == _np(got.prim)[m]).mean() >= 0.999
    assert (_np(want.instance)[m] == _np(got.instance)[m]).mean() >= 0.999
    np.testing.assert_allclose(_np(got.t)[m], _np(want.t)[m], rtol=1e-4)


@pytest.fixture(scope="module")
def builds():
    """(port scene, JAX scene, port build, JAX build) of the plain
    instanced scene (no hybrid)."""
    s = instanced_test_scene()
    sj = to_jax_scene(s)
    return (s, sj, tsd.build_device_scene_instanced(s, device="cpu"),
            jsd.build_device_scene_instanced(sj))


def test_flatten_not_expanded_matches_jax():
    s = instanced_test_scene(emissive=True)
    got = tflat.flatten_scene(s, expand_prims=False).geometry
    want = jflat.flatten_scene(to_jax_scene(s), expand_prims=False).geometry
    for f in ("prim_verts", "prim_vidx", "prim_instance", "prim_element",
              "prim_flags", "inst_frame", "inst_material", "inst_shape",
              "shape_vert_offset", "shape_prim_offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert tflat.flatten_scene(s).geometry.shape_prim_offset is None


def _tables_close(got, want):
    for f in ("sup", "n_prims"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("wi_sup", "wi_inst", "shape_sup_offset"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("tab", "bbox", "wi_bbox", "inst_rows"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=2e-6, atol=1e-6, err_msg=f)


def test_instanced_host_tables_match_jax():
    s = instanced_test_scene(emissive=True)
    sj = to_jax_scene(s)
    ft = tflat.flatten_scene(s, expand_prims=False)
    fj = jflat.flatten_scene(sj, expand_prims=False)
    mask = np.array([True, False, True, True, False])
    for m in (None, mask):
        got, gev = tinst.build_instanced_tables(s, ft, instance_mask=m)
        want, wev = jinst.build_instanced_tables(sj, fj, instance_mask=m)
        _tables_close(got, want)
        for f in ("prim_vidx", "prim_flags"):
            np.testing.assert_array_equal(gev[f], wev[f], f)
        np.testing.assert_allclose(gev["prim_verts"], wev["prim_verts"],
                                   rtol=2e-6)
    for got, want in zip(tinst.expand_emissive_world_prims(s, ft),
                         jinst.expand_emissive_world_prims(sj, fj)):
        assert len(got) == 25
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("budget", [60, 1_000_000])
def test_hybrid_soup_matches_jax(budget):
    s = instanced_test_scene()
    ft = tflat.flatten_scene(s, expand_prims=False)
    fj = jflat.flatten_scene(to_jax_scene(s), expand_prims=False)
    mask = tinst.select_flatten_shapes(ft, budget)
    np.testing.assert_array_equal(mask, jinst.select_flatten_shapes(fj, budget))
    got = tinst.build_world_flat(ft, mask)
    want = jinst.build_world_flat(fj, mask)
    np.testing.assert_array_equal(got[1], want[1])  # instances
    np.testing.assert_array_equal(got[2], want[2])  # remap
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=1e-6)
    assert len(got[0]) == (50 if budget == 60 else 170)


def test_routing_matches_jax():
    """_should_instance and the automatic hybrid budget (the JAX test
    test_hybrid_budget_full_flatten_auto, with the budget as an argument
    in place of JRT_HYBRID_BUDGET)."""
    rng = np.random.default_rng(3)
    shape = icosphere_like(rng, 8, 0.3)
    mats = [MaterialData(color=np.array([0.7, 0.7, 0.7], np.float32))]
    instances = [
        InstanceData(frame=frame((i * 7) % 360, [i % 40, i // 40, 0]),
                     shape=0, material=0)
        for i in range(1100)  # >= HYBRID_MIN_INSTANCES
    ]
    many = SceneData(cameras=[CameraData()], shapes=[shape], materials=mats,
                     instances=instances)
    _, cfg = tsd.build_device_scene_instanced(many, device="cpu")
    assert len(cfg.inst_tables.wi_sup) == 0, "full expansion fits: no items"
    _, cfg_j = jsd.build_device_scene_instanced(to_jax_scene(many))
    assert len(cfg_j.inst_tables.wi_sup) == 0
    assert len(cfg.hyb_world_verts) == len(cfg_j.hyb_world_verts) == 8800
    # a budget below one shape's world footprint flattens nothing
    _, cfg2 = tsd.build_device_scene_instanced(many, hybrid_budget=2000,
                                               device="cpu")
    assert len(cfg2.inst_tables.wi_sup) > 0 and cfg2.hyb_world_verts is None
    # the 4M / 4x rule: this scene flattens to 8,800 quads, not instanced
    for scene in (many, instanced_test_scene()):
        assert tsd._should_instance(scene) == jsd._should_instance(
            to_jax_scene(scene))
    # shape 0 at 1.4M triangles: 3 instances flatten to 4.2M (>= 4M) but
    # only 3x the shapes' 1.4M prims; 5 instances make it >= 4x
    big = instanced_test_scene()
    big.shapes[0] = ShapeData(triangles=np.zeros((1_400_000, 3), np.int32),
                              positions=np.zeros((1, 3), np.float32))
    assert not tsd._should_instance(big)
    assert not jsd._should_instance(to_jax_scene(big))
    for k in (2, 3):
        big.instances[k] = dataclasses.replace(big.instances[k], shape=0)
    assert tsd._should_instance(big) and jsd._should_instance(to_jax_scene(big))
    flat = tflat.flatten_scene(instanced_test_scene(), expand_prims=False)
    assert tsd.auto_hybrid_budget(flat) == 0  # 5 instances < 1,024


def test_instanced_plain_matches_jax_kernel(builds):
    """The port's work-item intersector (its plain version on the CPU)
    against the JAX kernel in interpret mode with K = 8 (several rounds)."""
    _, _, (_, cfg), (_, cfg_j) = builds
    jr, tr = _both(instanced_test_rays())
    want = make_cluster_intersect_instanced(cfg_j.inst_tables, interpret=True,
                                            k_items=8)(*jr)
    got = ii.make_instanced_intersect(cfg.inst_tables, "cpu",
                                     instanced_diff)(*tr)
    _check_vs_jax(want, got)


def test_instanced_ref_matches_jax_ref(builds):
    _, _, (d, cfg), (dj, cfg_j) = builds
    jr, tr = _both(instanced_test_rays())
    want = jint.make_intersect_instanced_ref(dj, cfg_j)(*jr)
    got = tint.make_intersect_instanced_ref(d, cfg)(*tr)
    _check_vs_jax(want, got)
    np.testing.assert_array_equal(_np(got.prim), _np(want.prim))


@pytest.mark.parametrize("which", ["plain", "reference"])
def test_instanced_intersectors_match_flat(builds, which):
    s, _, (d, cfg), _ = builds
    _, tr = _both(instanced_test_rays())
    if which == "plain":
        intersect = tint.build_intersector(d, cfg)
        assert isinstance(intersect.tables, ii.InstancedDeviceTables)
    else:
        intersect = tint.make_intersect(d, cfg)
    got = intersect(*tr)
    check_vs_flat(_port_flat_ref(s, tr), got)
    # prim ids land on real (not padding) shape-space prims
    hp = _np(got.prim)[_np(got.hit)]
    assert (hp >= 0).all() and (hp < cfg.n_prims).all()
    assert (np.abs(_np(d.prim_verts)[hp]).sum(axis=(1, 2)) > 0).all()


@pytest.mark.parametrize("group", [1024, ii.GROUP_RAYS])
def test_kernel_order_stops_early(group):
    """The plain version walks each warp's candidates front to back and
    stops once no ray can improve: two instances of one wall, one behind
    the other, so every ray hits the front one and no warp visits the
    back one; the hits equal those of walking every candidate. With lists
    at the JAX package's 1,024-ray blocks and at the kernel's groups."""
    wall = ShapeData(quads=np.array([[0, 1, 2, 3]], np.int32),
                     positions=np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0],
                                         [-2, 2, 0]], np.float32))
    s = SceneData(cameras=[CameraData()], shapes=[wall],
                  materials=[MaterialData()],
                  instances=[InstanceData(frame=frame(10, [0, 0, z]), shape=0,
                                          material=0) for z in (-3.0, 0.0)])
    _, cfg = tsd.build_device_scene_instanced(s, device="cpu")
    tables = ii.upload(cfg.inst_tables, "cpu")
    g = np.random.default_rng(5)
    n = 2048
    ro = np.concatenate([g.uniform(-1, 1, (n, 2)), np.full((n, 1), 8.0)], axis=1)
    rays = [torch.from_numpy(x.astype(np.float32)) for x in (
        ro, np.tile([0.0, 0.0, -1.0], (n, 1)), np.full(n, 1e-4),
        np.full(n, 3.4e38))]
    lists = ii.precull(*rays, tables.wi_bbox, group)
    # both walls are candidates of every group
    assert lists[2].tolist() == [2] * (n // group)
    hit, work = ii.instanced_intersect_plain(tables, *rays, *lists, group=group)
    warps = n // ii.WARP
    assert work["groups"] == warps
    assert work["steps"] == work["votes"] == warps  # the front wall only
    # each ray wants the front wall's one cluster: its 2 real triangles
    assert work["pairs"] == n and work["tri_slots"] == 2 * n
    assert bool(hit.hit.all()) and (hit.instance == 1).all()
    # without the stopping rule (every t_low at -inf) the hits are equal;
    # each warp then visits the back wall too, and no ray enters it
    full, work_all = ii.instanced_intersect_plain(
        tables, *rays, lists[0], torch.full_like(lists[1], -float("inf")),
        lists[2], group=group)
    assert work_all["steps"] == 2 * warps and work_all["votes"] == warps
    for a, b in zip(hit, full):
        assert torch.equal(a, b)


def _beam_keys_numpy(ro, rd, tmin, tmax, wib, group):
    """beam_precull's per-block keys (pallas_cluster.py:1786-1817) in numpy
    float32 over groups of `group` rays, with the JAX function's zero
    padding to whole groups."""
    n = len(ro)
    ng = -(-n // group)
    pad = ng * group - n
    ro, rd = (np.pad(x, ((0, pad), (0, 0))) for x in (ro, rd))
    tmin, tmax = (np.pad(x, (0, pad)) for x in (tmin, tmax))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        di = np.float32(1.0) / np.where(rd == 0.0, np.float32(1e-30), rd)
        t0 = (wib[None, :, 0:3] - ro[:, None]) * di[:, None]
        t1 = (wib[None, :, 3:6] - ro[:, None]) * di[:, None]
        enter = np.minimum(t0, t1).max(axis=-1)
        exit_ = np.maximum(t0, t1).min(axis=-1)
        enter = np.maximum(enter, tmin[:, None])
        exit_ = np.minimum(exit_, tmax[:, None])
        ray_hit = enter <= exit_ * np.float32(1.00000024)
    enter_m = np.where(ray_hit, np.maximum(enter, np.float32(0.0)),
                       np.float32(np.inf))
    return enter_m.reshape(ng, group, -1).min(axis=1)


@pytest.mark.parametrize("group", sorted({1024, ii.GROUP_RAYS, 32}))
def test_cull_keys_match_jax_beam_precull(builds, group):
    """The candidate cull's plain version (what csrc/candidate_cull.cu
    computes) against the JAX beam_precull's keys recomputed in numpy over
    the same groups, equal; and precull's lists from them: the count of
    finite keys, the items in stable key order, t_low the sorted keys."""
    _, _, (_, cfg), _ = builds
    rays = [x[:2000] for x in instanced_test_rays()]  # a ragged last group
    wib = cfg.inst_tables.wi_bbox.reshape(-1, 6).astype(np.float32)
    want = _beam_keys_numpy(*rays, wib, group)
    targs = [torch.from_numpy(x) for x in rays]
    got = ii.candidate_keys_plain(*targs, torch.from_numpy(wib), group)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    finite = np.isfinite(want)
    assert finite.any()
    if group == 32:  # larger groups of these rays enter all five items
        assert not finite.all(), "the cull drops some (group, item) pairs"
    order, tlow, cnt = ii.precull(*targs, torch.from_numpy(wib), group)
    np.testing.assert_array_equal(cnt.numpy(), finite.sum(axis=1))
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want, axis=1, kind="stable"))
    np.testing.assert_array_equal(tlow.numpy(), np.sort(want, axis=1))


@pytest.mark.parametrize("budget", [60, 1_000_000])
def test_hybrid_matches_jax(budget):
    s = instanced_test_scene()
    d, cfg = tsd.build_device_scene_instanced(s, hybrid_budget=budget,
                                              device="cpu")
    dj, cfg_j = jsd.build_device_scene_instanced(to_jax_scene(s),
                                                 hybrid_budget=budget)
    assert len(cfg.inst_tables.wi_inst) == len(cfg_j.inst_tables.wi_inst)
    np.testing.assert_array_equal(cfg.hyb_remap, cfg_j.hyb_remap)
    jr, tr = _both(instanced_test_rays())
    want = jint.make_intersect_hybrid(dj, cfg_j, on_tpu=False)(*jr)
    ref = _port_flat_ref(s, tr)
    for intersect in (tint.make_intersect(d, cfg), tint.build_intersector(d, cfg)):
        got = intersect(*tr)
        _check_vs_jax(want, got)
        check_vs_flat(ref, got)


def test_instanced_scenes_route_like_jax():
    """testing.instanced_scene / hybrid_scene at reduced size: the port's
    build routes as the JAX package's (the same flattened shapes, soup
    and work items) under a budget that flattens the room and the small
    meshes only."""
    for s, budget, mask in (
            (instanced_scene(3, (8, 6)), 300, [True] * 4 + [False, True]),
            (hybrid_scene(4, 4, 3, 12), 300, [True] * 5 + [False])):
        _, cfg = tsd.build_device_scene(s, instancing=True,
                                        hybrid_budget=budget, device="cpu")
        sj = to_jax_scene(s)
        flat_j = jflat.flatten_scene(sj, expand_prims=False)
        assert jinst.select_flatten_shapes(flat_j, budget).tolist() == mask
        _, cfg_j = jsd.build_device_scene_instanced(sj, hybrid_budget=budget)
        assert len(cfg.hyb_world_verts) == len(cfg_j.hyb_world_verts)
        np.testing.assert_array_equal(cfg.hyb_remap, cfg_j.hyb_remap)
        np.testing.assert_array_equal(cfg.inst_tables.wi_inst,
                                      cfg_j.inst_tables.wi_inst)
        assert dataclasses.is_dataclass(cfg.inst_tables)


def _shape_sups(flat, sup=32):
    """Superclusters of each shape, as build_instanced_tables pads them."""
    pp = np.diff(flat.geometry.shape_prim_offset)
    return np.where(pp > 0, -(-np.maximum(-(-pp // 64), 1) // sup), 0)


@pytest.mark.parametrize("which", ["instanced", "hybrid"])
def test_full_size_scene_counts(which):
    """The two main-path scenes at full size, counted without their tables
    (those are built on the card): the automatic rules pick the pure
    two-level build for instanced_scene() and the 8M-budget hybrid for
    hybrid_scene(), as the JAX rules do; quads, superclusters, work items
    and the padded shape-space prim count."""
    s = instanced_scene() if which == "instanced" else hybrid_scene()
    counts = INSTANCED_COUNTS if which == "instanced" else HYBRID_COUNTS
    assert tsd._should_instance(s)
    flat = tflat.flatten_scene(s, expand_prims=False)
    sups = _shape_sups(flat)
    inst_shape = flat.geometry.inst_shape
    budget = tsd.auto_hybrid_budget(flat)
    world = int(np.diff(flat.geometry.shape_prim_offset)[inst_shape].sum())
    if which == "instanced":
        assert (len(flat.geometry.prim_verts), world, flat.n_instances) == (
            54_288 + 6, 7_817_478, 580)
        assert budget == 0  # 580 instances < 1,024: no hybrid
        items = int(sups[inst_shape].sum())
        assert counts["soup"] == 0
    else:
        assert (world, flat.n_instances) == (26_214_406, 1_052)
        assert budget == tsd.HYBRID_FLAT_BUDGET  # > 24M world quads
        mask = tinst.select_flatten_shapes(flat, budget)
        assert mask.tolist() == [True] * 5 + [False]
        pp = np.diff(flat.geometry.shape_prim_offset)
        assert int((pp * np.bincount(inst_shape, minlength=6))[mask].sum()) == (
            counts["soup"])
        items = int(sups[inst_shape][~mask[inst_shape]].sum())
        assert items == 24 * 512
    assert (int(sups.sum()), items) == (counts["supers"], counts["items"])
    n_prims = int(sups.sum()) * 32 * 64
    assert n_prims == counts["n_prims"]
    assert n_prims >= 50_000  # both sort their wavefronts
    # the JAX rules decide alike
    sj = to_jax_scene(s)
    assert jsd._should_instance(sj)
