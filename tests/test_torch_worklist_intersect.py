"""The worklist intersector's plain PyTorch version (what the CUDA kernel
csrc/worklist_intersect.cu computes, and what the wrapper runs for CPU
tensors) against the Pallas TPU kernel it replaces, run in interpret mode
with the rectangular grid and sup=2 (several superclusters), and against
the JAX brute-force intersector; and the port's precull against the JAX
precull's logic recomputed in numpy.

Tolerances: check() of tests/test_pallas_kernels.py (testing.check_hits):
hit masks equal, > 99.9% same prim on hits, t within 1e-4, u and
position within 5e-3, normal within 1e-3. The two kernels sum the affine
transforms in different orders, so t and uv differ in the last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.pallas_cluster import make_cluster_intersect_worklist
from julia_raytracer_tpu.ops.traversal import intersect_bruteforce as jax_brute
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import check_hits, sphere_grid_scene

SUP = 2


def _soup_case():
    """The multi-supercluster soup of test_pallas_kernels.py: 1,200 quads
    stretched along x, 2,048 rays from x = -4 into it, unbounded tmax."""
    rng = np.random.default_rng(7)
    q = 1200
    base = rng.uniform(-1, 1, (q, 3)).astype(np.float32)
    base[:, 0] += np.linspace(0, 40, q, dtype=np.float32)
    e1 = rng.uniform(0.05, 0.3, (q, 3)).astype(np.float32)
    e2 = rng.uniform(0.05, 0.3, (q, 3)).astype(np.float32)
    pv = np.stack([base, base + e1, base + e2, base + e2], axis=1)
    n = 2048
    ro = np.tile([-4.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 0] = np.abs(rd[:, 0]) * 8 + 1
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 3.4e38, np.float32)
    return pv, (np.arange(q) % 37).astype(np.int32), ro, rd, tmax


def _sphere_rays(g, n):
    """Camera rays, rays from inside the room (some axis-parallel), finite
    and unbounded tmax."""
    ro = np.empty((n, 3), np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    half = n // 2
    ro[:half] = [0.0, 1.0, 3.9]
    rd[:half, 2] = -np.abs(rd[:half, 2]) - 2.0
    ro[half:] = g.uniform([-0.95, 0.02, -0.95], [0.95, 1.95, 0.95], (n - half, 3))
    axis = g.integers(0, 3, n)
    flat = g.random(n) < 0.15  # one zero direction component
    rd[flat, axis[flat]] = 0.0
    line = g.random(n) < 0.05  # two zero components: along an axis
    rd[line] = 0.0
    rd[line, axis[line]] = 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 3.4e38, np.float32)
    tmax[::3] = g.uniform(0.2, 3.0, len(tmax[::3]))  # finite: cuts some hits
    return ro, rd, tmax


def _sphere_case(all_miss=False):
    _, cfg = build_device_scene(sphere_grid_scene(2, 16), device="cpu")
    g = np.random.default_rng(11)
    n = 2500  # not a multiple of 1024
    ro, rd, tmax = _sphere_rays(g, n)
    if all_miss:
        # shorter than any geometry from the camera: every lane misses
        ro[:] = [0.0, 1.0, 3.9]
        tmax[:] = 2.0
    return cfg.host_prim_verts, cfg.host_prim_instance, ro, rd, tmax


CASES = {
    "soup": _soup_case,
    "spheres": _sphere_case,
    "spheres_all_miss": lambda: _sphere_case(all_miss=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    pv, inst, ro, rd, tmax = CASES[request.param]()
    tmin = np.full(len(ro), 1e-4, np.float32)
    rays = (ro, rd, tmin, tmax)
    tables = wl.pack_tables(pv, inst, sup=SUP)
    targs = [torch.from_numpy(x) for x in rays]
    order, cnt = wl.precull(*targs, tables.sbbox)
    got, work = wl.worklist_intersect_plain(tables, *targs, order, cnt)
    jargs = [jnp.asarray(x) for x in rays]
    want = make_cluster_intersect_worklist(
        pv, inst, interpret=True, sup=SUP, flat_grid=False)(*jargs)
    brute = jax_brute(jnp.asarray(pv), *jargs, prim_instance=jnp.asarray(inst))
    return dict(name=request.param, pv=pv, inst=inst, rays=rays, tables=tables,
                order=order, cnt=cnt, got=got, work=work, want=want,
                brute=brute)


def test_plain_matches_pallas_worklist_kernel(case):
    got, want = case["got"], case["want"]
    check_hits(want, got)
    hit = got.hit.numpy()
    if case["name"] == "spheres_all_miss":
        assert not hit.any()
    else:
        assert 0.05 < hit.mean() < 1.0
    # the miss convention of both: prim -1, t = tmax, instance 0
    np.testing.assert_array_equal(got.prim.numpy()[~hit], -1)
    np.testing.assert_array_equal(np.asarray(want.prim)[~hit], -1)
    np.testing.assert_array_equal(got.t.numpy()[~hit], case["rays"][3][~hit])
    np.testing.assert_array_equal(got.instance.numpy()[~hit], 0)
    same = hit & (got.prim.numpy() == np.asarray(want.prim))
    np.testing.assert_array_equal(got.instance.numpy()[same],
                                  np.asarray(want.instance)[same])


def test_plain_matches_bruteforce(case):
    got, brute = case["got"], case["brute"]
    check_hits(brute, got)
    hit = got.hit.numpy()
    np.testing.assert_array_equal(got.instance.numpy()[hit],
                                  case["inst"][got.prim.numpy()[hit]])
    work = case["work"]
    if hit.any():
        assert 0 < work["block_pairs"] <= work["warp_pairs"] <= work["pairs"]


def _precull_numpy(ro, rd, tmin, tmax, sbbox):
    """pallas_cluster.py precull (:1262-1289) in numpy float32, with the
    JAX function's zero padding to whole 1024-ray blocks."""
    n = len(ro)
    nb = -(-n // 1024)
    pad = nb * 1024 - n
    ro, rd = (np.pad(x, ((0, pad), (0, 0))) for x in (ro, rd))
    tmin, tmax = (np.pad(x, (0, pad)) for x in (tmin, tmax))
    s = len(sbbox)
    o = ro[:, None, :]
    d = rd[:, None, :]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        di = np.float32(1.0) / np.where(d == 0.0, np.float32(1e-30), d)
        t0 = (sbbox[None, :, 0:3] - o) * di
        t1 = (sbbox[None, :, 3:6] - o) * di
        enter = np.minimum(t0, t1).max(axis=-1)
        exit_ = np.maximum(t0, t1).min(axis=-1)
        enter = np.maximum(enter, tmin[:, None])
        exit_ = np.minimum(exit_, tmax[:, None])
        ray_hit = enter <= exit_ * np.float32(1.00000024)
    blk_hit = ray_hit.reshape(nb, 1024, s).any(axis=1)
    enter_m = np.where(ray_hit, np.maximum(enter, np.float32(0.0)), np.float32(np.inf))
    blk_enter = enter_m.reshape(nb, 1024, s).min(axis=1)
    key = np.where(blk_hit, blk_enter, np.float32(np.inf))
    return np.argsort(key, axis=1, kind="stable"), blk_hit.sum(axis=1)


def test_precull_matches_jax_logic(case):
    order, cnt = _precull_numpy(*case["rays"], case["tables"].sbbox.numpy())
    got_order, got_cnt = case["order"].numpy(), case["cnt"].numpy()
    np.testing.assert_array_equal(got_cnt, cnt)
    assert got_order.dtype == got_cnt.dtype == np.int32
    for b, c in enumerate(cnt):
        np.testing.assert_array_equal(got_order[b, :c], order[b, :c])
    if case["name"] == "soup":
        # several superclusters per block, so the order is exercised
        assert cnt.min() > 1 and len(case["tables"].sbbox) > 4


def test_precull_chunks_agree(case, monkeypatch):
    """Cutting the [rays, S] precull into block chunks changes nothing."""
    targs = [torch.from_numpy(x) for x in case["rays"]]
    monkeypatch.setattr(wl, "PRECULL_BYTES", 1024 * 4 * len(case["tables"].sbbox))
    order, cnt = wl.precull(*targs, case["tables"].sbbox)
    assert torch.equal(cnt, case["cnt"]) and torch.equal(order, case["order"])


def test_wrapper_runs_plain_on_cpu(case):
    targs = [torch.from_numpy(x) for x in case["rays"]]
    got = wl.worklist_intersect(case["tables"], *targs)
    for a, b in zip(got, case["got"]):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_input():
    tables = wl.pack_tables(_soup_case()[0], None, sup=SUP)
    meta = [torch.zeros(s, device="meta") for s in ((4, 3), (4, 3), (4,), (4,))]
    with pytest.raises(ValueError):
        wl.worklist_intersect(tables, *meta)
    cpu = [torch.zeros(s) for s in ((4, 3), (4, 3), (4,), (4,))]
    order, cnt = wl.precull(*cpu, tables.sbbox)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        wl.worklist_intersect_kernel(tables, *cpu, order, cnt)
