"""The dense intersector's plain PyTorch version (what the CUDA kernel
csrc/dense_intersect.cu computes, and what the wrapper runs for CPU
tensors) against the Pallas TPU kernel it replaces, run in interpret
mode, and against the CPU reference intersector intersect_bruteforce on
hit lanes. Rays <= 8192 per case: interpret mode is slow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.pallas_intersect import make_bruteforce_pallas
from julia_raytracer_tpu.ops.traversal import intersect_bruteforce as jax_brute
from julia_raytracer_tpu_torch.ops import dense_intersect as di
from julia_raytracer_tpu_torch.ops.traversal import intersect_bruteforce
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import check_hits, cornell_scene

N = 4096


def _cornell_case():
    _, cfg = build_device_scene(cornell_scene(), device="cpu")
    g = np.random.default_rng(0)
    ro = np.empty((N, 3), np.float32)
    ro[: N // 2] = [0.0, 1.0, 3.9]  # camera rays, some leave the open front
    ro[N // 2:] = g.uniform([-0.9, 0.05, -0.9], [0.9, 1.95, 0.9], (N // 2, 3))
    rd = g.normal(size=(N, 3)).astype(np.float32)
    rd[: N // 2, 2] = -np.abs(rd[: N // 2, 2]) - 1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(N, 3.4e38, np.float32)
    tmax[::7] = 1.5  # finite tmax: some hits move out of range
    return cfg.host_prim_verts, cfg.host_prim_instance, ro, rd, tmax


def _random_quads_case():
    g = np.random.default_rng(1)
    q = 24  # interpret mode unrolls every quad: its time grows with q
    base = g.uniform(-1, 1, (q, 3)).astype(np.float32)
    e1 = g.uniform(-0.6, 0.6, (q, 3)).astype(np.float32)
    e2 = g.uniform(-0.6, 0.6, (q, 3)).astype(np.float32)
    verts = np.stack([base, base + e1, base + e1 + e2, base + e2], axis=1)
    verts[::3, 3] = verts[::3, 2]  # degenerate quads: p3 == p4 (triangles)
    inst = g.integers(0, 9, q).astype(np.int32)
    ro = g.uniform(-3, 3, (N, 3)).astype(np.float32)
    rd = (g.uniform(-1, 1, (N, 3)) - ro * 0.3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(N, 3.4e38, np.float32)
    return verts, inst, ro, rd, tmax


@pytest.fixture(scope="module", params=["cornell", "random_quads"])
def case(request):
    verts, inst, ro, rd, tmax = (
        _cornell_case() if request.param == "cornell" else _random_quads_case()
    )
    tmin = np.full(N, 1e-4, np.float32)
    table = torch.from_numpy(di.build_prim_table(verts, inst))
    got = di.dense_intersect(table, *(torch.from_numpy(x)
                                      for x in (ro, rd, tmin, tmax)))
    jargs = [jnp.asarray(x) for x in (ro, rd, tmin, tmax)]
    return verts, inst, jargs, (ro, rd, tmin, tmax), got


def test_plain_matches_pallas_kernel(case):
    verts, inst, jargs, _, got = case
    ref = make_bruteforce_pallas(verts, inst, interpret=True)(*jargs)
    check_hits(ref, got)
    # both report the miss convention: prim -1, t = tmax, instance of the hit
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.instance.numpy(), np.asarray(ref.instance))
    miss = ~got.hit.numpy()
    np.testing.assert_array_equal(got.t.numpy()[miss], jargs[3][miss])


def test_hit_lanes_match_bruteforce(case):
    verts, inst, jargs, _, got = case
    ref = jax_brute(jnp.asarray(verts), *jargs, prim_instance=jnp.asarray(inst))
    check_hits(ref, got)
    hit = got.hit.numpy()
    assert 0.05 < hit.mean() < 1.0  # both hits and misses are exercised
    np.testing.assert_array_equal(got.instance.numpy()[hit],
                                  np.asarray(ref.instance)[hit])


def test_port_bruteforce_matches_jax(case):
    """The port's own CPU reference intersector, all lanes (misses: prim 0,
    t = F32_MAX, as in the JAX package)."""
    verts, inst, jargs, targs, _ = case
    ref = jax_brute(jnp.asarray(verts), *jargs, prim_instance=jnp.asarray(inst))
    got = intersect_bruteforce(torch.from_numpy(verts),
                               *(torch.from_numpy(x) for x in targs),
                               prim_instance=torch.from_numpy(inst))
    check_hits(ref, got)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.t.numpy()[~got.hit.numpy()],
                                  np.asarray(ref.t)[~got.hit.numpy()])


def test_wrapper_rejects_bad_input():
    """Over 112 quads is refused; a tensor neither on the CPU nor on a
    CUDA device has no version to run."""
    with pytest.raises(ValueError):
        di.build_prim_table(np.zeros((113, 4, 3), np.float32))
    meta = [torch.zeros(s, device="meta") for s in ((1, 16), (4, 3), (4, 3),
                                                    (4,), (4,))]
    with pytest.raises(ValueError):
        di.dense_intersect(*meta)
