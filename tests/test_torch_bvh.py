"""The port's BVH walk (ops/traversal.py intersect_bvh) against the JAX
package's intersect_bvh and the port's intersect_bruteforce, over the
nodes of the port's ops/bvh.py (a copy of the JAX builder: the same
nodes), on seeded random quad soups and the Cornell box's sorted prims.

Contract of check() in tests/test_pallas_kernels.py:40-55
(testing.check_hits): hit mask equal, > 99.9% same prim on hit lanes, t
within rtol 1e-4 (atol 1e-4), u, v, position within 5e-3 and the element
normal within 1e-3 where the prim agrees, the instance equal there.
`find_any`: the hit mask equal to the closest-hit walk's, and every
reported hit a real hit of its prim."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from julia_raytracer_tpu.ops.traversal import intersect_bvh as jax_bvh
from julia_raytracer_tpu_torch.ops.bvh import build_bvh, quad_bounds
from julia_raytracer_tpu_torch.ops.geometry import intersect_quad
from julia_raytracer_tpu_torch.ops.traversal import (
    intersect_bruteforce, intersect_bvh,
)
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import check_hits, cornell_scene

N_RAYS = 1500


def _soup(q, seed):
    """q random quads about the unit cube (a third degenerate), sorted
    into the leaf order of their BVH; (nodes, verts, instance ids)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-1, 1, (q, 1, 3))
    verts = (c + g.normal(0, 0.15, (q, 4, 3))).astype(np.float32)
    verts[::3, 3] = verts[::3, 2]
    tree = build_bvh(*quad_bounds(verts))
    inst = (np.arange(q) % 7).astype(np.int32)
    return tree.nodes, verts[tree.order], inst[tree.order]


def _cornell():
    d, cfg = build_device_scene(cornell_scene(), device="cpu")
    assert not cfg.root_is_leaf
    return d.nodes.numpy(), d.prim_verts.numpy(), d.prim_instance.numpy()


def _rays(seed, box=2.0):
    g = np.random.default_rng(seed)
    ro = g.uniform(-box, box, (N_RAYS, 3)).astype(np.float32)
    target = g.uniform(-1, 1, (N_RAYS, 3))
    rd = (target - ro).astype(np.float32)
    rd[::5] = g.normal(size=(len(rd[::5]), 3))  # some point anywhere
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-4, np.float32)
    tmax = np.full(N_RAYS, 3.4e38, np.float32)
    tmax[::11] = 0.5  # some end short of the soup
    return ro, rd, tmin, tmax


CASES = {
    "soup_40": lambda: _soup(40, 1),
    "soup_700": lambda: _soup(700, 2),
    "cornell": _cornell,
}


@pytest.fixture(params=sorted(CASES))
def case(request):
    nodes, verts, inst = CASES[request.param]()
    rays = _rays(len(verts))
    if request.param == "cornell":
        # from inside the room, above the boxes: a box's bottom lies in
        # the floor's plane, and rays from inside a box meet the two tied
        g = np.random.default_rng(9)
        rays[0][:] = g.uniform([-0.9, 1.25, -0.9], [0.9, 1.9, 0.9],
                               (N_RAYS, 3)).astype(np.float32)
    return nodes, verts, inst, rays


def _port(nodes, verts, inst, rays, **kw):
    return intersect_bvh(torch.from_numpy(nodes), torch.from_numpy(verts),
                         *(torch.from_numpy(x) for x in rays),
                         prim_instance=torch.from_numpy(inst), **kw)


def test_bvh_matches_jax_bvh(case):
    nodes, verts, inst, rays = case
    want = jax_bvh(jnp.asarray(nodes), jnp.asarray(verts),
                   *(jnp.asarray(x) for x in rays),
                   prim_instance=jnp.asarray(inst))
    got = _port(nodes, verts, inst, rays)
    assert 0.05 < got.hit.float().mean() < 0.95
    check_hits(want, got)
    # misses: prim -1 and t = tmax, as in the JAX package
    miss = ~got.hit
    assert (got.prim[miss] == -1).all()
    assert torch.equal(got.t[miss], torch.from_numpy(rays[3])[miss])


def test_bvh_matches_bruteforce(case):
    nodes, verts, inst, rays = case
    ref = intersect_bruteforce(torch.from_numpy(verts),
                               *(torch.from_numpy(x) for x in rays),
                               prim_instance=torch.from_numpy(inst))
    check_hits(ref, _port(nodes, verts, inst, rays))


def test_find_any_hit_mask(case):
    nodes, verts, inst, rays = case
    closest = _port(nodes, verts, inst, rays)
    anyhit = _port(nodes, verts, inst, rays, find_any=True)
    want = jax_bvh(jnp.asarray(nodes), jnp.asarray(verts),
                   *(jnp.asarray(x) for x in rays), find_any=True)
    np.testing.assert_array_equal(anyhit.hit.numpy(), closest.hit.numpy())
    np.testing.assert_array_equal(anyhit.hit.numpy(), np.asarray(want.hit))
    # every reported hit is a hit of its quad, no nearer than the closest
    m = anyhit.hit
    pv = torch.from_numpy(verts)[anyhit.prim[m].long()]
    ro, rd, tmin, tmax = (torch.from_numpy(x)[m] for x in rays)
    h, _, _, t = intersect_quad(ro, rd, tmin, tmax, pv[:, 0], pv[:, 1],
                                pv[:, 2], pv[:, 3])
    assert h.all()
    torch.testing.assert_close(t, anyhit.t[m], rtol=1e-4, atol=1e-4)
    assert (anyhit.t[m] >= closest.t[m] * (1 - 1e-6)).all()
