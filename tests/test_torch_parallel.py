"""The port's multi-process render and train step (parallel/mesh.py,
parallel/distributed.py) on the CPU: 2 processes on gloo, spawned with
torch.multiprocessing and joined through a file:// store in tmp_path,
against the same calls in this single process (tests/test_multihost.py
and tests/test_parallel.py hold the JAX package's counterparts).

  - the sharded render (shard_render_fn; and shard_pixels +
    distributed_render_fn + all_gather_image), all-gathered, equals the
    single-process render bit for bit at a pixel count that needs
    padding (81 pixels over 2 ranks);
  - broadcast_host_arrays gives every rank rank 0's float tensors;
  - one shard_train_step gives the single-process step's loss and
    parameters within rtol 1e-5 (the all-reduce adds the two ranks'
    partial gradients in another order than one process adds its lanes),
    on the Cornell box and on the instanced test scene of
    tests/test_torch_diff_instanced.py (the two-level build, hybrid
    budget 0: the work-item intersector under the instanced re-test).

Each test joins its processes within JOIN_S seconds, then kills them and
fails: a hung process group cannot run into the suite's clock."""

import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from julia_raytracer_tpu_torch.parallel import distributed as pd
from julia_raytracer_tpu_torch.parallel import mesh as pm
from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.render import renderer as tren
from julia_raytracer_tpu_torch.render.diff import make_param_loss
from julia_raytracer_tpu_torch.render.integrator import TraceOptions
from julia_raytracer_tpu_torch.render.scene_device import (
    build_device_scene_instanced,
)
from julia_raytracer_tpu_torch.testing import cornell_scene
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from torch_parity import instanced_test_camera, instanced_test_scene

WORLD = 2
RES, BOUNCES = 9, 4  # 81 pixels: 41 lanes a rank, one of them padding
JOIN_S = 120
LR = 0.05


def _renderer():
    return tren.Renderer(cornell_scene(),
                         tren.Params(resolution=RES, bounces=BOUNCES),
                         device="cpu")


def _rays(r, pixel_ids, sample=0, seed=0):
    rng = rng_mod.seed_state(pixel_ids, sample, seed)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = torch.stack([pixel_ids % RES, pixel_ids // RES], dim=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (RES, RES), puv, luv, False)
    return ro, rd, rng


def _train_parts(scene):
    """(dscene, config, options, camera arrays) of a train step's scene on
    the CPU: the Cornell box through the Renderer, or the instanced test
    scene through the two-level build, seen from (0, 0, 8)."""
    if scene == "cornell":
        r = _renderer()
        return r.dscene, r.config, r.options, r.cam_arrays
    d, cfg = build_device_scene_instanced(
        instanced_test_scene(emissive=True, env=True), hybrid_budget=0,
        device="cpu")
    return (d, cfg, TraceOptions(sampler="path", bounces=BOUNCES),
            tren.camera_arrays(instanced_test_camera(), "cpu"))


def _train_inputs(dscene):
    g = np.random.default_rng(11)
    color = dscene.materials.color + torch.as_tensor(
        g.uniform(-0.1, 0.1, tuple(dscene.materials.color.shape)),
        dtype=torch.float32)
    target = torch.as_tensor(g.uniform(0.0, 0.4, (RES * RES, 3)),
                             dtype=torch.float32)
    return color, dscene.materials.emission, target


def _worker(rank, task, init_file, out_dir):
    try:
        torch.set_num_threads(1)
        world, got_rank = pd.init_distributed(
            backend="gloo", init_method=f"file://{init_file}",
            world_size=WORLD, rank=rank)
        assert (world, got_rank) == (WORLD, rank)
        mesh = pm.make_mesh("cpu")
        assert mesh == pm.Mesh(WORLD, rank, torch.device("cpu"))
        n = RES * RES
        pix = torch.arange(n, dtype=torch.int32)
        out = {}
        if task == "render":
            r = _renderer()
            ro, rd, rng = _rays(r, pix)
            render = pm.shard_render_fn(mesh, r.dscene, r.config, r.options)
            out["sharded"] = render(r.dscene, ro, rd, rng)
            ids = pd.shard_pixels(WORLD, rank, n, "cpu")
            local = pd.distributed_render_fn(mesh, r.dscene, r.config,
                                             r.options)
            outs = local(r.dscene, *_rays(r, ids))
            out["gathered"] = tuple(pd.all_gather_image(x, n) for x in outs)
            out["ids"] = pd.all_gather_image(ids)
            # rank 1's scene drifts; the broadcast restores rank 0's
            mats = r.dscene.materials
            drift = r.dscene._replace(materials=mats._replace(
                color=mats.color + rank))
            out["broadcast"] = pd.broadcast_host_arrays(drift).materials.color
        else:
            parts = _train_parts(task)
            color, emission, target = _train_inputs(parts[0])
            step = pm.shard_train_step(mesh, *parts, RES, RES, lr=LR)
            out["step"] = step(color, emission, pix, target, 1)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


def _spawn(task, tmp_path) -> list[dict]:
    """Run _worker on WORLD processes; their saved outputs by rank."""
    ctx = tmp.get_context("spawn")
    init_file = tmp_path / "store"
    procs = [ctx.Process(target=_worker,
                         args=(rank, task, str(init_file), str(tmp_path)))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        pytest.fail(f"{len(hung)} of {WORLD} processes still ran after "
                    f"{JOIN_S} s and were killed")
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp_path / f"rank{rank}.pt") for rank in range(WORLD)]


def test_sharded_render_equals_single_process(tmp_path):
    outs = _spawn("render", tmp_path)
    r = _renderer()
    n = RES * RES
    pix = torch.arange(n, dtype=torch.int32)
    single = pm.shard_render_fn(pm.make_mesh("cpu"), r.dscene, r.config,
                                r.options)(r.dscene, *_rays(r, pix))
    assert single[0].shape == (n, 3) and single[0].mean() > 0
    for out in outs:
        for key in ("sharded", "gathered"):
            for got, want in zip(out[key], single, strict=True):
                assert got.shape == want.shape
                assert torch.equal(got, want), key
        # 82 lanes: the padding lane carries id n_pixels
        assert torch.equal(out["ids"], torch.cat([pix, torch.tensor(
            [n], dtype=torch.int32)]))
        assert torch.equal(out["broadcast"], r.dscene.materials.color)


@pytest.mark.parametrize("scene", ["cornell", "instanced"])
def test_sharded_train_step_matches_single_process(tmp_path, scene):
    outs = _spawn(scene, tmp_path)
    parts = _train_parts(scene)
    color, emission, target = _train_inputs(parts[0])
    pix = torch.arange(RES * RES, dtype=torch.int32)
    step = pm.shard_train_step(pm.make_mesh("cpu"), *parts, RES, RES, lr=LR)
    want = step(color, emission, pix, target, 1)
    # the single-process step is make_param_loss's SGD step
    c = color.clone().requires_grad_()
    e = emission.clone().requires_grad_()
    loss = make_param_loss(*parts, RES, RES)(c, e, pix, target, 1)
    loss.backward()
    torch.testing.assert_close(want[0], loss.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(want[1], color - LR * c.grad, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(want[2], emission - LR * e.grad, rtol=1e-5,
                               atol=1e-7)
    assert not torch.equal(want[2], emission)  # the light's emission moves
    for out in outs:
        for got, w in zip(out["step"], want, strict=True):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-7)
    assert torch.equal(outs[0]["step"][1], outs[1]["step"][1])


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None (and the NCCL default) means the card: without one the
    new entry points raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pm.make_mesh(),
                 lambda: pd.shard_pixels(2, 0, 10),
                 lambda: pd.init_distributed(world_size=1, rank=0)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        pd.init_distributed(backend="gloo")
    assert pm.make_mesh("cpu") == pm.Mesh(1, 0, torch.device("cpu"))
    assert torch.equal(pd.shard_pixels(4, 3, 10, "cpu"),
                       torch.tensor([9, 10, 10], dtype=torch.int32))
