"""Pixel-sharded rendering and the differentiable train step over the
process group (port of julia_raytracer_tpu/parallel/mesh.py).

The JAX package shards the ray axis of a 1-D device mesh and lets XLA
GSPMD insert the gradient psum. Here the mesh is the process group
(`make_mesh`: world size, rank, device; one process when no group is
initialised): each rank traces its block of the lanes, the scene and the
parameters replicated, and the train step's gradient psum is an explicit
`all_reduce(SUM)`. Nothing else changes: the forward pass needs no
communication but the final all-gather of the outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from julia_raytracer_tpu_torch.parallel.distributed import (
    all_gather_image, distributed_render_fn,
)
from julia_raytracer_tpu_torch.render.diff import (
    diff_options, render_radiance_mean,
)
from julia_raytracer_tpu_torch.render.integrator import build_intersector
from julia_raytracer_tpu_torch.render.scene_device import resolve_device
from julia_raytracer_tpu_torch.utils.timing import span


class Mesh(NamedTuple):
    """The 1-D mesh over the pixel axis: this process's place in it."""

    world_size: int
    rank: int
    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The initialised process group (or a single process) as a Mesh on
    `device` (None: the card)."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_world_size(), dist.get_rank(), device)
    return Mesh(1, 0, device)


def local_lanes(mesh: Mesh, n: int):
    """(lanes i64 [per], real bool [per]): this rank's block of the lanes
    0 .. n - 1 padded to a multiple of the world size, the padding lanes
    clamped to the last real one and marked unreal."""
    per = -(-n // mesh.world_size)
    lane = torch.arange(mesh.rank * per, (mesh.rank + 1) * per,
                        device=mesh.device)
    return lane.clamp(max=n - 1), lane < n


def _all_reduce(x, mesh: Mesh):
    if mesh.world_size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def shard_render_fn(mesh: Mesh, dscene, config, options):
    """render(dscene, ro, rd, rng_state) over all lanes: each rank traces
    its block (distributed_render_fn) and the outputs are all-gathered;
    returns (radiance, hit, albedo, normal) of every lane on every rank."""
    local = distributed_render_fn(mesh, dscene, config, options)

    def render(dscene_, ro, rd, rng_state):
        n = ro.shape[0]
        lanes, _ = local_lanes(mesh, n)
        outs = local(dscene_, ro[lanes], rd[lanes], rng_state[lanes])
        if mesh.world_size == 1:
            return outs
        return tuple(all_gather_image(x, n) for x in outs)

    return render


def shard_train_step(mesh: Mesh, dscene, config, options, cam, width, height,
                     lr: float = 0.05):
    """step(mat_color, mat_emission, pixel_ids, target, n_samples, seed=0)
    -> (loss, new_color, new_emission): one SGD step of the pixel loss of
    render/diff.py over (material color, emission). Each rank renders its
    block of the pixel lanes; its loss is the squared error summed over
    its real lanes and divided by the global count, so the all-reduced
    (SUM) loss and gradients are those of the mean over every real pixel
    at any world size; every rank then takes the same update. A step is
    a `train_step` span (a unit of utils/timing.py) of `forward`,
    `backward` (the checkpoint's recomputed bodies under it) and
    `update`."""
    d_opts = diff_options(options, config)
    intersect = build_intersector(dscene, config)

    def step(mat_color, mat_emission, pixel_ids, target, n_samples, seed=0):
        with span("train_step"):
            with span("forward"):
                n = pixel_ids.shape[0]
                lanes, real = local_lanes(mesh, n)
                color = mat_color.detach().requires_grad_()
                emission = mat_emission.detach().requires_grad_()
                mats = dscene.materials._replace(color=color,
                                                 emission=emission)
                img = render_radiance_mean(
                    dscene._replace(materials=mats), config, d_opts, cam,
                    width, height, pixel_ids[lanes], n_samples, seed,
                    intersector=intersect)
                err = torch.where(real[:, None], (img - target[lanes]) ** 2,
                                  0.0)
                loss = err.sum() / (3 * n)
            with span("backward"):
                g_color, g_emission = torch.autograd.grad(loss,
                                                          (color, emission))
            with span("update"):
                loss = _all_reduce(loss.detach(), mesh)
                g_color = _all_reduce(g_color, mesh)
                g_emission = _all_reduce(g_emission, mesh)
                return (loss, mat_color.detach() - lr * g_color,
                        mat_emission.detach() - lr * g_emission)

    step.intersect = intersect
    return step
