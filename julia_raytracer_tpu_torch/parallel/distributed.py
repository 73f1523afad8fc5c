"""Multi-process rendering on torch.distributed (port of
julia_raytracer_tpu/parallel/distributed.py).

The JAX package connects its processes with `jax.distributed` and lets
GSPMD place the collectives. Here each process is one rank of a
torch.distributed process group, with one card (NCCL) or, when the caller
asks for the CPU, gloo:

- `init_distributed` joins the group; its arguments default from the
  standard RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT variables
  (`init_method="env://"`).
- The scene is replicated: every rank builds the same tables from the
  same scene, and `broadcast_host_arrays` overwrites each rank's float
  tensors with rank 0's, so the replicas cannot drift apart bit for bit.
- Pixels are split over the ranks (`shard_pixels`: padded to a multiple
  of the world size, the padding lanes carry id n_pixels); each rank
  traces only its own lanes (`distributed_render_fn`: no cross-rank
  sort, rays never communicate) and `all_gather_image` assembles the
  image on every rank. The counter-based RNG keys on pixel ids, so the
  result does not depend on the split.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from julia_raytracer_tpu_torch.render.integrator import (
    build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.scene_device import resolve_device


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None):
    """Join the process group and return (world_size, rank). `backend`:
    "nccl" by default (the card, which must be present: this rank takes
    card rank % device_count), "gloo" when the caller asks for the CPU.
    `init_method`: "env://" by default (MASTER_ADDR / MASTER_PORT);
    `world_size` and `rank` default to WORLD_SIZE and RANK."""
    def env_int(value, name):
        if value is not None:
            return int(value)
        if name not in os.environ:
            raise ValueError(f"init_distributed: pass {name.lower()} or set {name}")
        return int(os.environ[name])

    world_size = env_int(world_size, "WORLD_SIZE")
    rank = env_int(rank, "RANK")
    backend = backend or "nccl"
    if backend == "nccl":
        resolve_device(None)  # raises without a card
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size, rank


def broadcast_host_arrays(tree):
    """`tree` (a tensor or NamedTuples of them, a DeviceScene) with every
    float tensor replaced by rank 0's copy (dist.broadcast); other leaves
    are kept."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point():
            return tree
        out = tree.clone()
        dist.broadcast(out, 0)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(broadcast_host_arrays(x) for x in tree))
    return tree


def shard_pixels(world_size: int, rank: int, n_pixels: int, device=None):
    """Rank `rank`'s pixel ids (i32, on `device`; None: the card): the
    rank's block of the ids 0 .. n_pixels - 1 padded to a multiple of
    `world_size`, the padding lanes carrying id n_pixels."""
    device = resolve_device(device)
    per = -(-n_pixels // world_size)
    ids = torch.arange(rank * per, (rank + 1) * per, dtype=torch.int32,
                       device=device)
    return torch.clamp(ids, max=n_pixels)


def all_gather_image(local, n_pixels: int | None = None):
    """Every rank's `local` lanes (equal shapes, the ranks' blocks in rank
    order) concatenated on every rank, cut to the first `n_pixels` (the
    real pixels) when given."""
    is_bool = local.dtype == torch.bool
    src = (local.to(torch.uint8) if is_bool else local).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    out = out.bool() if is_bool else out
    return out if n_pixels is None else out[:n_pixels]


def distributed_render_fn(mesh, dscene, config, options):
    """render(dscene, ro, rd, rng_state) -> (radiance, hit, albedo, normal)
    of this rank's lanes: the replicated scene, the intersector built
    once on `mesh.device`, each rank tracing its own lanes with no
    cross-rank sort."""
    intersect = build_intersector(dscene, config)

    def render(dscene_, ro, rd, rng_state):
        radiance, hit, albedo, normal, _ = trace_wavefront(
            dscene_, config, options, ro, rd, rng_state,
            intersector=intersect)
        return radiance, hit, albedo, normal

    return render
