"""Inverse rendering: the program's differentiable train step, one SGD step
of the squared pixel error over the material colour and emission tables.

One step is the `step` that the program's `shard_train_step(make_mesh(
device), ...)` returns, over every pixel of the frame with the traffic's
samples a pixel, its loss read back each step as a user logs it, and
the updated tables carried into the next step. Step k renders with seed
`--seed` + k, so no two steps trace the same paths. The starting tables
are the configuration's own, perturbed from the seed; the target image
is made from the seed without the program (`target_image`).

Set-up builds the renderer (span `scene_build`) and the step (span
`step_build`) once, then drives that step through the traffic's first
`warm_steps` steps (span `warm`), which the output check follows; the
window takes the same object on. With --trace 1, the traced span follows the window.

Output check, once the window has closed and the program's state is
freed: the plain reference (benchmark/reference/tracer.py
`train_steps`) takes each of the first `check_steps` steps from the
tables that step started from, with the same target and seed: the first
from the start tables the benchmark made, each later one from the
tables the program returned, the output the step before it is judged
by. Compared: each step's loss, and the norm of each step's gradient as
the optimizer took it, (tables before - after) / lr, by its worst leaf
(colour, emission); the median over the steps of each. One lane of a
step's 262,144 that rounding sends across an edge apart from the
reference's path carries its whole unclamped radiance into that step's
loss and gradient; taken from the program's tables, it moves no other
step, and the median sets it aside. A fault of the program moves every
step.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmark.modes.common import Run, build_scene, profile_units, to_program_scene

MASK = 0xFFFFFFFF


def step_seed(seed: int, k: int) -> int:
    return (seed + k) & MASK


def start_tables(desc: dict, seed: int, perturb: float):
    """(colour [M, 3], emission [M, 3]) float32: the configuration's own,
    each entry scaled by 1 + perturb * U(-1, 1) from the seed; colours
    kept in [0, 1]."""
    g = np.random.default_rng([seed & MASK, seed >> 32, 1])
    color = np.asarray([m["color"] for m in desc["materials"]], np.float32)
    emission = np.asarray([m["emission"] for m in desc["materials"]],
                          np.float32)
    color = np.clip(color * (1 + perturb * g.uniform(-1, 1, color.shape)), 0, 1)
    emission = emission * (1 + perturb * g.uniform(-1, 1, emission.shape))
    return color.astype(np.float32), emission.astype(np.float32)


def target_image(seed: int, width: int, height: int) -> np.ndarray:
    """[width * height, 3] float32 in [0.1, 0.7]: a smooth image of three
    waves a channel, made from the seed."""
    g = np.random.default_rng([seed & MASK, seed >> 32, 2])
    y, x = np.meshgrid(np.arange(height) / height, np.arange(width) / width,
                       indexing="ij")
    out = np.full((height, width, 3), 0.4)
    for c in range(3):
        for _ in range(3):
            fx, fy = g.uniform(-3, 3, 2)
            out[..., c] += 0.1 * np.cos(2 * np.pi * (fx * x + fy * y)
                                        + g.uniform(0, 2 * np.pi))
    return out.reshape(-1, 3).astype(np.float32)


def leaf_gap(got: list, want: list) -> float:
    """Worst leaf of |norm(got) - norm(want)| / max(norm(want), median
    leaf norm), leaves whose reference norm is under a thousandth of the
    median's left out."""
    ng = [float(np.linalg.norm(g)) for g in got]
    nw = [float(np.linalg.norm(w)) for w in want]
    med = float(np.median(nw))
    gaps = [abs(a - b) / max(b, med, 1e-30) for a, b in zip(ng, nw)
            if b >= 1e-3 * med]
    return max(gaps) if gaps else 0.0


def judge(losses: list, tables: list, ref_losses: list, ref_grads: list,
          lr: float) -> dict:
    """The output check's numbers, and each step's gaps under "steps".
    `losses`: each checked step's loss; `tables`: the (colour, emission)
    tables before each step and after the last, as the run judged
    returned them; `ref_*`: the reference's loss and gradients of each
    step, taken from the same tables."""
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses)]
    grad = [leaf_gap([(a - b) / lr for a, b in zip(t0, t1)], g)
            for t0, t1, g in zip(tables, tables[1:], ref_grads)]
    return {"loss_gap": float(np.median(loss)),
            "grad_gap": float(np.median(grad)),
            "steps": {"loss_gap": loss, "grad_gap": grad}}


def run(r: Run) -> None:
    import torch

    from julia_raytracer_tpu_torch.parallel.mesh import make_mesh, shard_train_step
    from julia_raytracer_tpu_torch.render.renderer import (
        Params, Renderer, image_size_for,
    )

    tr = r.traffic
    cuda = r.device == "cuda"
    if cuda:
        r.sync = torch.cuda.synchronize
    with r.span("scene_gen"):
        desc = build_scene(r.config)
        scene = to_program_scene(desc)
    params = Params(resolution=tr["resolution"], samples=1,
                    bounces=tr["bounces"], sampler="path", seed=r.seed)
    with r.span("scene_build"):
        renderer = Renderer(scene, params, device=r.device)
    width, height = image_size_for(renderer.camera, tr["resolution"])
    n = width * height
    with r.span("step_build"):
        step = shard_train_step(make_mesh(r.device), renderer.dscene,
                                renderer.config, renderer.options,
                                renderer.cam_arrays, width, height,
                                lr=tr["lr"])
    color0, emission0 = start_tables(desc, r.seed, tr["perturb"])
    target_np = target_image(r.seed, width, height)
    target = torch.as_tensor(target_np, device=r.device)
    pixel_ids = torch.arange(n, dtype=torch.int32, device=r.device)
    # the tables before the first step and after each checked step; the
    # current tables last
    tables = [(torch.as_tensor(color0, device=r.device),
               torch.as_tensor(emission0, device=r.device))]
    current = [tables[0]]
    losses = []

    def one_step():
        loss, color, emission = step(*current[0], pixel_ids, target,
                                     tr["samples"],
                                     seed=step_seed(r.seed, len(losses)))
        losses.append(loss.item())
        current[0] = (color, emission)
        if len(tables) <= tr["check_steps"]:
            tables.append(current[0])

    with r.span("warm"):
        for _ in range(tr["warm_steps"]):
            one_step()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    steps, t1 = 0, t0
    while t1 - t0 < r.seconds:
        one_step()
        steps += 1
        t1 = time.perf_counter()
    window_s = t1 - t0
    r.end_to_end = {"train_step_ms": window_s * 1e3 / steps,
                    "setup_s": setup_s}
    if r.trace:
        profile_units(r, one_step, tr["trace_steps"], lambda: {})
    if cuda:
        r.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    # ---- output check: the program's readings, then the reference
    k = tr["check_steps"]
    prog = [tuple(t.double().cpu().numpy() for t in tb) for tb in tables[:k + 1]]
    prog_losses = losses[:k]
    del renderer, step, tables, current
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the first step from the start tables the benchmark made
    starts = [(color0, emission0)] + prog[1:k]
    ref_losses, ref_grads = reference(desc, tr, target, starts, r.seed,
                                      width, height, r.device)
    gaps = judge(prog_losses, prog, ref_losses, ref_grads, tr["lr"])
    print("steps: " + ", ".join(f"{name} {v!r}" for name, v
                                in gaps.pop("steps").items()),
          file=sys.stderr)
    r.attempted = k
    for name, value in gaps.items():
        r.check(name, value)
    r.failed = 0 if all(c[3] for c in r.checks) else k


def reference(desc, tr, target, starts: list, seed, width, height,
              device):
    """The float32 reference's loss and gradients (colour, emission) of
    each checked step, step j taken from the tables `starts[j]` with the
    step's seed, as float64 numpy."""
    import torch

    from benchmark.reference import tracer

    scene = tracer.Scene(desc, device, torch.float32)
    losses, grads = [], []
    for j, (color, emission) in enumerate(starts):
        loss, grad, _ = tracer.train_steps(
            scene, desc["camera"], width, height, target,
            torch.as_tensor(color, dtype=torch.float32, device=device),
            torch.as_tensor(emission, dtype=torch.float32, device=device),
            [step_seed(seed, j)], tr["lr"], tr["bounces"])
        losses += loss
        grads.append([g.double().cpu().numpy() for g in grad[0]])
    return losses, grads


def trajectory(desc, tr, target, color0, emission0, seed, width, height,
               device, dtype=None, half: bool = False):
    """The reference put in the program's place (the control and the
    planted faults): its losses of the checked steps and its tables before
    each step and after the last, as float64 numpy. `half`: the planted
    fault that leaves out the second half of the pixels."""
    import torch

    from benchmark.reference import tracer

    scene = tracer.Scene(desc, device, dtype or torch.float32)
    dt = scene.dtype
    start = (torch.as_tensor(color0, device=device).to(dt),
             torch.as_tensor(emission0, device=device).to(dt))
    losses, _, tables = tracer.train_steps(
        scene, desc["camera"], width, height, target.to(dt), *start,
        [step_seed(seed, j) for j in range(tr["check_steps"])], tr["lr"],
        tr["bounces"], n_pixels=width * height // 2 if half else None)
    return losses, [tuple(t.double().cpu().numpy() for t in tb)
                    for tb in [start] + tables]
