"""Differentiable rendering: the radiance function and the parameter loss
(port of julia_raytracer_tpu/render/diff.py).

Estimator: detached sampling. The fixed-trip loop of
render/integrator.py detaches the sampled directions, the pdfs and the
Russian roulette probability, so gradients flow through eval_bsdfcos,
eval_emission, eval_environment and texture filtering to material, light,
environment and camera parameters, and through ops/diff_hit.py's
re-tested hits to the geometry and the camera rays, while the discrete
decisions (lobe and light picks, roulette, opacity) stay fixed. With the
counter-based RNG the whole pipeline is a deterministic function of its
parameters, so central finite differences with the same seed converge to
the same gradient.

Parameters are swapped with NamedTuple._replace on DeviceScene and
CameraArrays, as in the JAX package. Everything runs on the device the
scene lives on: the intersect kernels on the card, their plain versions
on the CPU. The intersector's tables come from the scene's host copies
(`build_intersector`), so gradients with respect to `prim_verts` are
taken at the built geometry.
"""

from __future__ import annotations

import torch

from julia_raytracer_tpu_torch.ops.camera import sample_camera
from julia_raytracer_tpu_torch.render.integrator import (
    TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.timing import span


def diff_options(options: TraceOptions, config=None,
                 opacity_budget: int | None = None) -> TraceOptions:
    """Switch an options struct to the fixed-trip (differentiable) loop:
    bounces + 1 bodies, plus `opacity_budget` for stochastic-opacity
    skips (default 32 when the scene has opacity, else 0, where the
    fixed-trip loop equals the while loop exactly; lanes that roll more
    skips than the budget are truncated)."""
    if opacity_budget is None:
        has_op = (bool(getattr(config, "has_opacity", True))
                  if config is not None else True)
        opacity_budget = 32 if has_op else 0
    return options._replace(
        fixed_iterations=options.bounces + 1 + opacity_budget)


def render_radiance(dscene, config, options: TraceOptions, cam, width: int,
                    height: int, pixel_ids, sample_id, seed: int = 0,
                    tentfilter: bool = False, intersector=None):
    """One radiance sample [N, 3] per pixel lane (pixel_ids i32 [N]),
    differentiable with respect to every float tensor of `dscene` and
    `cam`; non-finite lanes are zeroed. `intersector`: a prebuilt
    Intersector (default build_intersector's on the scene's device)."""
    with span("camera"):
        rng = rng_mod.seed_state(pixel_ids, sample_id, seed)
        puv, rng = rng_mod.rand2f(rng)
        luv, rng = rng_mod.rand2f(rng)
        ij = torch.stack([pixel_ids % width, pixel_ids // width], dim=-1)
        ro, rd = sample_camera(cam, ij, (width, height), puv, luv, tentfilter)
    radiance = trace_wavefront(dscene, config, options, ro, rd, rng,
                               intersector=intersector)[0]
    finite = torch.isfinite(radiance).all(dim=-1)
    return torch.where(finite[..., None], radiance, 0.0)


def render_radiance_mean(dscene, config, options, cam, width, height,
                         pixel_ids, n_samples: int, seed: int = 0,
                         tentfilter: bool = False, intersector=None):
    """Mean of `n_samples` radiance samples (sample ids 0 .. n - 1)."""
    total = torch.zeros(pixel_ids.shape + (3,), device=pixel_ids.device)
    for sample_id in range(n_samples):
        total = total + render_radiance(
            dscene, config, options, cam, width, height, pixel_ids,
            sample_id, seed, tentfilter, intersector)
    return total / n_samples


def make_param_loss(dscene, config, options, cam, width, height):
    """loss(mat_color, mat_emission, pixel_ids, target, n_samples,
    seed=0): the mean squared pixel error of the fixed-trip render as a
    function of the material color (albedo) and emission tables. The
    intersector is built once, on the scene's device."""
    d_opts = diff_options(options, config)
    intersect = build_intersector(dscene, config)

    def loss(mat_color, mat_emission, pixel_ids, target, n_samples, seed=0):
        mats = dscene.materials._replace(color=mat_color, emission=mat_emission)
        img = render_radiance_mean(
            dscene._replace(materials=mats), config, d_opts, cam, width,
            height, pixel_ids, n_samples, seed, intersector=intersect)
        return torch.mean((img - target) ** 2)

    return loss
