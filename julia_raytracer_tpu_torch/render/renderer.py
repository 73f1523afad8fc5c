"""Progressive renderer: camera sampling, per-sample accumulation, AOVs
(port of the uniform-sampling path of julia_raytracer_tpu/render/renderer.py).

One sample of a pixel chunk is one `trace_wavefront` call on the
renderer's device; the running mean is updated in place in the
accumulation buffers. The per-(pixel, sample) counter-based RNG makes
renders deterministic and independent of chunking, and bit-compatible
with the JAX package's streams.

Not ported yet (see ROADMAP.md): adaptive sampling, checkpoint/resume,
the denoiser, and the multi-sample dispatch knobs of the JAX renderer
(which change only how samples are batched into device programs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.camera import CameraArrays, sample_camera
from julia_raytracer_tpu_torch.render.integrator import (
    REGROUP_MIN_PRIMS, TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.scene_device import (
    build_device_scene, resolve_device,
)
from julia_raytracer_tpu_torch.scene.loader import find_camera
from julia_raytracer_tpu_torch.utils import rng as rng_mod

MAX_CHUNK = 1 << 20  # rays per trace_wavefront call
# scenes of at least this many quads sort their wavefronts by default
SORT_MIN_PRIMS = 50_000


@dataclass
class Params:
    """The render settings the renderer reads (the JAX package's Params
    minus its CLI-only and TPU-dispatch fields)."""

    camera: str = ""
    resolution: int = 1280
    samples: int = 512
    bounces: int = 8
    highqualitybvh: bool = False
    envhidden: bool = False
    tentfilter: bool = False
    sampler: str = "path"
    clamp: float = 10.0
    nocaustics: bool = False
    batch: int = 1
    seed: int = 0
    adaptive: bool = False  # not ported yet: True raises NotImplementedError
    # wavefront sort (was JRT_SORT): None sorts scenes of >= 50,000 quads
    sort_rays: bool | None = None
    # heavy-scene intersector (were JRT_REGROUP and JRT_REGROUP_MIN): see
    # integrator.build_intersector
    regroup: str = "auto"
    regroup_min_prims: int = REGROUP_MIN_PRIMS
    # instanced scenes (was JRT_HYBRID_BUDGET): the most world prims the
    # hybrid build flattens; None = scene_device.auto_hybrid_budget
    hybrid_budget: int | None = None


@dataclass
class TraceState:
    """Accumulation buffers, flat pixel-major."""

    width: int
    height: int
    samples: int
    image: torch.Tensor  # f32 [P, 4]
    albedo: torch.Tensor  # f32 [P, 3]
    normal: torch.Tensor  # f32 [P, 3]
    hits: torch.Tensor  # i32 [P]

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def image_size_for(camera, resolution: int) -> tuple[int, int]:
    """Resolution lands on the long axis per camera aspect."""
    if camera.aspect >= 1.0:
        return resolution, int(round(resolution / camera.aspect))
    return int(round(resolution * camera.aspect)), resolution


def make_trace_state(scene_data, params: Params, device=None) -> TraceState:
    """Zeroed accumulation buffers on `device` (None: the card)."""
    device = resolve_device(device)
    cam_id = max(find_camera(scene_data, params.camera), 0)
    width, height = image_size_for(scene_data.cameras[cam_id], params.resolution)
    p = width * height
    return TraceState(
        width=width,
        height=height,
        samples=0,
        image=torch.zeros((p, 4), device=device),
        albedo=torch.zeros((p, 3), device=device),
        normal=torch.zeros((p, 3), device=device),
        hits=torch.zeros(p, dtype=torch.int32, device=device),
    )


def camera_arrays(camera, device=None) -> CameraArrays:
    """The camera's constants as tensors on `device` (None: the card)."""
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return CameraArrays(
        frame=torch.as_tensor(np.asarray(camera.frame, np.float32), device=device),
        lens=f32(camera.lens),
        film=f32(camera.film),
        aspect=f32(camera.aspect),
        focus=f32(camera.focus),
        aperture=f32(camera.aperture),
        orthographic=bool(camera.orthographic),
    )


def _scrub_compose(radiance, hit, albedo_s, normal_s, rd, clamp, envhidden,
                   has_envs):
    """Per-sample post-processing: NaN scrub + radiance rescale clamp, and
    the image/albedo/normal contributions incl. the miss-vs-env
    bookkeeping."""
    finite = torch.isfinite(radiance).all(dim=-1)
    radiance = torch.where(finite[..., None], radiance, 0.0)
    peak = radiance.amax(dim=-1)
    scale = torch.where(peak > clamp, clamp / torch.clamp(peak, min=1e-30), 1.0)
    radiance = radiance * scale[..., None]
    env_case = ~hit if (has_envs and not envhidden) else torch.zeros_like(hit)
    img_new = torch.where(
        (hit | env_case)[..., None],
        torch.cat([radiance, torch.ones_like(radiance[:, :1])], dim=-1),
        0.0,
    )
    alb_new = torch.where(
        hit[..., None], albedo_s, torch.where(env_case[..., None], 1.0, 0.0)
    )
    nrm_new = torch.where(hit[..., None], normal_s, -rd)
    return img_new, alb_new, nrm_new, env_case


class Renderer:
    """Owns the device scene, the intersector and the per-sample step.
    `device=None` means the card; pass device="cpu" for the CPU."""

    def __init__(self, scene_data, params: Params, device=None):
        if params.adaptive:
            raise NotImplementedError(
                "adaptive sampling is not ported yet (ROADMAP.md queue 1, item 9)"
            )
        self.params = params
        self.device = resolve_device(device)
        self.dscene, self.config = build_device_scene(
            scene_data, highquality_bvh=params.highqualitybvh,
            device=self.device, hybrid_budget=params.hybrid_budget,
        )
        cam_id = max(find_camera(scene_data, params.camera), 0)
        self.camera = scene_data.cameras[cam_id]
        self.cam_arrays = camera_arrays(self.camera, self.device)
        # the sort pays once per-block live sets shrink (JAX
        # renderer.py:256-265); an instanced scene's n_prims is its padded
        # shape-space count
        sort_rays = params.sort_rays
        if sort_rays is None:
            sort_rays = self.config.n_prims >= SORT_MIN_PRIMS
        self.options = TraceOptions(
            sampler=params.sampler,
            bounces=params.bounces,
            envhidden=params.envhidden,
            nocaustics=params.nocaustics,
            sort_rays=sort_rays,
        )
        self.intersect = build_intersector(
            self.dscene, self.config, regroup=params.regroup,
            regroup_min_prims=params.regroup_min_prims)

    def _sample(self, state: TraceState, chunk: int, pixel0: int, sample: int):
        """Trace one sample of pixels [pixel0, pixel0 + chunk) and fold it
        into the running mean."""
        params, dev = self.params, self.device
        width, height, n_pixels = state.width, state.height, state.n_pixels
        lane = torch.arange(chunk, dtype=torch.int32, device=dev)
        pixel = pixel0 + lane
        valid = pixel < n_pixels
        pix = pixel.clamp(0, n_pixels - 1)
        rng = rng_mod.seed_state(pix, sample, params.seed)
        puv, rng = rng_mod.rand2f(rng)
        luv, rng = rng_mod.rand2f(rng)
        ij = torch.stack([pix % width, pix // width], dim=-1)
        ro, rd = sample_camera(
            self.cam_arrays, ij, (width, height), puv, luv, params.tentfilter
        )
        radiance, hit, albedo_s, normal_s, _ = trace_wavefront(
            self.dscene, self.config, self.options, ro, rd, rng,
            intersect=self.intersect,
            intersect_primary=getattr(self.intersect, "primary", None),
        )
        img_new, alb_new, nrm_new, env_case = _scrub_compose(
            radiance, hit, albedo_s, normal_s, rd, params.clamp,
            self.options.envhidden, self.config.n_envs > 0,
        )
        # running-mean weight 1 / (s + 1), rounded in float32
        w = float(np.float32(1.0) / (np.float32(sample) + np.float32(1.0)))
        w = torch.where(valid, w, 0.0)[..., None]
        sl = slice(pixel0, pixel0 + chunk)
        for buf, new in ((state.image, img_new), (state.albedo, alb_new),
                         (state.normal, nrm_new)):
            old = buf[sl]
            buf[sl] = old + (new - old) * w
        state.hits[sl] += (valid & (hit | env_case)).to(torch.int32)

    def trace_samples(self, state: TraceState) -> TraceState:
        """Advance one batch of samples."""
        params = self.params
        if state.samples >= params.samples:
            return state
        target = min(state.samples + params.batch, params.samples)
        n = state.n_pixels
        chunk = min(MAX_CHUNK, n)
        # pad the buffers to a chunk multiple; tail lanes carry weight 0
        # and get_image/get_aovs slice back to n_pixels
        n_pad = -(-n // chunk) * chunk
        if state.image.shape[0] < n_pad:
            pad = n_pad - state.image.shape[0]
            state.image = torch.nn.functional.pad(state.image, (0, 0, 0, pad))
            state.albedo = torch.nn.functional.pad(state.albedo, (0, 0, 0, pad))
            state.normal = torch.nn.functional.pad(state.normal, (0, 0, 0, pad))
            state.hits = torch.nn.functional.pad(state.hits, (0, pad))
        for sample in range(state.samples, target):
            for pixel0 in range(0, n, chunk):
                self._sample(state, chunk, pixel0, sample)
        state.samples = target
        return state

    def get_image(self, state: TraceState) -> np.ndarray:
        """Final [H, W, 4] float image."""
        img = state.image[: state.n_pixels].cpu().numpy()
        return img.reshape(state.height, state.width, 4)

    def get_aovs(self, state: TraceState) -> dict[str, np.ndarray]:
        h, w = state.height, state.width
        return {
            "albedo": state.albedo[: h * w].cpu().numpy().reshape(h, w, 3),
            "normal": state.normal[: h * w].cpu().numpy().reshape(h, w, 3),
            "hits": state.hits[: h * w].cpu().numpy().reshape(h, w),
        }
