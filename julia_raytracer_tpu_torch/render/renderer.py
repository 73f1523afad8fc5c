"""Progressive renderer: camera sampling, per-sample accumulation, AOVs,
checkpoint/resume and adaptive sampling (port of
julia_raytracer_tpu/render/renderer.py).

One sample of a pixel chunk is one `trace_wavefront` call on the
renderer's device; the running mean is updated in place in the
accumulation buffers. The per-(pixel, sample) counter-based RNG makes
renders deterministic and independent of chunking, and bit-compatible
with the JAX package's streams.

Checkpoint/resume: TraceState.save/load write and read the JAX package's
.npz keys and dtypes, so a checkpoint of either package resumes in the
other. Adaptive sampling (`Params.adaptive`) draws each batch's pixel
lanes from a luminance-variance distribution after a uniform warm-up and
merges them per pixel in a fixed order (a segmented scan over the lanes
sorted by pixel), so an adaptive render gives the same bits on every run
on one device.

Not ported: the multi-sample dispatch knobs of the JAX renderer (which
change only how samples are batched into device programs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.camera import CameraArrays, sample_camera
from julia_raytracer_tpu_torch.render.body_graphs import BodyGraphs
from julia_raytracer_tpu_torch.render.integrator import (
    REGROUP_MIN_PRIMS, TraceOptions, build_intersector, trace_wavefront,
)
from julia_raytracer_tpu_torch.render.lights import auto_light_pdf_steps
from julia_raytracer_tpu_torch.render.scene_device import (
    build_device_scene, resolve_device,
)
from julia_raytracer_tpu_torch.scene.loader import find_camera
from julia_raytracer_tpu_torch.utils import rng as rng_mod
from julia_raytracer_tpu_torch.utils.diskcache import scene_cache_key
from julia_raytracer_tpu_torch.utils.roofline import count_cost
from julia_raytracer_tpu_torch.utils.timing import span

MAX_CHUNK = 1 << 20  # rays per trace_wavefront call
# scenes of at least this many quads sort their wavefronts by default
SORT_MIN_PRIMS = 50_000


@dataclass
class Params:
    """The reference CLI's flags and the JAX package's extras (its Params),
    then the port's own knobs."""

    scene: str = "scene.json"
    output: str = "out.png"
    camera: str = ""
    addsky: bool = False  # scene/augment.py add_sky, applied by the CLI
    envname: str = ""  # scene/augment.py add_environment, applied by the CLI
    resolution: int = 1280
    samples: int = 512
    bounces: int = 8
    denoise: bool = False  # render/denoise.py, applied by the CLI
    noparallel: bool = False  # load the scene's files on one thread
    highqualitybvh: bool = False
    envhidden: bool = False
    tentfilter: bool = False
    sampler: str = "path"
    clamp: float = 10.0
    nocaustics: bool = False
    batch: int = 1
    bvhstacksize: int = 128  # kept for CLI parity; nothing reads it
    seed: int = 0
    # march budget of the light pdf of scenes with more than
    # lights.EXACT_ELEMS emissive elements; -1 = lights.auto_light_pdf_steps
    light_pdf_extra_steps: int = -1
    # adaptive sampling: after `adaptive_warmup` uniform samples, each
    # batch draws its pixel lanes from the luminance-variance
    # distribution; per-pixel counts keep every pixel an exact mean of
    # its own samples (allocation, not weighting)
    adaptive: bool = False
    adaptive_warmup: int = 4
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
    denoised: torch.Tensor | None = None
    # adaptive mode (None when uniform): per-pixel sample counts and
    # luminance M2 (Welford) driving the allocation distribution
    counts: torch.Tensor | None = None  # i32 [P]
    m2: torch.Tensor | None = None  # f32 [P]

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def save(self, path: str) -> None:
        """The JAX package's checkpoint: the same .npz keys and dtypes."""
        extra = {}
        if self.counts is not None:
            extra = {"counts": self.counts.cpu().numpy(),
                     "m2": self.m2.cpu().numpy()}
        np.savez(
            path,
            width=self.width,
            height=self.height,
            samples=self.samples,
            image=self.image.cpu().numpy(),
            albedo=self.albedo.cpu().numpy(),
            normal=self.normal.cpu().numpy(),
            hits=self.hits.cpu().numpy(),
            **extra,
        )

    @staticmethod
    def load(path: str, device=None) -> "TraceState":
        """A checkpoint of either package, on `device` (None: the card)."""
        device = resolve_device(device)
        with np.load(path) as z:
            def put(key):
                return torch.from_numpy(z[key]).to(device) if key in z else None

            return TraceState(
                width=int(z["width"]),
                height=int(z["height"]),
                samples=int(z["samples"]),
                image=put("image"),
                albedo=put("albedo"),
                normal=put("normal"),
                hits=put("hits"),
                counts=put("counts"),
                m2=put("m2"),
            )


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
        counts=(torch.zeros(p, dtype=torch.int32, device=device)
                if params.adaptive else None),
        m2=torch.zeros(p, device=device) if params.adaptive else None,
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


_LUM = (0.2126, 0.7152, 0.0722)  # luminance of linear rgb


def _luminance(rgb):
    return rgb[..., 0] * _LUM[0] + rgb[..., 1] * _LUM[1] + rgb[..., 2] * _LUM[2]


def inclusive_scan(x, same=None):
    """Inclusive prefix sums of x [L] or [L, C] along the lanes, by
    doubling: in step s each lane adds the lane s before it (where
    `same` [L - s] says so, when given), s = 1, 2, 4, ... A fixed order
    of float additions, so the same bits on every run on one device; the
    library scans (torch.cumsum on the card among them) do not promise
    that. `same(s)`: a segmented scan, True where lane i and lane i - s
    lie in one segment (a prefix of the lanes: sorted keys)."""
    step, n_lanes = 1, x.shape[0]
    while step < n_lanes:
        prev = x[:-step]
        if same is not None:
            mask = same(step)
            prev = torch.where(mask if x.dim() == 1 else mask[:, None], prev, 0.0)
        x = torch.cat([x[:step], x[step:] + prev])
        step *= 2
    return x


def adaptive_cdf(counts, m2):
    """The allocation distribution's float32 CDF over the pixels: each
    pixel weighs its luminance deviation sqrt(m2 / (count - 1)) plus a
    floor of 0.05 times the mean weight (+ 1e-12), so every pixel keeps
    being sampled and stays a consistent estimator."""
    var = m2 / torch.clamp(counts.to(torch.float32) - 1.0, min=1.0)
    wts = torch.sqrt(torch.clamp(var, min=0.0))
    wts = wts + 0.05 * wts.mean() + 1e-12
    cdf = inclusive_scan(wts)
    return cdf / cdf[-1]


def adaptive_draw(cdf, chunk: int, batch_id: int, seed: int):
    """Draw `chunk` pixel lanes by inverse CDF on the counter-based stream
    seed_state(lane, batch_id, seed + 0x5EED). Returns (ids i32 [chunk],
    rank i32 [chunk], order i64 [chunk]): each lane's pixel, its
    occurrence rank among the lanes that drew the same pixel (in lane
    order, so duplicates get distinct sample ids), and the stable sort of
    the lanes by pixel."""
    n = cdf.shape[0]
    lane = torch.arange(chunk, dtype=torch.int32, device=cdf.device)
    u, _ = rng_mod.rand2f(rng_mod.seed_state(lane, batch_id, seed + 0x5EED))
    ids = torch.searchsorted(cdf, u[:, 0].contiguous())
    ids = ids.clamp(0, n - 1).to(torch.int32)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    pos = torch.arange(chunk, device=cdf.device)
    is_start = torch.ones_like(sid, dtype=torch.bool)
    is_start[1:] = sid[1:] != sid[:-1]
    start_pos = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty(chunk, dtype=torch.int32, device=cdf.device)
    rank[order] = (pos - start_pos).to(torch.int32)
    return ids, rank, order


def pixel_sums(sid, vals, n_pixels: int):
    """Per-pixel sums of the lanes' vals [L, C], the lanes sorted by their
    pixel sid [L] (non-decreasing): [n_pixels, C], zero where no lane
    went. A segmented inclusive_scan leaves each pixel's sum on its last
    lane, in a fixed order of additions (the same bits on every run,
    unlike an atomic scatter-add); the sums are then written to distinct
    pixels."""
    x = inclusive_scan(vals, lambda step: sid[step:] == sid[:-step])
    last = torch.ones_like(sid, dtype=torch.bool)
    last[:-1] = sid[1:] != sid[:-1]
    slot = torch.where(last, sid.to(torch.int64), n_pixels)  # n: a spare row
    out = torch.zeros((n_pixels + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out[slot] = x
    return out[:n_pixels]


def light_pdf_steps(params: Params, config) -> int:
    """The light pdf's march budget: `params.light_pdf_extra_steps`, or
    when it is -1 lights.auto_light_pdf_steps over the scene's light count
    and whether a transparent, refractive, subsurface or volumetric
    material (types 3-6) puts surfaces along light paths."""
    if params.light_pdf_extra_steps >= 0:
        return params.light_pdf_extra_steps
    transmissive = bool(set(config.present_types) & {3, 4, 5, 6})
    return auto_light_pdf_steps(config.light_counts.total, transmissive)


class Renderer:
    """Owns the device scene, the intersector, the loop bodies' CUDA
    graphs (render/body_graphs.py) and the per-sample step.
    `device=None` means the card; pass device="cpu" for the CPU."""

    def __init__(self, scene_data, params: Params, device=None):
        self.params = params
        self.device = resolve_device(device)
        # --addsky/--envname change scene_data after the load
        # (scene/augment.py), so they are part of the content key, or a
        # cached light table would carry the wrong environments; a scene
        # made in code has no file, so its key is "" and nothing is cached
        aug = f"sky{int(params.addsky)}:env{params.envname or '-'}"
        cache_key = scene_cache_key(
            params.scene, "sah" if params.highqualitybvh else "mid", aug)
        self.dscene, self.config = build_device_scene(
            scene_data, highquality_bvh=params.highqualitybvh,
            device=self.device, hybrid_budget=params.hybrid_budget,
            cache_key=cache_key,
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
            light_pdf_extra_steps=light_pdf_steps(params, self.config),
            sort_rays=sort_rays,
        )
        self.intersect = build_intersector(
            self.dscene, self.config, regroup=params.regroup,
            regroup_min_prims=params.regroup_min_prims)
        # the loop bodies' CUDA graphs, by lane width
        self.body_graphs = BodyGraphs()

    def _trace_lanes(self, state: TraceState, ids, sample_ids):
        """Trace one camera path a lane, pixel ids (clamped to the image),
        sample sample_ids (an int or a tensor): what `_compose` takes."""
        params, width, height = self.params, state.width, state.height
        with span("camera"):
            rng = rng_mod.seed_state(ids, sample_ids, params.seed)
            puv, rng = rng_mod.rand2f(rng)
            luv, rng = rng_mod.rand2f(rng)
            ij = torch.stack([ids % width, ids // width], dim=-1)
            ro, rd = sample_camera(
                self.cam_arrays, ij, (width, height), puv, luv,
                params.tentfilter)
        radiance, hit, albedo_s, normal_s, _ = trace_wavefront(
            self.dscene, self.config, self.options, ro, rd, rng,
            intersector=self.intersect, graphs=self.body_graphs,
        )
        return radiance, hit, albedo_s, normal_s, rd

    def _compose(self, radiance, hit, albedo_s, normal_s, rd):
        """The traced lanes' image, albedo and normal contributions, and
        whether each hit or saw the env."""
        img_new, alb_new, nrm_new, env_case = _scrub_compose(
            radiance, hit, albedo_s, normal_s, rd, self.params.clamp,
            self.options.envhidden, self.config.n_envs > 0,
        )
        return img_new, alb_new, nrm_new, hit | env_case

    def _sample(self, state: TraceState, chunk: int, pixel0: int, sample: int):
        """Trace one sample of pixels [pixel0, pixel0 + chunk) and fold it
        into the running mean."""
        n_pixels = state.n_pixels
        lane = torch.arange(chunk, dtype=torch.int32, device=self.device)
        pixel = pixel0 + lane
        valid = pixel < n_pixels
        traced = self._trace_lanes(state, pixel.clamp(0, n_pixels - 1), sample)
        with span("fold"):
            img_new, alb_new, nrm_new, seen = self._compose(*traced)
            # running-mean weight 1 / (s + 1), rounded in float32
            w = float(np.float32(1.0) / (np.float32(sample) + np.float32(1.0)))
            w = torch.where(valid, w, 0.0)[..., None]
            sl = slice(pixel0, pixel0 + chunk)
            for buf, new in ((state.image, img_new), (state.albedo, alb_new),
                             (state.normal, nrm_new)):
                old = buf[sl]
                buf[sl] = old + (new - old) * w
            state.hits[sl] += (valid & seen).to(torch.int32)

    def _adaptive_sample(self, state: TraceState, chunk: int, pixel0: int,
                         batch_id: int, n_live: int, uniform: bool):
        """One chunk of an adaptive batch. Warm-up (`uniform`): the lanes
        cover pixels [pixel0, pixel0 + chunk) as in _sample. After it: the
        lanes' pixels are drawn (adaptive_draw), the tail chunk's lanes
        from n_live on masked, so each round adds exactly n_pixels
        samples. Each lane continues its pixel's sample sequence (sample
        id = count + rank), and the per-pixel batch sums (pixel_sums) are
        merged into the running means, counts and luminance M2 (Chan's
        parallel Welford), so every pixel stays an exact mean of its own
        samples."""
        n = state.n_pixels
        lane = torch.arange(chunk, dtype=torch.int32, device=self.device)
        if uniform:
            pixel = pixel0 + lane
            valid = pixel < n
            ids = pixel.clamp(0, n - 1)  # non-decreasing: already sorted
            sample_ids, order = state.counts[ids], None
        else:
            ids, rank, order = adaptive_draw(
                adaptive_cdf(state.counts, state.m2), chunk, batch_id,
                self.params.seed)
            valid = lane < n_live
            sample_ids = state.counts[ids] + rank
        traced = self._trace_lanes(state, ids, sample_ids)
        with span("fold"):
            img_new, alb_new, nrm_new, seen = self._compose(*traced)
            vf = valid.to(torch.float32)
            img_new = img_new * vf[..., None]
            alb_new = alb_new * vf[..., None]
            nrm_new = nrm_new * vf[..., None]
            lum = _luminance(img_new[:, :3]) * vf
            vals = torch.cat([vf[:, None], img_new, alb_new, nrm_new, lum[:, None],
                              (lum * lum)[:, None]], dim=1)
            sid = ids if order is None else ids[order]
            sums = pixel_sums(sid, vals if order is None else vals[order], n)
            k, s_img, s_alb, s_nrm = sums[:, 0], sums[:, 1:5], sums[:, 5:8], sums[:, 8:11]
            s_l, s_l2 = sums[:, 11], sums[:, 12]

            n_old = state.counts.to(torch.float32)
            n_new = torch.clamp(n_old + k, min=1.0)
            mean_old = _luminance(state.image[:, :3])
            kc, nc = k[:, None], n_new[:, None]
            state.image = state.image + (s_img - kc * state.image) / nc
            state.albedo = state.albedo + (s_alb - kc * state.albedo) / nc
            state.normal = state.normal + (s_nrm - kc * state.normal) / nc
            mb = s_l / torch.clamp(k, min=1.0)
            m2b = torch.clamp(s_l2 - k * mb * mb, min=0.0)
            delta = mb - mean_old
            state.m2 = state.m2 + m2b + delta * delta * n_old * k / n_new
            state.counts = state.counts + k.to(torch.int32)
            # integer adds commute: the scatter's order cannot change the sum
            state.hits = state.hits.index_add(0, ids, (valid & seen).to(torch.int32))

    def trace_samples(self, state: TraceState) -> TraceState:
        """Advance one batch of samples, in a `frame` span (a unit of
        utils/timing.py)."""
        params = self.params
        with span("frame"):
            if state.samples >= params.samples:
                return state
            return self._advance(
                state, min(state.samples + params.batch, params.samples))

    def sample_kernel_cost(self, state: TraceState) -> dict:
        """The cost of ONE sample (all chunks) of `state`'s next sample,
        counted by utils/roofline.count_cost on a copy of the state (the
        caller's comes back unchanged): the JAX keys "flops",
        "bytes_accessed" and "chunks_per_sample" (ceil(n_pixels / chunk),
        chunk = min(MAX_CHUNK, n_pixels) as the sample loop takes it), the
        hand-written kernels' share ("kernel_flops", "kernel_bytes": their
        models, utils/kernel_flops.py) and the eager program's ATen ops'
        ("other_flops", "other_bytes"), and the tables by op and by kernel
        name ("ops", "kernels": {name: [calls, flops, bytes]}). The other
        bytes are the eager program's own traffic (every op reads its
        inputs from memory and writes its outputs back), not the work a
        sample needs: a fused shading would lower them."""
        def copy(x):
            return None if x is None else x.clone()

        work = TraceState(
            width=state.width, height=state.height, samples=state.samples,
            image=copy(state.image), albedo=copy(state.albedo),
            normal=copy(state.normal), hits=copy(state.hits),
            denoised=copy(state.denoised), counts=copy(state.counts),
            m2=copy(state.m2))
        _, counter = count_cost(self._advance, work, work.samples + 1)
        tot = counter.totals()
        return dict(
            flops=tot["other_flops"] + tot["kernel_flops"],
            bytes_accessed=tot["other_bytes"] + tot["kernel_bytes"],
            chunks_per_sample=-(-state.n_pixels // min(MAX_CHUNK,
                                                       state.n_pixels)),
            **tot, ops=counter.ops, kernels=counter.kernels)

    def _advance(self, state: TraceState, target: int) -> TraceState:
        """Trace samples state.samples .. target - 1 into state."""
        params = self.params
        n = state.n_pixels
        chunk = min(MAX_CHUNK, n)
        if params.adaptive:
            return self._trace_samples_adaptive(state, target, chunk)
        if state.counts is not None:
            raise ValueError(
                "this checkpoint was written by an --adaptive render "
                "(per-pixel counts are heterogeneous); resume with "
                "--adaptive or the uniform running-mean weights would "
                "corrupt converged pixels"
            )
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
                with span("chunk"):
                    self._sample(state, chunk, pixel0, sample)
        state.samples = target
        return state

    def _trace_samples_adaptive(self, state: TraceState, target: int,
                                chunk: int) -> TraceState:
        """Adaptive batch loop: warm-up samples place lanes uniformly while
        building the variance tracker, later ones draw them from it. The
        buffers stay unpadded: the merge is by pixel, not by slice."""
        if state.counts is None or state.m2 is None:
            raise ValueError(
                "adaptive render needs a state made with "
                "Params(adaptive=True) (or a checkpoint saved from one)"
            )
        n = state.n_pixels
        nchunks = -(-n // chunk)
        for sample in range(state.samples, target):
            uniform = sample < self.params.adaptive_warmup
            for ci in range(nchunks):
                pixel0 = ci * chunk
                with span("chunk"):
                    self._adaptive_sample(state, chunk, pixel0,
                                          sample * nchunks + ci,
                                          min(chunk, n - pixel0), uniform)
        state.samples = target
        return state

    def get_image(self, state: TraceState) -> np.ndarray:
        """Final [H, W, 4] float image; the denoised buffer when set."""
        src = state.denoised if state.denoised is not None else state.image
        img = src[: state.n_pixels].cpu().numpy()
        return img.reshape(state.height, state.width, 4)

    def get_aovs(self, state: TraceState) -> dict[str, np.ndarray]:
        h, w = state.height, state.width
        return {
            "albedo": state.albedo[: h * w].cpu().numpy().reshape(h, w, 3),
            "normal": state.normal[: h * w].cpu().numpy().reshape(h, w, 3),
            "hits": state.hits[: h * w].cpu().numpy().reshape(h, w),
        }
