"""AOV-guided denoiser: edge-avoiding à-trous wavelet filtering (port of
julia_raytracer_tpu/render/denoise.py).

Dammertz et al. 2010, "Edge-Avoiding À-Trous Wavelet Transform for Fast
Global Illumination Filtering": N passes of a 5x5 B3-spline kernel with
tap spacing 1, 2, 4, ..., each tap reweighted by edge-stopping functions
on the guide AOVs (shading normal, albedo) and on luminance normalised by
a local 3x3 variance estimate. Illumination is demodulated by albedo
before filtering and remodulated after, so texture detail never blurs.

Plain PyTorch on either device, as the JAX version is plain jnp: each
pass gathers its 25 shifted taps from an edge-replicated copy of the
image into one [25, ...] stack and weighs them all at once. The taps are
summed with torch.sum, not one by one as the JAX version adds them, so
the two agree up to float reassociation. A pure function of the
accumulation buffers: the same inputs give the same bits on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 1-D B3-spline coefficients; the 5x5 kernel is their outer product.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
_LUMA = (0.2126, 0.7152, 0.0722)


def _luminance(c):
    """Luminance of channel-first rgb [..., 3, H, W] -> [..., H, W]."""
    return (c[..., 0, :, :] * _LUMA[0] + c[..., 1, :, :] * _LUMA[1]
            + c[..., 2, :, :] * _LUMA[2])


def _replicate(x, p: int):
    """[C, H, W] padded by p on each side of H and W, edges replicated."""
    return F.pad(x[None], (p, p, p, p), mode="replicate")[0]


def _box3(x):
    """3x3 edge-replicated box mean of [H, W]."""
    H, W = x.shape
    xp = _replicate(x[None], 1)[0]
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[dy:dy + H, dx:dx + W]
    return acc / 9.0


def _taps(xp, p: int, step: int, H: int, W: int):
    """The 25 tap views of the padded [C, H + 2p, W + 2p], stacked
    [25, C, H, W] in the (dy, dx) order of the JAX loop."""
    return torch.stack([
        xp[:, p + dy * step:p + dy * step + H, p + dx * step:p + dx * step + W]
        for dy in range(-2, 3) for dx in range(-2, 3)
    ])


def _atrous_pass(illum, albedo, normal, k, step: int,
                 sigma_l: float, sigma_n: float, sigma_a: float):
    """One à-trous pass at tap spacing `step`. illum, albedo, normal
    [3, H, W]; k [25, 1, 1] the kernel's weights."""
    H, W = illum.shape[1], illum.shape[2]
    p = 2 * step
    il_s = _taps(_replicate(illum, p), p, step, H, W)
    al_s = _taps(_replicate(albedo, p), p, step, H, W)
    nr_s = _taps(_replicate(normal, p), p, step, H, W)
    lum_c = _luminance(illum)
    # SVGF-style noise-adaptive luminance sigma: the luminance difference
    # over a local (3x3) deviation, so Monte-Carlo noise smooths while
    # converged regions keep their shading edges
    var_l = torch.clamp(_box3(lum_c * lum_c) - _box3(lum_c) ** 2, min=0.0)
    denom = sigma_l * torch.sqrt(var_l) + 1e-4
    # edge-stopping: luminance (shadow/caustic edges), normal (geometric
    # edges), albedo (material/texture edges)
    w_l = torch.exp(-torch.abs(lum_c - _luminance(il_s)) / denom)
    ndot = torch.clamp((normal * nr_s).sum(dim=1), min=0.0)
    w_n = ndot ** sigma_n
    da = ((albedo - al_s) ** 2).sum(dim=1)
    w_a = torch.exp(-da / sigma_a)
    w = k * w_l * w_n * w_a  # [25, H, W]
    acc = (w[:, None] * il_s).sum(dim=0)
    wsum = w.sum(dim=0)
    return acc / torch.clamp(wsum, min=1e-8)


def denoise_image(image, albedo, normal, width: int, height: int,
                  iterations: int = 5, sigma_l: float = 4.0,
                  sigma_n: float = 64.0, sigma_a: float = 0.02):
    """Denoise the accumulated radiance using the albedo/normal AOVs.

    image [P, 4] (rgb + alpha), albedo [P, 3], normal [P, 3]: the
    TraceState buffers, flat pixel-major, on one device. P may exceed
    height*width (trace_samples pads to a chunk multiple); the buffers
    are sliced to the real pixel count first. Returns a denoised
    [height*width, 4] on the same device; alpha passes through."""
    n = height * width
    image = image[:n]
    rgb = image[:, 0:3].T.reshape(3, height, width)
    alb = albedo[:n].T.reshape(3, height, width)
    nrm = normal[:n].T.reshape(3, height, width)
    # zero-normal pixels (pure env/miss) get a unit dummy so w_n compares
    # miss against miss as similar instead of 0**sigma everywhere
    nlen = torch.linalg.vector_norm(nrm, dim=0, keepdim=True)
    dummy = torch.zeros_like(nrm[:, :1, :1])
    dummy[2] = 1.0
    nrm = torch.where(nlen > 1e-6, nrm / torch.clamp(nlen, min=1e-6), dummy)
    # demodulate texture detail; miss pixels (albedo ~ 0) are left as-is
    demod = alb > 1e-3
    illum = torch.where(demod, rgb / torch.clamp(alb, min=1e-3), rgb)
    k = torch.tensor([a * b for a in _B3 for b in _B3],
                     dtype=illum.dtype).to(illum.device)[:, None, None]
    for i in range(iterations):
        illum = _atrous_pass(illum, alb, nrm, k, 1 << i, sigma_l, sigma_n,
                             sigma_a)
    out_rgb = torch.where(demod, illum * alb, illum).reshape(3, n).T
    return torch.cat([out_rgb, image[:, 3:4]], dim=1)
