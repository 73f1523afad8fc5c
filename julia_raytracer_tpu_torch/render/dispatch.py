"""Material-type BSDF dispatch as branchless masked selection, port of
julia_raytracer_tpu/render/dispatch.py.

Every lane carries its own material type, so each present lobe is
evaluated for the whole batch and the per-lane result selected by type
mask. `subsurface` aliases to the refractive lobes and `volumetric` is
delta-passthrough. `present` (SceneConfig.present_types) prunes lobes
for material types the scene does not contain; with one live lobe the
select disappears.

Rough (roughness != 0) lobes live in eval/sample/pdf_bsdfcos; delta
(roughness == 0) lobes in eval/sample/pdf_delta.
"""

from __future__ import annotations

import torch

from julia_raytracer_tpu_torch.ops import bsdf
from julia_raytracer_tpu_torch.scene.types import MaterialType

M = MaterialType


def _sel(mtype, pairs, default_shape, width=3, present=None):
    """Masked select: pairs = [(MaterialType, thunk -> [..., W])]. Pruned
    thunks are never called."""
    live = [(t, f) for t, f in pairs if present is None or int(t) in present]
    if len(live) == 1:
        return live[0][1]()
    shape = default_shape if width == 3 else default_shape[:-1]
    out = torch.zeros(shape, device=mtype.device)
    for t, f in live:
        mask = mtype == t
        out = torch.where(mask[..., None] if width == 3 else mask, f(), out)
    return out


def eval_bsdfcos(material, normal, outgoing, incoming, present=None):
    """Rough lobes (roughness == 0 -> black)."""
    c, r, ior, met = (material.color, material.roughness, material.ior,
                      material.metallic)
    pairs = [
        (M.MATTE, lambda: bsdf.eval_matte(c, normal, outgoing, incoming)),
        (M.GLOSSY, lambda: bsdf.eval_glossy(c, ior, r, normal, outgoing, incoming)),
        (M.REFLECTIVE, lambda: bsdf.eval_reflective(c, r, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.eval_transparent(c, ior, r, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.eval_refractive(c, ior, r, normal, outgoing, incoming)),
        (M.SUBSURFACE, lambda: bsdf.eval_refractive(c, ior, r, normal, outgoing, incoming)),
        (M.GLTFPBR, lambda: bsdf.eval_gltfpbr(c, ior, r, met, normal, outgoing, incoming)),
    ]
    out = _sel(material.type, pairs, c.shape, present=present)
    return torch.where((r == 0.0)[..., None], 0.0, out)


def sample_bsdfcos(material, normal, outgoing, rnl, rn, present=None):
    """Zero direction where roughness == 0."""
    c, r, ior, met = (material.color, material.roughness, material.ior,
                      material.metallic)
    pairs = [
        (M.MATTE, lambda: bsdf.sample_matte(c, normal, outgoing, rn)),
        (M.GLOSSY, lambda: bsdf.sample_glossy(c, ior, r, normal, outgoing, rnl, rn)),
        (M.REFLECTIVE, lambda: bsdf.sample_reflective(c, r, normal, outgoing, rn)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent(c, ior, r, normal, outgoing, rnl, rn)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive(c, ior, r, normal, outgoing, rnl, rn)),
        (M.SUBSURFACE, lambda: bsdf.sample_refractive(c, ior, r, normal, outgoing, rnl, rn)),
        (M.GLTFPBR, lambda: bsdf.sample_gltfpbr(c, ior, r, met, normal, outgoing, rnl, rn)),
    ]
    out = _sel(material.type, pairs, c.shape, present=present)
    return torch.where((r == 0.0)[..., None], 0.0, out)


def sample_bsdfcos_pdf(material, normal, outgoing, incoming, present=None):
    c, r, ior, met = (material.color, material.roughness, material.ior,
                      material.metallic)
    pairs = [
        (M.MATTE, lambda: bsdf.sample_matte_pdf(c, normal, outgoing, incoming)),
        (M.GLOSSY, lambda: bsdf.sample_glossy_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_pdf(c, r, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.SUBSURFACE, lambda: bsdf.sample_refractive_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.GLTFPBR, lambda: bsdf.sample_gltfpbr_pdf(c, ior, r, met, normal, outgoing, incoming)),
    ]
    out = _sel(material.type, pairs, c.shape, width=1, present=present)
    return torch.where(r == 0.0, 0.0, out)


def _live(pairs, present):
    return [(t, f) for t, f in pairs if present is None or int(t) in present]


def eval_delta(material, normal, outgoing, incoming, present=None):
    """Delta lobes (roughness != 0 -> black)."""
    c, ior = material.color, material.ior
    live = _live([
        (M.REFLECTIVE, lambda: bsdf.eval_reflective_delta(c, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.eval_transparent_delta(c, ior, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.eval_refractive_delta(c, ior, normal, outgoing, incoming)),
        (M.VOLUMETRIC, lambda: bsdf.eval_passthrough(c, normal, outgoing, incoming)),
    ], present)
    if not live:
        return torch.zeros_like(c)
    out = _sel(material.type, live, c.shape)
    return torch.where((material.roughness != 0.0)[..., None], 0.0, out)


def sample_delta(material, normal, outgoing, rnl, present=None):
    c, ior = material.color, material.ior
    live = _live([
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_delta(c, normal, outgoing)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_delta(c, ior, normal, outgoing, rnl)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_delta(c, ior, normal, outgoing, rnl)),
        (M.VOLUMETRIC, lambda: bsdf.sample_passthrough(c, normal, outgoing)),
    ], present)
    if not live:
        return torch.zeros_like(c)
    out = _sel(material.type, live, c.shape)
    return torch.where((material.roughness != 0.0)[..., None], 0.0, out)


def sample_delta_pdf(material, normal, outgoing, incoming, present=None):
    c, ior = material.color, material.ior
    live = _live([
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_delta_pdf(c, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_delta_pdf(c, ior, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_delta_pdf(c, ior, normal, outgoing, incoming)),
        (M.VOLUMETRIC, lambda: bsdf.sample_passthrough_pdf(c, normal, outgoing, incoming)),
    ], present)
    if not live:
        return torch.zeros(c.shape[:-1], device=c.device)
    out = _sel(material.type, live, c.shape, width=1)
    return torch.where(material.roughness != 0.0, 0.0, out)


# ---------------------------------------------------------------------------
# Volume scattering
# ---------------------------------------------------------------------------


def eval_scattering(vol_scattering, vol_density, vol_anisotropy, outgoing,
                    incoming):
    """scattering * density * phase."""
    has = torch.abs(vol_density).sum(dim=-1) > 0
    phase = bsdf.eval_phasefunction(vol_anisotropy, outgoing, incoming)
    return torch.where(
        has[..., None], vol_scattering * vol_density * phase[..., None], 0.0
    )


def sample_scattering(vol_density, vol_anisotropy, outgoing, rn):
    has = torch.abs(vol_density).sum(dim=-1) > 0
    incoming = bsdf.sample_phasefunction(vol_anisotropy, outgoing, rn)
    return torch.where(has[..., None], incoming, 0.0)


def sample_scattering_pdf(vol_density, vol_anisotropy, outgoing, incoming):
    has = torch.abs(vol_density).sum(dim=-1) > 0
    return torch.where(
        has, bsdf.sample_phasefunction_pdf(vol_anisotropy, outgoing, incoming),
        0.0,
    )
