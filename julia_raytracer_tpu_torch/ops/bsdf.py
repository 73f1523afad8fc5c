"""Yocto-style BSDF lobe library on batched tensors, port of
julia_raytracer_tpu/ops/bsdf.py.

Every lobe is an (eval, sample, pdf) triple over [..., 3] vectors:
matte, glossy, reflective (rough + delta), transparent (rough + delta),
refractive (rough + delta), gltfpbr, translucent, passthrough; GGX
microfacet D/G/sample; Fresnel dielectric/conductor/schlick; volume
transmittance and the Henyey-Greenstein phase function. Everything is
branchless (masks + where) so the per-lane material dispatch
(render/dispatch.py) runs as straight elementwise code over a wavefront.
"""

from __future__ import annotations

import math

import torch

from julia_raytracer_tpu_torch.utils.vecmath import (
    basis_fromz, dot, mat_mul_vec, normalize, reflect, refract,
    transform_direction,
)

PIF = math.pi
F32_BIG = 3.4028234663852886e38


def _safe_sqrt(x):
    """sqrt clamped at 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def _k(x):
    """[...,] -> [..., 1] broadcast helper."""
    return x[..., None]


def _up_normal(normal, outgoing):
    """Face the normal toward the outgoing direction."""
    return torch.where(_k(dot(normal, outgoing)) <= 0.0, -normal, normal)


def same_hemisphere(normal, outgoing, incoming):
    return dot(normal, outgoing) * dot(normal, incoming) >= 0.0


def same_strict(normal, outgoing, incoming):
    """dot products strictly same-signed (the `<= 0 -> zero` guard)."""
    return dot(normal, incoming) * dot(normal, outgoing) > 0.0


def _opposite(normal, outgoing, incoming):
    return dot(normal, incoming) * dot(normal, outgoing) < 0.0


def _entering(normal, outgoing, ior):
    """(up, rel_ior) of the refractive lobes: face the normal toward
    outgoing and invert the ior when leaving."""
    entering = dot(normal, outgoing) >= 0.0
    up = torch.where(_k(entering), normal, -normal)
    rel_ior = torch.where(entering, ior, _safe_div(1.0, ior))
    return entering, up, rel_ior


# ---------------------------------------------------------------------------
# Hemisphere / microfacet sampling
# ---------------------------------------------------------------------------


def sample_hemisphere_cos(normal, ruv):
    """Cosine-weighted hemisphere sample."""
    z = _safe_sqrt(ruv[..., 1])
    r = _safe_sqrt(1.0 - z * z)
    phi = 2.0 * PIF * ruv[..., 0]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return transform_direction(basis_fromz(normal), local)


def sample_hemisphere_cos_pdf(normal, direction):
    cosw = dot(normal, direction)
    return torch.where(cosw <= 0.0, 0.0, cosw / PIF)


def microfacet_distribution(roughness, normal, halfway):
    """GGX D."""
    cosine = dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    denom = c2 * r2 + 1.0 - c2
    d = _safe_div(r2, PIF * denom * denom)
    return torch.where(cosine <= 0.0, 0.0, d)


def _microfacet_shadowing1(roughness, normal, halfway, direction):
    """GGX Smith G1."""
    cosine = dot(normal, direction)
    cosineh = dot(halfway, direction)
    r2 = roughness * roughness
    c2 = cosine * cosine
    g = _safe_div(
        2.0 * torch.abs(cosine),
        torch.abs(cosine) + _safe_sqrt(c2 - r2 * c2 + r2),
    )
    return torch.where(cosine * cosineh <= 0.0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return _microfacet_shadowing1(
        roughness, normal, halfway, outgoing
    ) * _microfacet_shadowing1(roughness, normal, halfway, incoming)


def sample_microfacet(roughness, normal, rn):
    """GGX NDF sampling."""
    phi = 2.0 * PIF * rn[..., 0]
    theta = torch.atan(
        roughness * _safe_sqrt(_safe_div(rn[..., 1], 1.0 - rn[..., 1]))
    )
    st, ct = torch.sin(theta), torch.cos(theta)
    local = torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], dim=-1)
    return transform_direction(basis_fromz(normal), local)


def sample_microfacet_pdf(roughness, normal, halfway):
    """D * cos."""
    cosine = dot(normal, halfway)
    return torch.where(
        cosine < 0.0, 0.0,
        microfacet_distribution(roughness, normal, halfway) * cosine,
    )


def _microfacet_reflect_pdf(roughness, up, outgoing, halfway):
    """Reflection-lobe pdf D*cos / (4 |o.h|)."""
    return _safe_div(
        sample_microfacet_pdf(roughness, up, halfway),
        4.0 * torch.abs(dot(outgoing, halfway)),
    )


def _reflect_or_zero(up, outgoing, halfway):
    """Mirror `outgoing` about `halfway`; zero when it leaves the hemisphere."""
    refl = reflect(outgoing, halfway)
    return torch.where(
        _k(same_hemisphere(up, outgoing, refl)), refl, torch.zeros_like(refl)
    )


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


def fresnel_dielectric(eta, normal, outgoing):
    cosw = torch.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - _safe_div(sin2, eta2)
    t0 = _safe_sqrt(cos2t)
    t1 = eta * t0
    t2 = eta * cosw
    rs = _safe_div(cosw - t1, cosw + t1)
    rp = _safe_div(t0 - t2, t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return torch.where(cos2t < 0.0, 1.0, f)  # total internal reflection


def fresnel_conductor(eta, etak, normal, outgoing):
    """eta/etak are [..., 3]."""
    cosw_raw = dot(normal, outgoing)
    cosw = torch.clamp(cosw_raw, -1.0, 1.0)
    cos2 = cosw * cosw
    sin2 = torch.clamp(1.0 - cos2, 0.0, 1.0)
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - _k(sin2)
    a2plusb2 = _safe_sqrt(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2plusb2 + _k(cos2)
    a = _safe_sqrt((a2plusb2 + t0) / 2.0)
    t2 = 2.0 * a * _k(cosw)
    rs = _safe_div(t1 - t2, t1 + t2)
    t3 = _k(cos2) * a2plusb2 + _k(sin2 * sin2)
    t4 = t2 * _k(sin2)
    rp = rs * _safe_div(t3 - t4, t3 + t4)
    f = (rp + rs) / 2.0
    return torch.where(_k(cosw_raw) <= 0.0, 0.0, f)


def fresnel_schlick(reflectivity, normal, outgoing):
    cosw = torch.abs(dot(normal, outgoing))
    return reflectivity + (1.0 - reflectivity) * _k((1.0 - cosw) ** 5)


def eta_to_reflectivity(eta):
    return ((eta - 1.0) * (eta - 1.0)) / ((eta + 1.0) * (eta + 1.0))


def reflectivity_to_eta(reflectivity):
    r = torch.clamp(reflectivity, 0.0, 0.99)
    return (1.0 + _safe_sqrt(r)) / (1.0 - _safe_sqrt(r))


# ---------------------------------------------------------------------------
# Matte
# ---------------------------------------------------------------------------


def eval_matte(color, normal, outgoing, incoming):
    f = color / PIF * _k(torch.abs(dot(normal, incoming)))
    return torch.where(_k(same_strict(normal, outgoing, incoming)), f, 0.0)


def sample_matte(color, normal, outgoing, rn):
    return sample_hemisphere_cos(_up_normal(normal, outgoing), rn)


def sample_matte_pdf(color, normal, outgoing, incoming):
    pdf = sample_hemisphere_cos_pdf(_up_normal(normal, outgoing), incoming)
    return torch.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Glossy
# ---------------------------------------------------------------------------


def eval_glossy(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    f1 = fresnel_dielectric(ior, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_dielectric(ior, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    diffuse = color * _k(1.0 - f1) / PIF * _k(torch.abs(cos_i))
    spec = _k(_safe_div(f * d * g, 4.0 * cos_o * cos_i) * torch.abs(cos_i))
    return torch.where(
        _k(same_strict(normal, outgoing, incoming)), diffuse + spec, 0.0
    )


def sample_glossy(color, ior, roughness, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    f1 = fresnel_dielectric(ior, up, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    refl = _reflect_or_zero(up, outgoing, halfway)
    diff = sample_hemisphere_cos(up, rn)
    return torch.where(_k(rnl < f1), refl, diff)


def sample_glossy_pdf(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    f = fresnel_dielectric(ior, up, outgoing)
    pdf = f * _microfacet_reflect_pdf(roughness, up, outgoing, halfway) + (
        1.0 - f
    ) * sample_hemisphere_cos_pdf(up, incoming)
    return torch.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Reflective / metal
# ---------------------------------------------------------------------------


def eval_reflective(color, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_conductor(
        reflectivity_to_eta(color), torch.zeros_like(color), halfway, incoming
    )
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    val = f * _k(_safe_div(d * g, 4.0 * cos_o * cos_i) * torch.abs(cos_i))
    return torch.where(_k(same_strict(normal, outgoing, incoming)), val, 0.0)


def sample_reflective(color, roughness, normal, outgoing, rn):
    up = _up_normal(normal, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    return _reflect_or_zero(up, outgoing, halfway)


def sample_reflective_pdf(color, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    pdf = _microfacet_reflect_pdf(roughness, up, outgoing, halfway)
    return torch.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


def eval_reflective_delta(color, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    f = fresnel_conductor(
        reflectivity_to_eta(color), torch.zeros_like(color), up, outgoing
    )
    return torch.where(_k(same_strict(normal, outgoing, incoming)), f, 0.0)


def sample_reflective_delta(color, normal, outgoing):
    return reflect(outgoing, _up_normal(normal, outgoing))


def sample_reflective_delta_pdf(color, normal, outgoing, incoming):
    return torch.where(same_strict(normal, outgoing, incoming), 1.0, 0.0)


# ---------------------------------------------------------------------------
# glTF PBR
# ---------------------------------------------------------------------------


def _gltf_reflectivity(color, ior, metallic):
    ior3 = _k(ior).expand_as(color)
    return eta_to_reflectivity(ior3) * _k(1.0 - metallic) + color * _k(metallic)


def eval_gltfpbr(color, ior, roughness, metallic, normal, outgoing, incoming):
    reflectivity = _gltf_reflectivity(color, ior, metallic)
    up = _up_normal(normal, outgoing)
    f1 = fresnel_schlick(reflectivity, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_schlick(reflectivity, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    diffuse = (
        color * _k(1.0 - metallic) * (1.0 - f1) / PIF * _k(torch.abs(cos_i))
    )
    spec = f * _k(_safe_div(d * g, 4.0 * cos_o * cos_i) * torch.abs(cos_i))
    return torch.where(
        _k(same_strict(normal, outgoing, incoming)), diffuse + spec, 0.0
    )


def sample_gltfpbr(color, ior, roughness, metallic, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    reflectivity = _gltf_reflectivity(color, ior, metallic)
    f_mean = fresnel_schlick(reflectivity, up, outgoing).mean(dim=-1)
    halfway = sample_microfacet(roughness, up, rn)
    refl = _reflect_or_zero(up, outgoing, halfway)
    diff = sample_hemisphere_cos(up, rn)
    return torch.where(_k(rnl < f_mean), refl, diff)


def sample_gltfpbr_pdf(color, ior, roughness, metallic, normal, outgoing,
                       incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    reflectivity = _gltf_reflectivity(color, ior, metallic)
    f = fresnel_schlick(reflectivity, up, outgoing).mean(dim=-1)
    pdf = f * _microfacet_reflect_pdf(roughness, up, outgoing, halfway) + (
        1.0 - f
    ) * sample_hemisphere_cos_pdf(up, incoming)
    return torch.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Transparent
# ---------------------------------------------------------------------------


def eval_transparent(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    # reflection branch
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    refl = _k(_safe_div(f_r * d_r * g_r, 4.0 * cos_o * cos_i) * torch.abs(cos_i))
    # transmission branch (mirror trick)
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    f_t = fresnel_dielectric(ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, reflected)
    cos_r = dot(up, reflected)
    trans = color * _k(
        _safe_div((1.0 - f_t) * d_t * g_t, 4.0 * cos_o * cos_r)
        * torch.abs(cos_r)
    )
    return torch.where(_k(same), refl, trans)


def sample_transparent(color, ior, roughness, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    f = fresnel_dielectric(ior, halfway, outgoing)
    refl = _reflect_or_zero(up, outgoing, halfway)
    trans = -reflect(reflect(outgoing, halfway), up)
    trans = torch.where(
        _k(same_hemisphere(up, outgoing, trans)), torch.zeros_like(trans), trans
    )
    return torch.where(_k(rnl < f), refl, trans)


def sample_transparent_pdf(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(ior, h_r, outgoing) * _microfacet_reflect_pdf(
        roughness, up, outgoing, h_r
    )
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    pdf_t = _safe_div(
        (1.0 - fresnel_dielectric(ior, h_t, outgoing))
        * sample_microfacet_pdf(roughness, up, h_t),
        4.0 * torch.abs(dot(outgoing, h_t)),
    )
    return torch.where(same, pdf_r, pdf_t)


def eval_transparent_delta(color, ior, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    f = fresnel_dielectric(ior, up, outgoing)
    ones = torch.ones_like(color)
    return torch.where(_k(same), ones * _k(f), color * _k(1.0 - f))


def sample_transparent_delta(color, ior, normal, outgoing, rnl):
    up = _up_normal(normal, outgoing)
    f = fresnel_dielectric(ior, up, outgoing)
    return torch.where(_k(rnl < f), reflect(outgoing, up), -outgoing)


def sample_transparent_delta_pdf(color, ior, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    f = fresnel_dielectric(ior, up, outgoing)
    return torch.where(same, f, 1.0 - f)


# ---------------------------------------------------------------------------
# Refractive; subsurface aliases to these
# ---------------------------------------------------------------------------


def _refractive_halfway_t(rel_ior, entering, incoming, outgoing):
    """Transmission half vector ([Walter 2007] eq. 21)."""
    sign = torch.where(entering, 1.0, -1.0)
    return -normalize(_k(rel_ior) * incoming + outgoing) * _k(sign)


def eval_refractive(color, ior, roughness, normal, outgoing, incoming):
    entering, up, rel_ior = _entering(normal, outgoing, ior)
    same = same_hemisphere(normal, outgoing, incoming)
    cos_no = dot(normal, outgoing)
    cos_ni = dot(normal, incoming)
    # reflection
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(rel_ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    refl = _k(
        _safe_div(f_r * d_r * g_r, torch.abs(4.0 * cos_no * cos_ni))
        * torch.abs(cos_ni)
    )
    # transmission
    h_t = _refractive_halfway_t(rel_ior, entering, incoming, outgoing)
    f_t = fresnel_dielectric(rel_ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, incoming)
    denom = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    trans = _k(
        torch.abs(
            _safe_div(dot(outgoing, h_t) * dot(incoming, h_t), cos_no * cos_ni)
        )
        * _safe_div((1.0 - f_t) * d_t * g_t, denom)
        * torch.abs(cos_ni)
    )
    val = torch.where(_k(same), refl, trans)
    return val.expand_as(color) * torch.ones_like(color)


def sample_refractive(color, ior, roughness, normal, outgoing, rnl, rn):
    entering, up, rel_ior = _entering(normal, outgoing, ior)
    halfway = sample_microfacet(roughness, up, rn)
    f = fresnel_dielectric(rel_ior, halfway, outgoing)
    refl = _reflect_or_zero(up, outgoing, halfway)
    inv_eta = torch.where(entering, _safe_div(1.0, ior), ior)
    trans = refract(outgoing, halfway, inv_eta)
    trans = torch.where(
        _k(same_hemisphere(up, outgoing, trans)), torch.zeros_like(trans), trans
    )
    return torch.where(_k(rnl < f), refl, trans)


def sample_refractive_pdf(color, ior, roughness, normal, outgoing, incoming):
    entering, up, rel_ior = _entering(normal, outgoing, ior)
    same = same_hemisphere(normal, outgoing, incoming)
    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(rel_ior, h_r, outgoing) * _microfacet_reflect_pdf(
        roughness, up, outgoing, h_r
    )
    h_t = _refractive_halfway_t(rel_ior, entering, incoming, outgoing)
    denom = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    pdf_t = (
        (1.0 - fresnel_dielectric(rel_ior, h_t, outgoing))
        * sample_microfacet_pdf(roughness, up, h_t)
        * _safe_div(torch.abs(dot(h_t, incoming)), denom)
    )
    return torch.where(same, pdf_r, pdf_t)


def eval_refractive_delta(color, ior, normal, outgoing, incoming):
    """Includes the |ior-1| < 1e-3 passthrough case."""
    passthrough = torch.abs(ior - 1.0) < 1e-3
    opposite = dot(normal, incoming) * dot(normal, outgoing) <= 0.0
    ones = torch.ones_like(color)
    pass_val = torch.where(_k(opposite), ones, torch.zeros_like(color))
    _, up, rel_ior = _entering(normal, outgoing, ior)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    val = torch.where(
        _k(same),
        ones * _k(f),
        ones * _k(_safe_div(1.0, rel_ior * rel_ior) * (1.0 - f)),
    )
    return torch.where(_k(passthrough), pass_val, val)


def sample_refractive_delta(color, ior, normal, outgoing, rnl):
    passthrough = torch.abs(ior - 1.0) < 1e-3
    _, up, rel_ior = _entering(normal, outgoing, ior)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    refl = reflect(outgoing, up)
    trans = refract(outgoing, up, _safe_div(1.0, rel_ior))
    val = torch.where(_k(rnl < f), refl, trans)
    return torch.where(_k(passthrough), -outgoing, val)


def sample_refractive_delta_pdf(color, ior, normal, outgoing, incoming):
    passthrough = torch.abs(ior - 1.0) < 1e-3
    pass_pdf = torch.where(_opposite(normal, outgoing, incoming), 1.0, 0.0)
    _, up, rel_ior = _entering(normal, outgoing, ior)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = same_hemisphere(normal, outgoing, incoming)
    pdf = torch.where(same, f, 1.0 - f)
    return torch.where(passthrough, pass_pdf, pdf)


# ---------------------------------------------------------------------------
# Translucent + passthrough
# ---------------------------------------------------------------------------


def eval_translucent(color, normal, outgoing, incoming):
    f = color / PIF * _k(torch.abs(dot(normal, incoming)))
    return torch.where(_k(_opposite(normal, outgoing, incoming)), f, 0.0)


def sample_translucent(color, normal, outgoing, rn):
    return sample_hemisphere_cos(-_up_normal(normal, outgoing), rn)


def sample_translucent_pdf(color, normal, outgoing, incoming):
    pdf = sample_hemisphere_cos_pdf(-_up_normal(normal, outgoing), incoming)
    return torch.where(_opposite(normal, outgoing, incoming), pdf, 0.0)


def eval_passthrough(color, normal, outgoing, incoming):
    return torch.where(
        _k(_opposite(normal, outgoing, incoming)),
        torch.ones_like(color), torch.zeros_like(color),
    )


def sample_passthrough(color, normal, outgoing):
    return -outgoing


def sample_passthrough_pdf(color, normal, outgoing, incoming):
    return torch.where(_opposite(normal, outgoing, incoming), 1.0, 0.0)


# ---------------------------------------------------------------------------
# Volumes: transmittance + Henyey-Greenstein phase
# ---------------------------------------------------------------------------


def eval_transmittance(density, distance):
    return torch.exp(-density * _k(distance))


def sample_transmittance(density, max_distance, rl, rd):
    """Channel-random exponential distance sampling."""
    channel = torch.clamp((rl * 3.0).to(torch.int64), 0, 2)
    dens = density.gather(-1, channel[..., None])[..., 0]
    distance = torch.where(
        dens == 0.0,
        F32_BIG,
        -torch.log(torch.clamp(1.0 - rd, min=1e-38))
        / torch.where(dens == 0, 1.0, dens),
    )
    return torch.minimum(distance, max_distance)


def sample_transmittance_pdf(density, distance, max_distance):
    inside = distance < max_distance
    pdf_in = (density * torch.exp(-density * _k(distance))).sum(dim=-1) / 3.0
    pdf_out = torch.exp(-density * _k(max_distance)).sum(dim=-1) / 3.0
    return torch.where(inside, pdf_in, pdf_out)


def eval_phasefunction(anisotropy, outgoing, incoming):
    """Henyey-Greenstein."""
    cosine = -dot(outgoing, incoming)
    denom = 1.0 + anisotropy * anisotropy - 2.0 * anisotropy * cosine
    denom = torch.clamp(denom, min=1e-12)
    return (1.0 - anisotropy * anisotropy) / (
        4.0 * PIF * denom * _safe_sqrt(denom)
    )


def sample_phasefunction(anisotropy, outgoing, rn):
    iso = torch.abs(anisotropy) < 1e-3
    ct_iso = 1.0 - 2.0 * rn[..., 1]
    denom = 1.0 + anisotropy - 2.0 * anisotropy * rn[..., 1]
    square = _safe_div(1.0 - anisotropy * anisotropy, denom)
    ct_aniso = _safe_div(
        1.0 + anisotropy * anisotropy - square * square, 2.0 * anisotropy
    )
    cos_theta = torch.where(iso, ct_iso, ct_aniso)
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * PIF * rn[..., 0]
    local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )
    return mat_mul_vec(basis_fromz(-outgoing), local)


def sample_phasefunction_pdf(anisotropy, outgoing, incoming):
    return eval_phasefunction(anisotropy, outgoing, incoming)
