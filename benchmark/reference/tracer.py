"""The plain reference path tracer: Yocto/GL's `path` sampler over quads,
written from the scene's numpy arrays in plain PyTorch.

It imports nothing of the program. It builds its own world geometry from
the scene description the benchmark hands to both sides, its own
acceleration (boxes over runs of consecutive quads, two levels), and
follows the same per-lane random stream (reference/pcg.py), so a path
of the reference and the program's path of the same (pixel, sample,
seed) make the same decisions until rounding sends one across an edge
or a threshold. Every float runs in `dtype`: float32 is the reference,
a lower precision is the control.

Semantics (Yocto/GL 4.2 `trace_path`, as the program states them):
- camera: pinhole through the pixel jittered by two uniforms; two more
  uniforms for the lens, unused at aperture 0;
- each surface: shading normal = the quad's normal faced toward the
  viewer; emission added; the next direction from the BSDF or from the
  lights with one-sample MIS (probability 1/2 each), weight
  f cos / (pdf_bsdf / 2 + pdf_lights / 2); the lights' pdf is the
  occluder-free sum over every emissive quad the direction crosses;
- Russian roulette after the fourth bounce (survival max(weight),
  at most 0.99); a lane with zero or non-finite weight stops;
- at most `bounces` + 1 surfaces; the sample's radiance clamped to
  `clamp` by its largest channel, non-finite radiance taken as 0.
Materials: matte, glossy (dielectric-coated diffuse, GGX) and rough
reflective (GGX conductor), roughness squared and clamped as Yocto does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import pcg

RAY_EPS = 1e-4
FMAX = 3.4028234663852886e38
MIN_ROUGHNESS = 0.03 * 0.03
KINDS = {"matte": 0, "glossy": 1, "reflective": 2}
# quads a chunk and chunks a super of the acceleration; scenes of at most
# BRUTE quads are tested against every quad
CHUNK, SUPER, BRUTE = 32, 32, 4096
PI = math.pi


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    n = torch.sqrt(dot(a, a))[..., None]
    return torch.where(n > 0, a / torch.where(n > 0, n, torch.ones_like(n)), a)


def sqrt0(x):
    """sqrt, 0 at and below 0, with a finite gradient there."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def reflect(w, n):
    return -w + 2.0 * dot(n, w)[..., None] * n


def basis_fromz(z):
    """Duff et al.'s branchless frame (rows x, y, z), as Yocto builds it."""
    z = normalize(z)
    sign = torch.where(z[..., 2] >= 0, 1.0, -1.0).to(z.dtype)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = torch.stack([1.0 + sign * z[..., 0] * z[..., 0] * a, sign * b,
                     -sign * z[..., 0]], -1)
    y = torch.stack([b, sign + z[..., 1] * z[..., 1] * a, -z[..., 1]], -1)
    return x, y, z


def to_world(frame_z, local):
    x, y, z = basis_fromz(frame_z)
    return normalize(x * local[..., 0:1] + y * local[..., 1:2]
                     + z * local[..., 2:3])


def tri_normal(a, b, c):
    return normalize(cross(b - a, c - a))


def moller(ro, rd, a, b, c):
    """Ray against triangle (a, b, c): (hit inside the edges, u, v, t)."""
    e1, e2 = b - a, c - a
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = ro - a
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv
    t = dot(e2, qvec) * inv
    ok = (det != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return ok, u, v, t


def quad_test(ro, rd, tmin, tmax, p):
    """Rays [..., 3] against quads p [..., 4, 3] as the triangles
    (p1, p2, p4) and (p3, p4, p2), the second's (u, v) flipped:
    (hit, u, v, t)."""
    p1, p2, p3, p4 = p.unbind(-2)
    h1, u1, v1, t1 = moller(ro, rd, p1, p2, p4)
    h2, u2, v2, t2 = moller(ro, rd, p3, p4, p2)
    h1 = h1 & (t1 >= tmin) & (t1 <= tmax)
    h2 = h2 & (t2 >= tmin) & (t2 <= tmax)
    big = torch.full_like(t1, torch.finfo(t1.dtype).max)
    t1, t2 = torch.where(h1, t1, big), torch.where(h2, t2, big)
    first = t1 < t2
    return (h1 | h2, torch.where(first, u1, 1.0 - u2),
            torch.where(first, v1, 1.0 - v2), torch.where(first, t1, t2))


def quad_point(p, u, v):
    p1, p2, p3, p4 = p.unbind(-2)
    u, v = u[..., None], v[..., None]
    lower = p1 * (1.0 - u - v) + p2 * u + p4 * v
    upper = p3 * (u + v - 1.0) + p4 * (1.0 - u) + p2 * (1.0 - v)
    return torch.where(u + v <= 1.0, lower, upper)


def quad_normal(p):
    p1, p2, p3, p4 = p.unbind(-2)
    return normalize(tri_normal(p1, p2, p4) + tri_normal(p3, p4, p2))


def _boxes(verts, size):
    """Bounds [n, 2, 3] of runs of `size` consecutive quads (float32)."""
    q = verts.shape[0]
    pad = -q % size
    lo = verts.amin(1)
    hi = verts.amax(1)
    if pad:
        lo = torch.cat([lo, lo[-1:].expand(pad, 3)])
        hi = torch.cat([hi, hi[-1:].expand(pad, 3)])
    lo = lo.view(-1, size, 3).amin(1)
    hi = hi.view(-1, size, 3).amax(1)
    # widened so that rounding never culls a hit
    eps = 1e-4 + 1e-5 * (hi - lo).abs().amax()
    return torch.stack([lo - eps, hi + eps], 1)


def _slab(ro, inv, box, tmax):
    """[..., 3] rays against [..., 2, 3] boxes: may the ray hit before
    tmax?"""
    a = (box[..., 0, :] - ro) * inv
    b = (box[..., 1, :] - ro) * inv
    lo = torch.minimum(a, b).amax(-1).clamp(min=0.0)
    hi = torch.maximum(a, b).amin(-1)
    return lo <= torch.minimum(hi, tmax) * 1.0001


class Scene:
    """World quads, materials and lights of a scene description (see
    benchmark/scenes) on `device`, floats in `dtype`."""

    def __init__(self, desc: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        verts, qmat = [], []
        for inst in desc["instances"]:
            shp = desc["shapes"][inst["shape"]]
            w = shp["positions"][np.asarray(shp["quads"]).reshape(-1)]
            f = np.asarray(inst["frame"], np.float32)
            verts.append((w.reshape(-1, 4, 3) @ f[:3] + f[3]).astype(np.float32))
            qmat.append(np.full(len(w) // 4, inst["material"], np.int64))
        v32 = torch.from_numpy(np.concatenate(verts)).to(self.device)
        self.verts = v32.to(dtype)
        self.qmat = torch.from_numpy(np.concatenate(qmat)).to(self.device)
        self.n_quads = int(v32.shape[0])
        mats = desc["materials"]
        for m in mats:
            r2 = m["roughness"] ** 2
            if m["type"] not in KINDS or (m["type"] == "reflective"
                                          and r2 < MIN_ROUGHNESS):
                raise ValueError(f"the reference has no lobe for {m}")

        def table(key):
            a = np.asarray([m[key] for m in mats], np.float32)
            return torch.from_numpy(a).to(self.device)

        self.mtype = torch.tensor([KINDS[m["type"]] for m in mats],
                                  device=self.device)
        self.color = table("color").to(dtype)
        self.emission = table("emission").to(dtype)
        rough = table("roughness") ** 2
        self.rough = torch.where(self.mtype == 2, rough,
                                 rough.clamp(MIN_ROUGHNESS, 1.0))
        self.ior = table("ior")
        # lights: each instance whose material emits; its quads by area
        emissive = (self.emission.abs().sum(1) > 0)[self.qmat]
        lq = torch.nonzero(emissive)[:, 0]
        lv = v32[lq].double()
        area = (0.5 * cross(lv[:, 1] - lv[:, 0], lv[:, 3] - lv[:, 0]).norm(dim=-1)
                + 0.5 * cross(lv[:, 1] - lv[:, 2], lv[:, 3] - lv[:, 2]).norm(dim=-1))
        inst_of = torch.from_numpy(np.concatenate([
            np.full(len(np.asarray(desc["shapes"][i["shape"]]["quads"])), k)
            for k, i in enumerate(desc["instances"])])).to(self.device)
        owners = inst_of[lq]
        self.light_ids = torch.unique(owners)  # instances, in order
        self.n_lights = int(self.light_ids.numel())
        self.light_verts = v32[lq].to(dtype)
        self.light_owner = torch.searchsorted(self.light_ids, owners)
        total = torch.zeros(self.n_lights, dtype=torch.float64,
                            device=self.device).index_add(0, self.light_owner, area)
        self.light_cdf = [torch.cumsum(area[self.light_owner == k], 0).float()
                          for k in range(self.n_lights)]
        self.light_first = [int(torch.nonzero(self.light_owner == k)[0, 0])
                            for k in range(self.n_lights)]
        self.light_owner_area = total.float()[self.light_owner].to(dtype)
        if self.n_quads > BRUTE:
            self.chunk_box = _boxes(v32, CHUNK)
            self.super_box = _boxes(v32, CHUNK * SUPER)

    # ---- closest hit ------------------------------------------------------

    def intersect(self, ro, rd, tmax, block: int = 1 << 16):
        """Closest hit of rays [N, 3] with tmin RAY_EPS and tmax [N]:
        (hit, quad, u, v, t); ties keep the lower quad index."""
        n = ro.shape[0]
        key = torch.full((n,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=self.device)
        for s in range(0, n, block):
            e = min(n, s + block)
            key[s:e] = self._block_keys(ro[s:e], rd[s:e], tmax[s:e])
        hit = key != torch.iinfo(torch.int64).max
        quad = torch.where(hit, key & 0x7FFFFFFF, 0)
        _, u, v, t = quad_test(ro, rd, RAY_EPS, tmax, self.verts[quad])
        return hit, quad, u, v, t

    def _keys(self, ri, qi, ro, rd, tmax):
        """(t bits << 31 | quad) of each (ray, quad) pair that hits."""
        h, _, _, t = quad_test(ro[ri], rd[ri], RAY_EPS, tmax[ri],
                               self.verts[qi])
        tb = t.float().clamp(min=0.0).view(torch.int32).to(torch.int64)
        k = (tb << 31) | qi
        return torch.where(h, k, torch.iinfo(torch.int64).max)

    def _block_keys(self, ro, rd, tmax):
        n = ro.shape[0]
        dev = self.device
        out = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                         device=dev)
        if self.n_quads <= BRUTE:
            q = torch.arange(self.n_quads, device=dev)
            step = max(1, (1 << 22) // self.n_quads)
            for s in range(0, n, step):
                e = min(n, s + step)
                ri = torch.arange(s, e, device=dev)[:, None].expand(-1, self.n_quads)
                k = self._keys(ri, q.expand(e - s, -1), ro, rd, tmax)
                out[s:e] = k.amin(1)
            return out
        r32, d32 = ro.float(), rd.float()
        d32 = torch.where(d32 == 0, torch.full_like(d32, 1e-30), d32)
        inv, tm = 1.0 / d32, tmax.float().clamp(max=FMAX)
        # supers, then their chunks, then the chunks' quads
        rows = max(1, (1 << 22) // self.super_box.shape[0])
        pairs = []
        for s in range(0, n, rows):
            sl = slice(s, s + rows)
            sh = _slab(r32[sl, None], inv[sl, None], self.super_box[None],
                       tm[sl, None])
            r, c = torch.nonzero(sh, as_tuple=True)
            pairs.append((r + s, c))
        ri = torch.cat([p[0] for p in pairs])
        si = torch.cat([p[1] for p in pairs])
        ci = (si[:, None] * SUPER + torch.arange(SUPER, device=dev)).clamp(
            max=self.chunk_box.shape[0] - 1)
        ch = _slab(r32[ri][:, None], inv[ri][:, None], self.chunk_box[ci],
                   tm[ri][:, None])
        pr, pc = torch.nonzero(ch, as_tuple=True)
        ri, ci = ri[pr], ci[pr, pc]
        # a chunk repeated by the clamp is harmless: the min takes it once
        step = 1 << 17
        for s in range(0, ri.shape[0], step):
            r = ri[s:s + step, None].expand(-1, CHUNK)
            q = (ci[s:s + step, None] * CHUNK
                 + torch.arange(CHUNK, device=dev)).clamp(max=self.n_quads - 1)
            k = self._keys(r, q, ro, rd, tmax).amin(1)
            out.scatter_reduce_(0, ri[s:s + step], k, "amin")
        return out

    # ---- lights -----------------------------------------------------------

    def sample_light(self, pos, r_pick, r_el, ruv):
        lid = torch.clamp((r_pick.float() * self.n_lights).long(), 0,
                          self.n_lights - 1)
        el = torch.zeros_like(lid)
        for k in range(self.n_lights):
            cdf = self.light_cdf[k]
            total = cdf[-1]
            limit = torch.minimum((r_el.float() * total).clamp(min=0.0),
                                  total - 1e-5)
            idx = torch.searchsorted(cdf, limit.contiguous(), right=True)
            idx = idx.clamp(max=cdf.numel() - 1) + self.light_first[k]
            el = torch.where(lid == k, idx, el)
        lpos = quad_point(self.light_verts[el], ruv[..., 0], ruv[..., 1])
        return normalize(lpos - pos)

    def light_pdf(self, pos, d):
        """Solid-angle pdf of d under light sampling (no occlusion)."""
        pdf = torch.zeros(pos.shape[:-1], dtype=self.dtype, device=self.device)
        for e in range(self.light_verts.shape[0]):
            p1, p2, p3, p4 = self.light_verts[e].unbind(0)
            for a, b, c in ((p1, p2, p4), (p3, p4, p2)):
                ok, _, _, t = moller(pos, d, a, b, c)
                ok = ok & (t >= RAY_EPS)
                cos = dot(tri_normal(a, b, c), d).abs()
                val = t * t / torch.clamp(cos * self.light_owner_area[e], min=1e-30)
                pdf = pdf + torch.where(ok, val, torch.zeros_like(val))
        return pdf / self.n_lights


# ---- BSDFs (n faces the viewer: n . o >= 0) --------------------------------


def fresnel_dielectric(eta, n, w):
    cosw = dot(n, w).abs()
    sin2 = 1.0 - cosw * cosw
    cos2t = 1.0 - safe_div(sin2, eta * eta)
    t0 = sqrt0(cos2t)
    t1, t2 = eta * t0, eta * cosw
    rs = safe_div(cosw - t1, cosw + t1)
    rp = safe_div(t0 - t2, t0 + t2)
    return torch.where(cos2t < 0, torch.ones_like(rs), (rs * rs + rp * rp) / 2.0)


def fresnel_conductor(eta, n, w):
    """Conductor with zero extinction: eta [N, 3]."""
    craw = dot(n, w)
    c = craw.clamp(-1.0, 1.0)[..., None]
    cos2 = c * c
    sin2 = (1.0 - cos2).clamp(0.0, 1.0)
    eta2 = eta * eta
    t0 = eta2 - sin2
    a2b2 = sqrt0(t0 * t0)
    t1 = a2b2 + cos2
    a = sqrt0((a2b2 + t0) / 2.0)
    t2 = 2.0 * a * c
    rs = safe_div(t1 - t2, t1 + t2)
    t3 = cos2 * a2b2 + sin2 * sin2
    t4 = t2 * sin2
    rp = rs * safe_div(t3 - t4, t3 + t4)
    return torch.where(craw[..., None] <= 0, torch.zeros_like(rs), (rp + rs) / 2.0)


def ggx_d(r, n, h):
    c = dot(n, h)
    r2, c2 = r * r, c * c
    den = c2 * r2 + 1.0 - c2
    return torch.where(c <= 0, torch.zeros_like(c), safe_div(r2, PI * den * den))


def ggx_g1(r, n, h, w):
    c, ch = dot(n, w), dot(h, w)
    r2, c2 = r * r, c * c
    g = safe_div(2.0 * c.abs(), c.abs() + sqrt0(c2 - r2 * c2 + r2))
    return torch.where(c * ch <= 0, torch.zeros_like(g), g)


def ggx_sample(r, n, rn):
    phi = 2.0 * PI * rn[..., 0]
    theta = torch.atan(r * sqrt0(safe_div(rn[..., 1], 1.0 - rn[..., 1])))
    local = torch.stack([torch.cos(phi) * torch.sin(theta),
                         torch.sin(phi) * torch.sin(theta), torch.cos(theta)], -1)
    return to_world(n, local)


def ggx_reflect_pdf(r, n, o, h):
    c = dot(n, h)
    pdf = torch.where(c < 0, torch.zeros_like(c), ggx_d(r, n, h) * c)
    return safe_div(pdf, 4.0 * dot(o, h).abs())


def cos_sample(n, rn):
    z = sqrt0(rn[..., 1])
    r = sqrt0(1.0 - z * z)
    phi = 2.0 * PI * rn[..., 0]
    return to_world(n, torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1))


def cos_pdf(n, w):
    c = dot(n, w)
    return torch.where(c <= 0, torch.zeros_like(c), c / PI)


def refl_or_zero(n, o, h):
    w = reflect(o, h)
    same = dot(n, o) * dot(n, w) >= 0
    return torch.where(same[..., None], w, torch.zeros_like(w))


def bsdf_sample(kind, rough, ior, n, o, rnl, rn):
    diffuse = cos_sample(n, rn)
    h = ggx_sample(rough, n, rn)
    spec = refl_or_zero(n, o, h)
    f1 = fresnel_dielectric(ior, n, o)
    glossy = torch.where((rnl < f1)[..., None], spec, diffuse)
    return torch.where((kind == 0)[..., None], diffuse,
                       torch.where((kind == 1)[..., None], glossy, spec))


def bsdf_eval(kind, color, rough, ior, n, o, i):
    """f * |cos| of each lobe."""
    same = (dot(n, i) * dot(n, o) > 0)[..., None]
    cos_i, cos_o = dot(n, i), dot(n, o)
    h = normalize(i + o)
    d = ggx_d(rough, n, h)
    g = ggx_g1(rough, n, h, o) * ggx_g1(rough, n, h, i)
    den = 4.0 * cos_o * cos_i
    spec = safe_div(d * g, den) * cos_i.abs()
    matte = color / PI * cos_i.abs()[..., None]
    f1 = fresnel_dielectric(ior, n, o)
    fh = fresnel_dielectric(ior, h, i)
    glossy = (color * (1.0 - f1)[..., None] / PI * cos_i.abs()[..., None]
              + (safe_div(fh * d * g, den) * cos_i.abs())[..., None])
    rc = color.clamp(0.0, 0.99)
    eta = (1.0 + sqrt0(rc)) / (1.0 - sqrt0(rc))
    metal = fresnel_conductor(eta, h, i) * spec[..., None]
    f = torch.where((kind == 0)[..., None], matte,
                    torch.where((kind == 1)[..., None], glossy, metal))
    return torch.where(same, f, torch.zeros_like(f))


def bsdf_pdf(kind, rough, ior, n, o, i):
    same = dot(n, i) * dot(n, o) > 0
    h = normalize(o + i)
    spec = ggx_reflect_pdf(rough, n, o, h)
    diff = cos_pdf(n, i)
    f = fresnel_dielectric(ior, n, o)
    glossy = f * spec + (1.0 - f) * diff
    p = torch.where(kind == 0, diff, torch.where(kind == 1, glossy, spec))
    return torch.where(same, p, torch.zeros_like(p))


# ---- camera and paths ------------------------------------------------------


def camera_rays(cam: dict, pixel, width, height, puv, dtype, device):
    """Pinhole rays through pixel ids [N] jittered by puv [N, 2] (aperture
    0: the lens sample moves nothing)."""
    if cam["aperture"] != 0:
        raise ValueError("the reference traces pinhole cameras only")
    aspect, film = float(cam["aspect"]), float(cam["film"])
    fx = film if aspect >= 1 else film * aspect
    fy = film / aspect if aspect >= 1 else film
    px = ((pixel % width).float() + puv[..., 0].float()) / width
    py = ((pixel // width).float() + puv[..., 1].float()) / height
    q = torch.stack([fx * (0.5 - px), fy * (py - 0.5),
                     torch.full_like(px, float(cam["lens"]))], -1).to(dtype)
    dc = -normalize(q)
    p = dc * (float(cam["focus"]) / dc[..., 2].abs())[..., None]
    d = normalize(p)
    frame = torch.as_tensor(np.asarray(cam["frame"], np.float32),
                            device=device).to(dtype)
    ro = frame[3].expand_as(d).clone()
    rd = normalize(d[..., 0:1] * frame[0] + d[..., 1:2] * frame[1]
                   + d[..., 2:3] * frame[2])
    return ro, rd


def trace(scene: Scene, cam: dict, pixel, sample, seed: int, width: int,
          height: int, bounces: int = 8, clamp: float | None = 10.0,
          color=None, emission=None):
    """One path for each lane of pixel ids [N] and sample ids [N].
    Returns (radiance [N, 3], hit [N], albedo [N, 3], normal [N, 3], rd):
    the radiance clamped by its largest channel to `clamp` (None: not
    clamped) and non-finite radiance taken as 0. `color` and `emission`
    replace the material tables (a differentiable path runs through
    them; sampled directions, pdfs and the roulette's probability are
    not differentiated)."""
    dt, dev = scene.dtype, scene.device
    color = scene.color if color is None else color
    emission = scene.emission if emission is None else emission
    rng = pcg.seed_state(pixel, sample, seed)
    puv, rng = pcg.rand2f(rng)
    _, rng = pcg.rand2f(rng)  # lens sample
    ro, rd = camera_rays(cam, pixel, width, height, puv, dt, dev)
    rd0 = rd
    n = pixel.shape[0]
    fmax = torch.full((n,), torch.finfo(dt).max, dtype=dt, device=dev)
    hit, quad, u, v, t = scene.intersect(ro, rd, fmax)
    rad = torch.zeros((n, 3), dtype=color.dtype, device=dev)
    weight = torch.ones((n, 3), dtype=color.dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    first_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    albedo = torch.zeros((n, 3), dtype=dt, device=dev)
    normal0 = torch.zeros((n, 3), dtype=dt, device=dev)

    def rand(state):
        x, state = pcg.rand1f(state)
        return x.to(dt), state

    for b in range(bounces + 1):
        alive = alive & hit
        p = scene.verts[quad]
        pos = quad_point(p, u, v)
        o = -rd
        gn = quad_normal(p)
        nrm = torch.where((dot(gn, o) >= 0)[..., None], gn, -gn)
        m = scene.qmat[quad]
        kind, rough, ior = scene.mtype[m], scene.rough[m].to(dt), scene.ior[m].to(dt)
        col = color[m]
        if b == 0:
            first_hit = alive.clone()
            albedo = torch.where(alive[..., None], col.detach().to(dt), albedo)
            normal0 = torch.where(alive[..., None], nrm, normal0)
        rad = rad + torch.where(alive[..., None], weight * emission[m],
                                torch.zeros_like(rad))
        r_half, rng = rand(rng)
        rnl, rng = rand(rng)
        rn0, rng = rand(rng)
        rn1, rng = rand(rng)
        r_pick, rng = rand(rng)
        r_el, rng = rand(rng)
        ru0, rng = rand(rng)
        ru1, rng = rand(rng)
        rn = torch.stack([rn0, rn1], -1)
        i_bsdf = bsdf_sample(kind, rough, ior, nrm, o, rnl, rn)
        i_light = scene.sample_light(pos, r_pick, r_el, torch.stack([ru0, ru1], -1))
        inc = torch.where((r_half < 0.5)[..., None], i_bsdf, i_light)
        alive = alive & (inc.abs().sum(-1) != 0)
        tmax = torch.where(alive, fmax, torch.full_like(fmax, -1.0))
        hit, quad, u, v, t = scene.intersect(pos, inc, tmax)
        pdf = (0.5 * bsdf_pdf(kind, rough, ior, nrm, o, inc)
               + 0.5 * scene.light_pdf(pos, inc))
        f = bsdf_eval(kind, col.to(dt), rough, ior, nrm, o, inc).to(weight.dtype)
        w = f / torch.clamp(pdf, min=1e-30).to(weight.dtype)[..., None]
        weight = torch.where(alive[..., None], weight * w, weight)
        bad = (weight.abs().sum(-1) == 0) | ~torch.isfinite(weight).all(-1)
        alive = alive & ~bad
        r_rr, rng = rand(rng)
        if b > 3:
            prob = weight.detach().amax(-1).clamp(max=0.99)
            die = alive & (r_rr.to(prob.dtype) >= prob)
            survive = alive & ~die
            weight = torch.where(survive[..., None],
                                 weight / torch.clamp(prob, min=1e-30)[..., None],
                                 weight)
            alive = survive
        rd = inc
    finite = torch.isfinite(rad).all(-1)
    rad = torch.where(finite[..., None], rad, torch.zeros_like(rad))
    if clamp is not None:
        peak = rad.amax(-1)
        scale = torch.where(peak > clamp, clamp / torch.clamp(peak, min=1e-30),
                            torch.ones_like(peak))
        rad = rad * scale[..., None]
    return rad, first_hit, albedo, normal0, rd0


def render_pixels(scene: Scene, cam: dict, pixels, n_samples: int, seed: int,
                  width: int, height: int, bounces: int, clamp: float,
                  block: int = 1 << 18):
    """The image the program accumulates, at pixel ids [K]: the mean over
    samples 0 .. n_samples - 1 of (radiance, 1) where the camera ray hit
    (rgba), albedo, normal (the camera ray's reverse on a miss), and the
    count of samples that hit. Float64 sums of the float reference
    paths, lanes in blocks of `block` (pixel-major)."""
    k = pixels.shape[0]
    dev = scene.device
    sums = torch.zeros((k, 10), dtype=torch.float64, device=dev)
    hits = torch.zeros(k, dtype=torch.int64, device=dev)
    total = k * n_samples
    for s in range(0, total, block):
        lane = torch.arange(s, min(total, s + block), device=dev)
        pk, sk = lane // n_samples, lane % n_samples
        rad, hit, alb, nrm, rd = trace(scene, cam, pixels[pk], sk, seed,
                                       width, height, bounces, clamp)
        hf = hit[..., None]
        row = torch.cat([torch.where(hf, rad.to(alb.dtype), 0.0),
                         hit[..., None].to(alb.dtype),
                         torch.where(hf, alb, 0.0),
                         torch.where(hf, nrm, -rd)], -1).double()
        sums.index_add_(0, pk, row)
        hits.index_add_(0, pk, hit.long())
    return sums / n_samples, hits


def train_steps(scene: Scene, cam: dict, width: int, height: int, target,
                color, emission, seeds, lr: float, bounces: int,
                block: int = 1 << 16, n_pixels: int | None = None):
    """SGD steps (one a seed) of the mean squared pixel error of a
    one-sample render of every pixel (sample 0, not clamped) over the
    material colour and emission tables; `n_pixels`: of the first that
    many pixels only. Returns (losses, each step's gradients (colour,
    emission), the tables after each step)."""
    n = n_pixels or width * height
    losses, grads, tables = [], [], []
    dev = scene.device
    for seed in seeds:
        c = color.detach().clone().requires_grad_()
        e = emission.detach().clone().requires_grad_()
        total = torch.zeros((), dtype=torch.float64, device=dev)
        gc = torch.zeros_like(c)
        ge = torch.zeros_like(e)
        for s in range(0, n, block):
            pix = torch.arange(s, min(n, s + block), device=dev)
            rad = trace(scene, cam, pix, torch.zeros_like(pix), seed, width,
                        height, bounces, None, color=c, emission=e)[0]
            loss = ((rad - target[pix].to(rad.dtype)) ** 2).sum() / (3 * n)
            g1, g2 = torch.autograd.grad(loss, (c, e))
            total += loss.detach().double()
            gc += g1
            ge += g2
        grads.append((gc.detach(), ge.detach()))
        color = (color - lr * gc).detach()
        emission = (emission - lr * ge).detach()
        losses.append(float(total))
        tables.append((color, emission))
    return losses, grads, tables
