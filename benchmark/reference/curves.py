"""The plain reference path tracer over quads, lines and points: Yocto/GL's
`path` sampler as benchmark/reference/tracer.py traces it, with Yocto/GL
4.2's line and point primitives added, in plain PyTorch.

It imports nothing of the program, and of tracer.py only its quad scene,
BSDFs, camera and vector helpers (the PCG stream through pcg.py). The
quads go through tracer.Scene; the lines and points are swept exactly,
every element against every ray, in blocks of rays. A lane follows the
program's random stream, as tracer.trace does: the same draws a bounce
whatever the surface.

Yocto/GL 4.2 semantics (yocto_geometry.h, yocto_scene.cpp), as written
here:
- a line is a segment p0 p1 with radius r0 at p0 and r1 at p1;
  `intersect_line` solves for the closest approach of the ray to the
  segment's line (t on the ray, s on the line, clamped to [0, 1]) and
  hits where t is in [tmin, tmax] and the distance between the two
  closest points is at most r0 (1 - s) + r1 s; u = s;
- a point is a centre p with radius r; `intersect_point` takes the
  ray's closest approach to p and hits where t is in [tmin, tmax] and the
  distance is at most r: a disc that faces the ray;
- the hit's position is the point on the line's axis at s, or the point's
  centre; a line's normal is its tangent, p1 - p0 normalised, and its
  shading normal the outgoing direction orthonormalised against it; a
  point's shading normal is the outgoing direction;
- the closest of all elements is the hit.
Departures from Yocto/GL: Yocto's BVH takes, of two elements at the same
t, whichever it meets last; here a quad wins over a line and a line over
a point at equal t, and of two lines or two points the lower index, the
order in which the program merges them. Yocto interpolates a line's
tangent from per-vertex normals where the shape has them; the scenes here
have none. The ray's next origin is the hit's position with tmin RAY_EPS,
as tracer.py's quads leave theirs.

Every float runs in `dtype`: float32 is the reference, bfloat16 the
control (benchmark/control_curves.py).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pcg, tracer
from benchmark.reference.tracer import RAY_EPS, dot, normalize

# (ray, element) pairs a block of the sweep tests at once
BLOCK_PAIRS = 1 << 23
QUAD, LINE, POINT = 0, 1, 2


def _closest(test, n_elem: int, n: int, dev):
    """(index [n], t [n]) of the first minimum of t over the elements that
    `test(rays, lo, hi)` hits ((hit, t) each [rays, hi - lo]), in blocks of
    rays; t is +inf and the index 0 where none hits."""
    idx = torch.zeros(n, dtype=torch.int64, device=dev)
    best = torch.full((n,), float("inf"), device=dev)
    if n_elem == 0:
        return idx, best
    rows = max(1, BLOCK_PAIRS // n_elem)
    for s in range(0, n, rows):
        r = torch.arange(s, min(n, s + rows), device=dev)
        h, t = test(r)
        t = torch.where(h, t.float(), float("inf"))
        best[r], idx[r] = torch.min(t, dim=1)
    return idx, best


class Scene:
    """The quads of a scene description (tracer.Scene) with its lines and
    points in world space, on `device`, floats in `dtype`."""

    def __init__(self, desc: dict, device, dtype=torch.float32):
        shapes = desc["shapes"]
        quads = [i for i in desc["instances"] if "quads" in shapes[i["shape"]]]
        self.quads = tracer.Scene(dict(desc, instances=quads), device, dtype)
        self.device, self.dtype = self.quads.device, dtype
        lp, lr, lm, pp, pr, pm = [], [], [], [], [], []
        for inst in desc["instances"]:
            shp = shapes[inst["shape"]]
            f = np.asarray(inst["frame"], np.float32)
            pos = np.asarray(shp["positions"], np.float32) @ f[:3] + f[3]
            scale = float(np.linalg.norm(f[:3], axis=1).mean())
            rad = np.asarray(shp.get("radius", []), np.float32) * scale
            if "lines" in shp:
                ln = np.asarray(shp["lines"]).reshape(-1, 2)
                lp.append(pos[ln])
                lr.append(rad[ln])
                lm.append(np.full(len(ln), inst["material"]))
            if "points" in shp:
                pt = np.asarray(shp["points"]).reshape(-1)
                pp.append(pos[pt])
                pr.append(rad[pt])
                pm.append(np.full(len(pt), inst["material"]))

        def put(parts, shape, dt):
            a = np.concatenate(parts) if parts else np.zeros(shape)
            return torch.from_numpy(np.asarray(a)).to(self.device).to(dt)

        self.line_p = put(lp, (0, 2, 3), dtype)  # [L, 2, 3]
        self.line_r = put(lr, (0, 2), dtype)  # [L, 2]
        self.line_mat = put(lm, (0,), torch.int64)
        self.point_p = put(pp, (0, 3), dtype)  # [P, 3]
        self.point_r = put(pr, (0,), dtype)
        self.point_mat = put(pm, (0,), torch.int64)

    # ---- the element tests (Yocto/GL's intersect_line, intersect_point) --

    @staticmethod
    def line_test(ro, rd, tmin, tmax, p0, p1, r0, r1):
        """(hit, s, t) of rays [..., 3] against segments [..., 3]."""
        v = p1 - p0
        w = ro - p0
        a, b, c = dot(rd, rd), dot(rd, v), dot(v, v)
        d, e = dot(rd, w), dot(v, w)
        det = a * c - b * b
        safe = torch.where(det == 0, torch.ones_like(det), det)
        t = (b * e - c * d) / safe
        s = ((a * e - b * d) / safe).clamp(0.0, 1.0)
        prl = (ro + rd * t[..., None]) - (p0 + v * s[..., None])
        r = r0 * (1 - s) + r1 * s
        hit = (det != 0) & (t >= tmin) & (t <= tmax) & (dot(prl, prl) <= r * r)
        return hit, s, t

    @staticmethod
    def point_test(ro, rd, tmin, tmax, p, r):
        """(hit, t) of rays [..., 3] against points [..., 3]."""
        t = dot(p - ro, rd) / dot(rd, rd)
        q = p - (ro + rd * t[..., None])
        return (t >= tmin) & (t <= tmax) & (dot(q, q) <= r * r), t

    # ---- closest hit ------------------------------------------------------

    def intersect(self, ro, rd, tmax):
        """Closest hit of rays [N, 3] with tmin RAY_EPS and tmax [N]:
        (hit, kind (QUAD, LINE or POINT), index among its kind, u, v,
        t)."""
        n, dev = ro.shape[0], self.device
        hq, quad, u, v, t = self.quads.intersect(ro, rd, tmax)
        tq = torch.where(hq, t, tmax)
        lp, lr = self.line_p, self.line_r

        def lines(r):
            return self.line_test(ro[r, None], rd[r, None], RAY_EPS,
                                  tq[r, None], lp[None, :, 0], lp[None, :, 1],
                                  lr[None, :, 0], lr[None, :, 1])[::2]

        li, lt = _closest(lines, lp.shape[0], n, dev)
        is_line = lt < tq.float()
        tl = torch.where(is_line, lt.to(tq.dtype), tq)

        def points(r):
            return self.point_test(ro[r, None], rd[r, None], RAY_EPS,
                                   tl[r, None], self.point_p[None],
                                   self.point_r[None])

        pi, pt = _closest(points, self.point_p.shape[0], n, dev)
        is_point = pt < tl.float()
        kind = torch.where(is_point, POINT,
                           torch.where(is_line, LINE, QUAD))
        if lp.shape[0]:
            # the winning line's s, by its own test
            p = lp[li]
            _, s, _ = self.line_test(ro, rd, RAY_EPS, tq, p[:, 0], p[:, 1],
                                     lr[li, 0], lr[li, 1])
            u = torch.where(is_line, s, u)
        t = torch.where(is_point, pt.to(tl.dtype), tl)
        idx = torch.where(is_point, pi, torch.where(is_line, li, quad))
        return hq | is_line | is_point, kind, idx, u, v, t

    def surface(self, kind, idx, u, v, rd):
        """(position, shading normal facing -rd, material) of hits."""
        o = -rd
        p = self.quads.verts[torch.where(kind == QUAD, idx, 0)]
        pos = tracer.quad_point(p, u, v)
        gn = tracer.quad_normal(p)
        nrm = torch.where((dot(gn, o) >= 0)[..., None], gn, -gn)
        mat = self.quads.qmat[torch.where(kind == QUAD, idx, 0)]
        if self.line_p.shape[0]:
            li = torch.where(kind == LINE, idx, 0)
            p0, p1 = self.line_p[li, 0], self.line_p[li, 1]
            tan = normalize(p1 - p0)
            on = (kind == LINE)[..., None]
            pos = torch.where(on, p0 + (p1 - p0) * u[..., None], pos)
            nrm = torch.where(on, normalize(o - tan * dot(o, tan)[..., None]),
                              nrm)
            mat = torch.where(kind == LINE, self.line_mat[li], mat)
        if self.point_p.shape[0]:
            pi = torch.where(kind == POINT, idx, 0)
            on = (kind == POINT)[..., None]
            pos = torch.where(on, self.point_p[pi], pos)
            nrm = torch.where(on, o, nrm)
            mat = torch.where(kind == POINT, self.point_mat[pi], mat)
        return pos, nrm, mat


def trace(scene: Scene, cam: dict, pixel, sample, seed: int, width: int,
          height: int, bounces: int = 8, clamp: float | None = 10.0):
    """tracer.trace over quads, lines and points: one path for each lane
    of pixel ids [N] and sample ids [N] -> (radiance [N, 3], hit [N],
    albedo [N, 3], normal [N, 3], rd)."""
    q = scene.quads
    dt, dev = scene.dtype, scene.device
    rng = pcg.seed_state(pixel, sample, seed)
    puv, rng = pcg.rand2f(rng)
    _, rng = pcg.rand2f(rng)  # lens sample
    ro, rd = tracer.camera_rays(cam, pixel, width, height, puv, dt, dev)
    rd0 = rd
    n = pixel.shape[0]
    fmax = torch.full((n,), torch.finfo(dt).max, dtype=dt, device=dev)
    hit, kind, idx, u, v, t = scene.intersect(ro, rd, fmax)
    rad = torch.zeros((n, 3), dtype=q.color.dtype, device=dev)
    weight = torch.ones((n, 3), dtype=q.color.dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    first_hit = torch.zeros(n, dtype=torch.bool, device=dev)
    albedo = torch.zeros((n, 3), dtype=dt, device=dev)
    normal0 = torch.zeros((n, 3), dtype=dt, device=dev)

    def rand(state):
        x, state = pcg.rand1f(state)
        return x.to(dt), state

    for b in range(bounces + 1):
        alive = alive & hit
        o = -rd
        pos, nrm, m = scene.surface(kind, idx, u, v, rd)
        mtype, rough, ior = q.mtype[m], q.rough[m].to(dt), q.ior[m].to(dt)
        col = q.color[m]
        if b == 0:
            first_hit = alive.clone()
            albedo = torch.where(alive[..., None], col.to(dt), albedo)
            normal0 = torch.where(alive[..., None], nrm, normal0)
        rad = rad + torch.where(alive[..., None], weight * q.emission[m],
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
        i_bsdf = tracer.bsdf_sample(mtype, rough, ior, nrm, o, rnl, rn)
        i_light = q.sample_light(pos, r_pick, r_el, torch.stack([ru0, ru1], -1))
        inc = torch.where((r_half < 0.5)[..., None], i_bsdf, i_light)
        alive = alive & (inc.abs().sum(-1) != 0)
        tmax = torch.where(alive, fmax, torch.full_like(fmax, -1.0))
        hit, kind, idx, u, v, t = scene.intersect(pos, inc, tmax)
        pdf = (0.5 * tracer.bsdf_pdf(mtype, rough, ior, nrm, o, inc)
               + 0.5 * q.light_pdf(pos, inc))
        f = tracer.bsdf_eval(mtype, col.to(dt), rough, ior, nrm, o,
                             inc).to(weight.dtype)
        w = f / torch.clamp(pdf, min=1e-30).to(weight.dtype)[..., None]
        weight = torch.where(alive[..., None], weight * w, weight)
        bad = (weight.abs().sum(-1) == 0) | ~torch.isfinite(weight).all(-1)
        alive = alive & ~bad
        r_rr, rng = rand(rng)
        if b > 3:
            prob = weight.amax(-1).clamp(max=0.99)
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
                  block: int = 1 << 16):
    """tracer.render_pixels over quads, lines and points: the mean over
    samples 0 .. n_samples - 1 at pixel ids [K] of (rgba, albedo, normal)
    and the count of samples whose camera ray hit."""
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
