"""The plain reference path tracer for scenes of many emissive quads:
benchmark/reference/tracer.py with its light pdf computed in blocks, and
its lights' quads listed for sampling in an order the caller gives.

The pdf. tracer.Scene.light_pdf loops in Python over every emissive
quad, a few launches a quad, which is out of reach at tens of thousands
of emissive quads and ~10^5 paths of 9 bounces. Scene.light_pdf here
returns the same sum: Yocto/GL's occluder-free light pdf, t^2 / (|cos| x
the owning light's area) over every emissive quad that the direction
crosses, each quad as its two triangles (p1, p2, p4) and (p3, p4, p2), a
crossing counted at t >= RAY_EPS, over the number of lights. It works
light by light in blocks of rays: a light's quads are tested only for
the rays that enter that light's bounding box, and of those only in the
runs of CHUNK consecutive quads whose box the ray enters; the boxes are
widened as tracer.py's are, so the cull drops no crossing. The sum adds
in another order than the loop's.

Departure from the program, by design: the program's light pdf above
its exact-sweep limit is a truncated march, the bounce's own hit and a
budget of further closest hits along the direction (8 with more than
four lights), each adding the light it meets; it counts the emitter
surfaces among the first 9 surfaces the direction meets, occluders
included. This reference counts every emitter surface the direction
crosses, however many surfaces lie before it. Where the march's budget
runs out, the program's pdf is the lower.

The order. A light sample picks a light, then one of its quads by
inverting the cumulative sum of their areas: which quad a random number
takes depends on the order in which the light's quads are listed.
Yocto/GL lists a shape's quads in shape order, and so does tracer.Scene;
the program lists them in the order of its BVH. To follow the program's
paths, `light_order` gives, for each light, its quads' centroids in the
order to list them (the program's light table, read by the mode). Each
is matched to the nearest of the light's own quads, and the matches must
be a permutation of them, each within 1e-4 of the light's extent, or the
Scene refuses; the areas, sums and corners are the reference's own.
Without `light_order`, shape order.

It imports nothing of the program, and of tracer.py its quad scene,
intersector, BSDFs and paths (the PCG stream through pcg.py). Every
float of the pdf runs in `dtype` (the culls in float32, as tracer.py's
intersector culls): float32 is the reference, bfloat16 the control
(benchmark/control_lights.py). The areas and their sums are float64 of
the float32 corners, as tracer.py's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import tracer
from benchmark.reference.tracer import (
    CHUNK, FMAX, RAY_EPS, _boxes, _slab, cross, dot, moller, quad_point,
    normalize, tri_normal,
)

# (ray, chunk) box tests and (ray, quad) pairs a step of the pdf makes
BLOCK_TESTS = 1 << 22
# a given centroid matches a quad within this share of its light's extent
MATCH_TOL = 1e-4


def emissive_quads(desc: dict) -> np.ndarray:
    """World corners [E, 4, 3] float32 of the quads of every instance
    whose material emits, in instance and shape order, as tracer.Scene
    lists its lights' quads."""
    out = []
    for inst in desc["instances"]:
        if not np.abs(desc["materials"][inst["material"]]["emission"]).sum():
            continue
        shp = desc["shapes"][inst["shape"]]
        w = np.asarray(shp["positions"])[np.asarray(shp["quads"]).reshape(-1)]
        f = np.asarray(inst["frame"], np.float32)
        out.append((w.reshape(-1, 4, 3) @ f[:3] + f[3]).astype(np.float32))
    return np.concatenate(out) if out else np.zeros((0, 4, 3), np.float32)


class Scene(tracer.Scene):
    """tracer.Scene with the light pdf in blocks and the lights' quads
    listed in `light_order` (module docstring)."""

    def __init__(self, desc: dict, device, dtype=torch.float32,
                 light_order=None):
        super().__init__(desc, device, dtype)
        v32 = torch.from_numpy(emissive_quads(desc)).to(self.device)
        lv = v32.double()
        area = (0.5 * cross(lv[:, 1] - lv[:, 0], lv[:, 3] - lv[:, 0]).norm(dim=-1)
                + 0.5 * cross(lv[:, 1] - lv[:, 2], lv[:, 3] - lv[:, 2]).norm(dim=-1))
        # per light: its quads' rows of light_verts in shape order, with
        # its box and its chunks' boxes; the rows in sampling order and the
        # sums of their areas
        self.light_rows, self.light_box, self.light_chunks = [], [], []
        self.light_pick, self.light_cdf = [], []
        for k in range(self.n_lights):
            rows = torch.nonzero(self.light_owner == k)[:, 0]
            self.light_rows.append(rows)
            self.light_box.append(_boxes(v32[rows], rows.numel())[0])
            self.light_chunks.append(_boxes(v32[rows], CHUNK))
            if light_order is not None:
                rows = rows[self._match(v32[rows], light_order[k])]
            self.light_pick.append(rows)
            self.light_cdf.append(torch.cumsum(area[rows], 0).float())

    def _match(self, quads, centroids) -> torch.Tensor:
        """Indices into `quads` [m, 4, 3] of the nearest quad to each of
        `centroids` [m, 3]; raises unless they are a permutation within
        MATCH_TOL of the quads' extent."""
        own = quads.double().mean(1)
        want = torch.as_tensor(np.asarray(centroids), dtype=torch.float64,
                               device=self.device)
        if want.shape != own.shape:
            raise ValueError(f"light_order lists {tuple(want.shape)} "
                             f"centroids for a light of {own.shape[0]} quads")
        tol = MATCH_TOL * float((own.amax(0) - own.amin(0)).max())
        idx = torch.empty(own.shape[0], dtype=torch.int64, device=self.device)
        dist = torch.empty(own.shape[0], dtype=torch.float64, device=self.device)
        step = max(1, (1 << 22) // own.shape[0])
        for s in range(0, own.shape[0], step):
            d, i = torch.cdist(want[s:s + step], own).min(1)
            idx[s:s + step], dist[s:s + step] = i, d
        if float(dist.max()) > tol or torch.unique(idx).numel() != idx.numel():
            raise ValueError("light_order does not list the light's own quads")
        return idx

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
            idx = self.light_pick[k][idx.clamp(max=cdf.numel() - 1)]
            el = torch.where(lid == k, idx, el)
        lpos = quad_point(self.light_verts[el], ruv[..., 0], ruv[..., 1])
        return normalize(lpos - pos)

    def light_pdf(self, pos, d):
        """Solid-angle pdf of d under light sampling (no occlusion), the
        sum of tracer.Scene.light_pdf in blocks."""
        n = pos.shape[0]
        dev = self.device
        pdf = torch.zeros(n, dtype=self.dtype, device=dev)
        r32, d32 = pos.float(), d.float()
        inv = 1.0 / torch.where(d32 == 0, torch.full_like(d32, 1e-30), d32)
        tm = torch.full((n,), FMAX, device=dev)
        lane = torch.arange(CHUNK, device=dev)
        for k in range(self.n_lights):
            rows, chunks = self.light_rows[k], self.light_chunks[k]
            ray = torch.nonzero(_slab(r32, inv, self.light_box[k], tm))[:, 0]
            step = max(1, BLOCK_TESTS // chunks.shape[0])
            for s in range(0, ray.numel(), step):
                r = ray[s:s + step]
                near = _slab(r32[r, None], inv[r, None], chunks[None],
                             tm[r, None])
                pr, pc = torch.nonzero(near, as_tuple=True)
                q = pc[:, None] * CHUNK + lane  # [pairs, CHUNK]
                real = q < rows.numel()
                pr = r[pr][:, None].expand_as(q)[real]
                q = rows[q[real]]
                for p0 in range(0, q.numel(), BLOCK_TESTS):
                    pp, qq = pr[p0:p0 + BLOCK_TESTS], q[p0:p0 + BLOCK_TESTS]
                    pdf.index_add_(0, pp, self._quad_pdf(pos[pp], d[pp], qq))
        return pdf / self.n_lights

    def _quad_pdf(self, pos, d, q):
        """Each (ray, emissive quad) pair's term of the pdf: both
        triangles, as tracer.Scene.light_pdf adds them."""
        p1, p2, p3, p4 = self.light_verts[q].unbind(1)
        area = self.light_owner_area[q]
        out = torch.zeros(q.shape, dtype=self.dtype, device=self.device)
        for a, b, c in ((p1, p2, p4), (p3, p4, p2)):
            ok, _, _, t = moller(pos, d, a, b, c)
            ok = ok & (t >= RAY_EPS)
            cos = dot(tri_normal(a, b, c), d).abs()
            val = t * t / torch.clamp(cos * area, min=1e-30)
            out = out + torch.where(ok, val, torch.zeros_like(val))
        return out
