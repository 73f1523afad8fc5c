"""Build-time choice of the bounce-ray intersector of a heavy scene:
worklist or regroup, per scene (port of julia_raytracer_tpu/utils/
kernel_select.py).

Method (the JAX package's): sample divergent bounce-like rays (uniform
surface points, uniform-sphere directions), count both intersectors'
cluster passes exactly with the cull's own slab test, in 128-ray rows as
the TPU kernels test them, turn the counts into predicted times with
per-unit costs, and take regroup only on a decisive predicted win
(ratio < RATIO_THRESHOLD). The counts equal the JAX package's for the
same rays (tests/test_torch_kernel_select.py).

One change to the method: the renderer's decision (select_bounce_kernel)
counts the sampled rays in the order the wavefront sort dispatches them
(integrator._sort_key over the quads' bounds), because the renderer sorts
every scene that this selection runs on (SORT_MIN_PRIMS 50,000 <
REGROUP_MIN_PRIMS 150,000). Counted as sampled, the rays cost the
worklist 5x the passes per ray that the sorted bounce rays of
testing.heavy_scene() do, and the prediction (0.263 on the H100 costs
below) sat far from the measured dispatch ratio (0.84); PERF.md section 6.
predict_ratio counts them as sampled unless asked, as the JAX package
does.

The per-unit costs are a SelectCosts. The JAX package's were measured on
a TPU v5e and none of them is used here: H100_COSTS were fitted by
chip_smoke.py (phase regroup_vs_worklist) from the stage times of both
intersectors on 262,144 bounce rays of testing.heavy_scene() and the
same pass, pair and ray counts. RATIO_THRESHOLD is the JAX package's
decision rule, a ratio and not a time.

Disk cache (utils/diskcache.py), as the JAX package's: the decision is
the product "kernel_select" under a key that also covers the costs
(select_cache_key), so a refit of the costs never reuses an old
decision; the counting rays' cluster boxes come from the product
"clusters" (ops/cluster_tables.py load_cluster_tables).
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops.cluster_tables import load_cluster_tables
from julia_raytracer_tpu_torch.utils import diskcache


class SelectCosts(NamedTuple):
    """Per-unit costs of the two intersectors' bounce dispatch."""

    us_wl_pass: float  # worklist, per (128-ray row, cluster) pass
    us_rg_pass: float  # regroup tri-test, per (128-slot row, cluster) pass
    us_rg_pair: float  # regroup pack + unpack, per live (tile, super) pair
    us_rg_ray: float  # regroup count + merge, per ray
    ms_rg_fixed: float  # regroup, per dispatch


# fitted by chip_smoke.py (phase regroup_vs_worklist) on an NVIDIA H100
# 80GB HBM3, power limit 700.00 W, from testing.heavy_scene()'s 262,144
# sorted bounce rays: every term from device time (torch.profiler), the
# stages' and the two whole calls', the whole regroup call's remainder as
# the fixed cost; with the warp-walk worklist and tri-test kernels (the
# tri-test's pass cost fell 9.6x from 0.03353 with the block-walk
# kernel); 4 significant digits
H100_COSTS = SelectCosts(
    us_wl_pass=0.01051, us_rg_pass=0.003500, us_rg_pair=0.01744,
    us_rg_ray=0.02000, ms_rg_fixed=0.08695,
)
RATIO_THRESHOLD = 0.35

LANES = 128
SUP = 128
TILE = 1024
# slab tests per step of the pass counter: bounds its [k, 128, C]
# temporaries (the count does not depend on it)
ROW_STEP_ELEMS = 1 << 26


def bounce_rays(prim_verts: np.ndarray, n_rays: int, seed: int = 11):
    """Surface-sampled divergent rays, as the JAX package samples them."""
    rng = np.random.default_rng(seed)
    q = len(prim_verts)
    pi = rng.integers(0, q, n_rays)
    pv = prim_verts[pi]
    u = rng.random((n_rays, 1), dtype=np.float32)
    v = rng.random((n_rays, 1), dtype=np.float32)
    p = ((1 - u) * (1 - v) * pv[:, 0] + u * (1 - v) * pv[:, 1]
         + u * v * pv[:, 2] + (1 - u) * v * pv[:, 3]).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-20
    ext = float(
        prim_verts.reshape(-1, 3).max() - prim_verts.reshape(-1, 3).min()
    )
    tmin = np.full(n_rays, 1e-4 * max(ext, 1.0), np.float32)
    tmax = np.full(n_rays, 3.0e38, np.float32)
    return p, d, tmin, tmax


def _super_bbox(cbbox: np.ndarray, sup: int = SUP):
    """Cluster boxes [C, 6] -> (boxes padded with the last one to whole
    superclusters, supercluster boxes [S, 6], S)."""
    c = len(cbbox)
    s_count = -(-c // sup)
    pad = s_count * sup - c
    cb = (np.concatenate([cbbox, np.tile(cbbox[-1:], (pad, 1))])
          if pad else cbbox)
    sb = np.concatenate(
        [cb.reshape(s_count, sup, 6)[:, :, 0:3].min(1),
         cb.reshape(s_count, sup, 6)[:, :, 3:6].max(1)], axis=1)
    return cb, sb, s_count


def _row_passes_device(o, d, tmin, tmax, device, cb_rows=None,
                       cb_shared=None) -> int:
    """Pass counter on `device`: rays in fixed 128-lane rows, each row
    tested against its cluster boxes, per row (cb_rows [n_rows, C, 6]) or
    one shared set (cb_shared [C, 6]). passes = the (row, cluster) pairs
    where any lane's slab test passes."""
    n_rows = len(o) // LANES
    c = cb_rows.shape[1] if cb_rows is not None else cb_shared.shape[0]

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    o_r = put(o).view(n_rows, LANES, 3)
    d_r = put(d).view(n_rows, LANES, 3)
    tn_r = put(tmin).view(n_rows, LANES)
    tx_r = put(tmax).view(n_rows, LANES)
    boxes = put(cb_rows if cb_rows is not None else cb_shared[None])
    k = max(1, min(n_rows, ROW_STEP_ELEMS // max(c * LANES, 1)))
    total = 0
    for r0 in range(0, n_rows, k):
        sl = slice(r0, r0 + k)
        bb = boxes[sl] if cb_rows is not None else boxes
        enter = exit_ = None
        for ax in range(3):
            dc = d_r[sl, :, ax]
            di = (1.0 / torch.where(dc == 0, 1e-30, dc))[:, :, None]
            oc = o_r[sl, :, ax][:, :, None]
            t0 = (bb[:, None, :, ax] - oc) * di
            t1 = (bb[:, None, :, 3 + ax] - oc) * di
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            enter = lo if enter is None else torch.maximum(enter, lo)
            exit_ = hi if exit_ is None else torch.minimum(exit_, hi)
        enter = torch.maximum(enter, tn_r[sl][:, :, None])
        exit_ = torch.minimum(exit_, tx_r[sl][:, :, None])
        hit = enter <= exit_ * np.float32(1.00000024)  # [k, 128, C]
        total += int(hit.any(dim=1).sum())
    return total


def count_passes(o, d, tmin, tmax, cbbox, device="cpu") -> dict:
    """Both intersectors' pass counts for rays o/d/tmin/tmax (numpy, a
    multiple of 128 rays; dead rays at tmax < 0) against cluster boxes
    cbbox [C, 6]: n_super, passes_wl (rows in dispatch order against all
    clusters), passes_rg (rows of rays packed per supercluster, stable,
    against their super's clusters), pairs (live (1024-ray tile, super)
    pairs) and rows_rg."""
    n_rays = len(o)
    cb, sb, n_super = _super_bbox(cbbox)

    # super bits on the host (small: [rays, S])
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        di = 1.0 / np.where(d == 0, 1e-30, d)
        enter = exit_ = None
        for ax in range(3):
            t0 = (sb[None, :, ax] - o[:, None, ax]) * di[:, None, ax]
            t1 = (sb[None, :, 3 + ax] - o[:, None, ax]) * di[:, None, ax]
            lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
            enter = lo if enter is None else np.maximum(enter, lo)
            exit_ = hi if exit_ is None else np.minimum(exit_, hi)
        enter = np.maximum(enter, tmin[:, None])
        exit_ = np.minimum(exit_, tmax[:, None])
        bits = enter <= exit_ * np.float32(1.00000024)  # [rays, S]

    n_tiles = -(-n_rays // TILE)
    bt = np.zeros((n_tiles * TILE, n_super), bool)
    bt[:n_rays] = bits
    pairs = int((bt.reshape(n_tiles, TILE, n_super).sum(axis=1) > 0).sum())

    passes_wl = _row_passes_device(o, d, tmin, tmax, device, cb_shared=cb)

    # regroup: rays packed per super (stable), rows of 128, each row
    # against its super's 128 clusters; pad lanes repeat the segment's last
    # ray (any() absorbs the duplicate)
    ray_idx, sup_idx = np.nonzero(bits)  # sorted by ray
    order = np.argsort(sup_idx, kind="stable")
    ray_p, sup_p = ray_idx[order], sup_idx[order]
    seg_rows, row_sup, start = [], [], 0
    counts = np.bincount(sup_p, minlength=n_super)
    for s in range(n_super):
        c = int(counts[s])
        if c == 0:
            continue
        seg = ray_p[start:start + c]
        start += c
        nr = -(-c // LANES)
        seg = np.concatenate([seg, np.full(nr * LANES - c, seg[-1], seg.dtype)])
        seg_rows.append(seg.reshape(nr, LANES))
        row_sup.extend([s] * nr)
    if seg_rows:
        rows_idx = np.concatenate(seg_rows, axis=0)  # [R, 128]
        flat = rows_idx.reshape(-1)
        cb_rows = cb.reshape(n_super, SUP, 6)[np.asarray(row_sup)]
        passes_rg = _row_passes_device(o[flat], d[flat], tmin[flat],
                                       tmax[flat], device, cb_rows=cb_rows)
        rows_rg = len(rows_idx)
    else:
        passes_rg = rows_rg = 0
    return dict(n_super=n_super, passes_wl=passes_wl, passes_rg=passes_rg,
                pairs=pairs, rows_rg=rows_rg)


def wavefront_order(verts_np, o, d):
    """The permutation the renderer's wavefront sort gives rays o/d
    (numpy) in a scene of quads verts_np: a stable argsort of its key over
    the quads' bounds."""
    # imported here: the integrator imports this module
    from julia_raytracer_tpu_torch.render.integrator import _sort_key
    pv = torch.as_tensor(np.asarray(verts_np, np.float32).reshape(-1, 3))
    key = _sort_key(torch.from_numpy(o), torch.from_numpy(d),
                    pv.amin(dim=0), pv.amax(dim=0))
    return torch.argsort(key, stable=True).numpy()


def bounce_counts(verts_np, inst_np, n_rays: int = 65536, seed: int = 11,
                  device="cpu", sort_rays: bool = False,
                  cache_key: str = "") -> dict:
    """count_passes of `n_rays` synthetic bounce rays (bounce_rays) over
    the scene's cluster boxes (through the disk cache under `cache_key`),
    on `device`; with `sort_rays`, in the wavefront sort's order."""
    _, _, bbox, n_clusters = load_cluster_tables(
        np.asarray(verts_np, np.float64), inst_np, cache_key)
    o, d, tmin, tmax = bounce_rays(verts_np, n_rays, seed)
    if sort_rays:
        order = wavefront_order(verts_np, o, d)
        o, d, tmin, tmax = (x[order] for x in (o, d, tmin, tmax))
    return dict(n_rays=n_rays,
                **count_passes(o, d, tmin, tmax, bbox[:n_clusters, 0:6], device))


def ratio_from_counts(st: dict, costs: SelectCosts = H100_COSTS) -> dict:
    """Predicted times and t_regroup / t_worklist from bounce_counts."""
    t_wl = st["passes_wl"] * costs.us_wl_pass * 1e-3
    t_rg = (st["passes_rg"] * costs.us_rg_pass * 1e-3
            + st["pairs"] * costs.us_rg_pair * 1e-3
            + st["n_rays"] * costs.us_rg_ray * 1e-3
            + costs.ms_rg_fixed)
    return dict(st, t_wl_ms=round(t_wl, 1), t_rg_ms=round(t_rg, 1),
                ratio=round(t_rg / max(t_wl, 1e-9), 3))


def predict_ratio(verts_np, inst_np, n_rays: int = 65536, seed: int = 11,
                  costs: SelectCosts = H100_COSTS, device="cpu",
                  sort_rays: bool = False, cache_key: str = "") -> dict:
    """Predicted t_regroup / t_worklist for one synthetic bounce dispatch
    of `n_rays` rays, the pass counts on `device` (bounce_counts)."""
    return ratio_from_counts(
        bounce_counts(verts_np, inst_np, n_rays, seed, device, sort_rays,
                      cache_key),
        costs)


def decide(st: dict) -> dict:
    """kernel_select's rule on a predicted ratio: regroup only on a
    decisive win."""
    kernel = "regroup" if st["ratio"] < RATIO_THRESHOLD else "worklist"
    return dict(st, kernel=kernel, threshold=RATIO_THRESHOLD)


def select_cache_key(cache_key: str, costs: SelectCosts = H100_COSTS) -> str:
    """The decision's disk-cache key: the scene's key and the costs ("" when
    the scene has no key: nothing is cached)."""
    if not cache_key:
        return ""
    token = repr(tuple(costs)) + repr(RATIO_THRESHOLD)
    return f"{cache_key}-{hashlib.sha1(token.encode()).hexdigest()[:10]}"


def select_bounce_kernel(verts_np, inst_np, costs: SelectCosts = H100_COSTS,
                         device="cpu", cache_key: str = "") -> dict:
    """{"kernel": "regroup" | "worklist", "ratio", "threshold", ...}: regroup
    only on a decisive predicted win, the rays counted in the wavefront
    sort's order. Disk-cached under select_cache_key(cache_key, costs),
    reused only for the same prim count."""
    key = select_cache_key(cache_key, costs)
    q = len(verts_np)
    cached = diskcache.load_arrays(key, "kernel_select")
    if cached is not None and "payload" in cached and int(
            cached.get("q", -1)) == q:
        return json.loads(bytes(cached["payload"]).decode())
    t0 = time.time()
    st = predict_ratio(verts_np, inst_np, costs=costs, device=device,
                       sort_rays=True, cache_key=cache_key)
    st["probe_s"] = round(time.time() - t0, 1)
    st = decide(st)
    diskcache.save_arrays(key, "kernel_select", dict(
        payload=np.frombuffer(json.dumps(st).encode(), dtype=np.uint8), q=q))
    return st
