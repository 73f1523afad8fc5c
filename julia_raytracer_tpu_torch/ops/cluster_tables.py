"""Cluster tables of the cluster intersectors (host side, numpy): a copy
of the table build of julia_raytracer_tpu/ops/pallas_cluster.py
(`_tri_transforms_batch`, `_tn`, `build_cluster_tables`, `_wl_super_bbox`
and their constants), its chunked float64 numpy path only.

Primitives in BVH leaf order are cut into clusters of 64 quads (128
triangles). Each triangle carries a 3x4 affine transform from world space
to its unit-triangle frame (rows m_u, m_v, n_hat, then the translations
t_u t_v t_w), so a ray hits it where

    t = -o'_z / d'_z,  u = o'_x + t d'_x,  v = o'_y + t d'_y,

with o' = A [o, 1] and d' = A [d, 0]. Quad i gives triangles (p1, p2, p4)
and (p3, p4, p2); degenerate triangles and the padding of the last
cluster get the never-hit transform (all zero but t_w = 1, so d'_z = 0).
Fully padded cluster boxes sit at min = max = +3e38, which no ray enters.

build_cluster_tables takes the C++/OpenMP builder of ops/native.py first
(the same math; within 2e-6 of this path, boxes exact), this numpy path
when that is not in use. load_cluster_tables reads and writes the tables
of scenes above utils/diskcache.CACHE_MIN_PRIMS prims in the disk cache
(product "clusters"), as the JAX package's `_load_tables`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from julia_raytracer_tpu_torch.ops import native
from julia_raytracer_tpu_torch.utils import diskcache

PRIMS_PER_CLUSTER = 64  # -> 128 triangles per cluster
TRIS = 2 * PRIMS_PER_CLUSTER
WL_SUPER = 128  # clusters per supercluster in the worklist intersector
NOHIT = np.float32(3e38)  # never-entered box sentinel


def _cross(a, b):
    out = np.empty_like(a)
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    out[:, 0] = a1 * b2 - a2 * b1
    out[:, 1] = a2 * b0 - a0 * b2
    out[:, 2] = a0 * b1 - a1 * b0
    return out


def _tri_transforms_batch(a, b, c):
    """a/b/c [T, 3] float64 triangle corners -> ([T, 12] rows (m_u 3,
    m_v 3, n_hat 3, t_u t_v t_w), ok [T]). Degenerate rows become the
    never-hit transform. The w row is the unit normal (signed plane
    distance), which conditions t = -o'_w / d'_w for thin triangles."""
    t_count = len(a)
    e1 = b - a
    e2 = c - a
    n = _cross(e1, e2)
    det = np.einsum("ij,ij->i", n, n)
    ok = (det > 0) & np.isfinite(det)
    safe_det = np.where(ok, det, 1.0)
    nhat = n / np.sqrt(safe_det)[:, None]

    # inverse of E = [e1 | e2 | n] via adjugate: rows of E^-1 are
    # (e2 x n, n x e1, e1 x e2) / det(E); det(E) = n.(e1 x e2) = |n|^2
    m0 = _cross(e2, n) / safe_det[:, None]
    m1 = _cross(n, e1) / safe_det[:, None]

    out = np.zeros((t_count, 12))
    out[:, 0:3] = m0
    out[:, 3:6] = m1
    out[:, 6:9] = nhat
    out[:, 9] = -np.einsum("ij,ij->i", m0, a)
    out[:, 10] = -np.einsum("ij,ij->i", m1, a)
    out[:, 11] = -np.einsum("ij,ij->i", nhat, a)
    never = np.zeros(12)
    never[11] = 1.0
    out[~ok] = never
    return out, ok


def _tn(a_, b_, c_):
    nn = _cross(b_ - a_, c_ - a_)
    l = np.sqrt(np.einsum("ij,ij->i", nn, nn))[:, None]
    return nn / np.where(l > 0, l, 1.0)


def build_cluster_tables(prim_verts: np.ndarray, prim_instance=None):
    """prim_verts [Q, 4, 3] (BVH order) -> (tfm [C, 12, 128], nrm
    [C, 4, 128], bbox [C, 8], n_clusters), all float32. Rows 0-2 of nrm
    are the quad's element normal, row 3 the owning instance id (as
    float32). Built in cluster-aligned float64 chunks on a few threads."""
    q = len(prim_verts)
    c = max(1, -(-q // PRIMS_PER_CLUSTER))

    pv32 = np.asarray(prim_verts, np.float32)
    tfm = np.empty((c, 12, TRIS), np.float32)
    nrm4 = np.zeros((c, 4, TRIS), np.float32)
    bbox = np.empty((c, 8), np.float32)

    if prim_instance is not None and q:
        iid = np.zeros(c * PRIMS_PER_CLUSTER, np.float32)
        iid[:q] = np.asarray(prim_instance, np.float32)
        nrm4[:, 3, :] = np.repeat(iid, 2).reshape(c, TRIS)

    if native.build_cluster_tables_native(np.ascontiguousarray(pv32), q, c,
                                          tfm, nrm4, bbox):
        return tfm, nrm4, bbox, c

    def fill(c_lo: int, c_hi: int) -> None:
        p_lo = c_lo * PRIMS_PER_CLUSTER
        p_hi = c_hi * PRIMS_PER_CLUSTER
        nreal = max(0, min(q, p_hi) - p_lo)
        n = p_hi - p_lo
        pv = np.zeros((n, 4, 3))  # chunk-local f64
        pv[:nreal] = pv32[p_lo: p_lo + nreal]
        p1, p2, p3, p4 = pv[:, 0], pv[:, 1], pv[:, 2], pv[:, 3]

        tf0, _ = _tri_transforms_batch(p1, p2, p4)
        tf1, _ = _tri_transforms_batch(p3, p4, p2)
        tf = np.empty((n, 2, 12))
        tf[:, 0] = tf0
        tf[:, 1] = tf1
        tfm[c_lo:c_hi] = np.swapaxes(tf.reshape(c_hi - c_lo, TRIS, 12), 1, 2)

        en = _tn(p1, p2, p4) + _tn(p3, p4, p2)
        l = np.sqrt(np.einsum("ij,ij->i", en, en))[:, None]
        en = en / np.where(l > 0, l, 1.0)
        nrm4[c_lo:c_hi, :3] = np.swapaxes(
            np.repeat(en, 2, axis=0).reshape(c_hi - c_lo, TRIS, 3), 1, 2
        )

        pv[nreal:] = np.inf
        bbox[c_lo:c_hi, 0:3] = np.nan_to_num(
            pv.reshape(c_hi - c_lo, -1, 3).min(axis=1), posinf=NOHIT
        )
        pv[nreal:] = -np.inf
        bbox[c_lo:c_hi, 3:6] = np.nan_to_num(
            pv.reshape(c_hi - c_lo, -1, 3).max(axis=1), neginf=NOHIT
        )
        bbox[c_lo:c_hi, 6:8] = 0.0

    workers = min(4, max(1, (os.cpu_count() or 1)))
    chunk = max(256, -(-c // (workers * 4)))
    ranges = [(lo, min(lo + chunk, c)) for lo in range(0, c, chunk)]
    if len(ranges) <= 1:
        fill(0, c)
    else:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda r: fill(*r), ranges))
    return tfm, nrm4, bbox, c


def load_cluster_tables(prim_verts: np.ndarray, prim_instance=None,
                        cache_key: str = ""):
    """build_cluster_tables, through the disk cache: the product
    "clusters" under `cache_key` when its prim count matches, else built
    (and saved above diskcache.CACHE_MIN_PRIMS prims)."""
    q = len(prim_verts)
    cached = diskcache.load_arrays(cache_key, "clusters")
    if cached is not None and int(cached["q"]) == q:
        return (cached["tfm"], cached["nrm"], cached["bbox"],
                int(cached["n_clusters"]))
    tfm, nrm, bbox, n_clusters = build_cluster_tables(prim_verts, prim_instance)
    if q > diskcache.CACHE_MIN_PRIMS:
        diskcache.save_arrays(cache_key, "clusters", dict(
            tfm=tfm, nrm=nrm, bbox=bbox, n_clusters=n_clusters, q=q))
    return tfm, nrm, bbox, n_clusters


def _wl_super_bbox(bbox: np.ndarray, sup: int) -> np.ndarray:
    """Cluster boxes [C, 8] -> supercluster boxes [S, 8] over groups of
    `sup` clusters (the last group padded with its final box)."""
    c = len(bbox)
    s = -(-c // sup)
    pad = s * sup - c
    bb = np.concatenate([bbox, np.tile(bbox[-1:], (pad, 1))], axis=0) if pad else bbox
    bb = bb.reshape(s, sup, 8)
    out = np.zeros((s, 8), np.float32)
    out[:, 0:3] = bb[:, :, 0:3].min(axis=1)
    out[:, 3:6] = bb[:, :, 3:6].max(axis=1)
    return out
