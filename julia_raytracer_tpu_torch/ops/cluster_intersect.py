"""Cluster intersectors without a work list: the wrappers of
csrc/cluster_intersect.cu and their plain PyTorch versions.

Replace make_cluster_intersect / _make_kernel and
make_cluster_intersect_hbm / _make_kernel_streamed of
julia_raytracer_tpu/ops/pallas_cluster.py. As in the JAX package, no
scene routes to them (build_intersector takes the worklist or regroup
intersectors); they are reached through their factories.

  pack_tables: the worklist intersector's table packing
    (ops/worklist_intersect.py) with superclusters of SUPER = 64 clusters
    (the JAX package's `build_super_bbox`), so prim ids are the worklist
    intersector's.
  cluster_intersect_kernel / _plain: each warp of 32 rays sweeps every
    cluster in index order (in steps of up to 128); each ray culls each
    cluster box against [tmin, tmax] and tests the 128 triangles of a
    cluster it wants in index order with a strict `<` against its running
    best.
  cluster_intersect_streamed_kernel / _plain: the same over the
    superclusters in index order, each ray culled against the supercluster
    box first and, inside one it enters, against each cluster box.

The kernel and its plain version compute the same function in the same
order and agree bit for bit on the card; the plain versions also count
the (ray, cluster) pairs that pass the cull (`pairs`), the work that
bounds the kernels, the clusters some ray tests (`clusters`), and the
(warp of 32 consecutive rays, cluster) pairs in which some ray wants the
cluster (`loads`): each one load of the cluster's table by the kernel's
warp walk (csrc/warp_walk.cuh). The streamed version also counts the
(warp, supercluster) pairs in which some ray enters the supercluster's
box (`steps`): the streamed kernel's steps, each 64 box culls a lane,
where the sweep culls all C boxes on every ray.
`cluster_intersect` / `cluster_intersect_streamed` take the plain version
for CPU tensors and the kernel for CUDA tensors (or raise). Each kernel
wrapper's `.launches` counts its launches.

Differences from the JAX functions, none of which changes a hit: the
cull is per ray rather than per block (phase A of `_make_kernel`) or per
128-lane row (`_make_kernel_streamed`); fp32 throughout (the TPU's
`split3` matmul workaround is not needed); no on-disk table cache.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.cluster_tables import PRIMS_PER_CLUSTER, TRIS
from julia_raytracer_tpu_torch.ops.traversal import Hit, Intersector
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

SUPER = 64  # clusters per supercluster of the streamed kernel
FLAGS = ("-fmad=false",)


def pack_tables(prim_verts: np.ndarray, prim_instance, device) -> wl.WorklistTables:
    """[Q, 4, 3] quads in BVH order (+ [Q] instance ids) -> the packed
    tables on `device`: tab [S*64, 16, 128], bbox [S*64, 8], sbbox [S, 8]."""
    return wl.pack_tables(prim_verts, prim_instance, SUPER, device)


def n_clusters(tables: wl.WorklistTables) -> int:
    """The clusters that hold quads (the rest pad the last supercluster)."""
    return max(1, -(-tables.n_prims // PRIMS_PER_CLUSTER))


class _Record:
    """The running closest hit of n rays (the plain versions' state)."""

    def __init__(self, tmax):
        n, dev = tmax.shape[0], tmax.device
        self.best = tmax.clone()
        self.best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.bu = torch.zeros(n, device=dev)
        self.bv = torch.zeros(n, device=dev)
        self.bn = torch.zeros((n, 3), device=dev)
        self.binst = torch.zeros(n, device=dev)
        self.pairs = 0
        self.clusters = 0
        self.loads = 0

    def test(self, tables, ro, rd, tmin, idx, cl: int) -> None:
        """Rays `idx` (ascending) want cluster `cl`: their closest hits
        among its 128 triangles (wl._closest_tri), as the warp walk finds
        them."""
        self.pairs += idx.numel()
        self.clusters += 1
        self.loads += torch.unique_consecutive(idx // wl.WARP).numel()
        c = tables.tab[cl]
        found, arg, t, u, v = wl._closest_tri(ro[idx], rd[idx], tmin[idx],
                                              self.best[idx], c[None])
        sel, arg = idx[found], arg[found]
        self.best[sel] = t[found]
        self.bu[sel] = u[found]
        self.bv[sel] = v[found]
        attrs = c[12:16, arg].T  # [k, 4]: normal, instance
        self.bn[sel] = attrs[:, 0:3]
        self.binst[sel] = attrs[:, 3]
        self.best_tri[sel] = cl * TRIS + arg

    def hit(self, tables, ro, rd, tmax) -> Hit:
        return wl._finish(tables, ro, rd, tmax, self.best, self.best_tri,
                          self.bu, self.bv, self.bn, self.binst)

    def work(self) -> dict:
        return dict(pairs=self.pairs, clusters=self.clusters,
                    loads=self.loads)


def cluster_intersect_plain(tables: wl.WorklistTables, ro, rd, tmin, tmax,
                            ) -> tuple[Hit, dict]:
    """Plain PyTorch version of cluster_sweep_kernel -> (Hit, work):
    vectorised over rays, one step per cluster; reads counts back."""
    inv = wl._inverse_dir(rd)
    rec = _Record(tmax)
    for cl in range(n_clusters(tables)):
        want = wl._cluster_cull(ro, inv, tmin, tmax, tables.bbox[cl:cl + 1])
        idx = torch.nonzero(want).squeeze(1)
        if idx.numel():
            rec.test(tables, ro, rd, tmin, idx, cl)
    return rec.hit(tables, ro, rd, tmax), rec.work()


def cluster_intersect_streamed_plain(tables: wl.WorklistTables, ro, rd, tmin,
                                     tmax) -> tuple[Hit, dict]:
    """Plain PyTorch version of cluster_streamed_kernel -> (Hit, work):
    vectorised over rays, one step per supercluster and cluster."""
    inv = wl._inverse_dir(rd)
    rec = _Record(tmax)
    steps = 0
    for s in range(tables.sbbox.shape[0]):
        ins = wl._cluster_cull(ro, inv, tmin, tmax, tables.sbbox[s:s + 1])
        sub = torch.nonzero(ins).squeeze(1)
        if sub.numel() == 0:
            continue
        steps += torch.unique_consecutive(sub // wl.WARP).numel()
        for ci in range(SUPER):
            cl = s * SUPER + ci
            want = wl._cluster_cull(ro[sub], inv[sub], tmin[sub], tmax[sub],
                                    tables.bbox[cl:cl + 1])
            idx = sub[want]
            if idx.numel():
                rec.test(tables, ro, rd, tmin, idx, cl)
    return rec.hit(tables, ro, rd, tmax), dict(rec.work(), steps=steps)


def _launch(name, tables, ro, rd, tmin, tmax, *table_args) -> Hit:
    if ro.device.type != "cuda":
        raise ValueError(f"{name}: {ro.device} is not a CUDA device")
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    c_total = tables.tab.shape[0]
    wl._check(ro, f32, (n, 3), dev, "ro")
    wl._check(rd, f32, (n, 3), dev, "rd")
    wl._check(tmin, f32, (n,), dev, "tmin")
    wl._check(tmax, f32, (n,), dev, "tmax")
    wl._check(tables.tab, f32, (c_total, wl.ROWS, TRIS), dev, "tab")
    wl._check(tables.bbox, f32, (c_total, 8), dev, "bbox")
    wl._check(tables.sbbox, f32, (c_total // SUPER, 8), dev, "sbbox")
    prim = torch.empty(n, dtype=i32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    t = torch.empty(n, dtype=f32, device=dev)
    pos = torch.empty((n, 3), dtype=f32, device=dev)
    nrm = torch.empty((n, 3), dtype=f32, device=dev)
    inst = torch.empty(n, dtype=i32, device=dev)
    err = getattr(_lib(), name + "_launch")(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        tables.tab.data_ptr(), tables.bbox.data_ptr(), *table_args,
        tables.n_prims, prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        t.data_ptr(), pos.data_ptr(), nrm.data_ptr(), inst.data_ptr(),
        cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, name)
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


def cluster_intersect_kernel(tables: wl.WorklistTables, ro, rd, tmin,
                             tmax) -> Hit:
    """Launch cluster_sweep_kernel on CUDA tensors (raises otherwise)."""
    hit = _launch("cluster_sweep", tables, ro, rd, tmin, tmax,
                  n_clusters(tables))
    if ro.shape[0]:  # the launcher launches nothing for no rays
        cluster_intersect_kernel.launches += 1
    return hit


def cluster_intersect_streamed_kernel(tables: wl.WorklistTables, ro, rd, tmin,
                                      tmax) -> Hit:
    """Launch cluster_streamed_kernel on CUDA tensors (raises otherwise)."""
    hit = _launch("cluster_streamed", tables, ro, rd, tmin, tmax,
                  tables.sbbox.data_ptr(), tables.sbbox.shape[0])
    if ro.shape[0]:
        cluster_intersect_streamed_kernel.launches += 1
    return hit


timing.counter(cluster_intersect_kernel, "launches")
timing.counter(cluster_intersect_streamed_kernel, "launches")


def _lib():
    lib = cuda_build.load("cluster_intersect", FLAGS)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, table_args in (("cluster_sweep_launch", [i]),
                             ("cluster_streamed_launch", [p, i])):
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = ([p, p, p, p, i, p, p] + table_args
                           + [i, p, p, p, p, p, p, p, p])
            fn.restype = ctypes.c_int
    return lib


def needed_pairs(tables: wl.WorklistTables, ro, rd, tmin,
                 t_hit) -> tuple[int, int]:
    """(pairs, clusters) a sweep over every cluster needs: worklist_
    intersect.needed_pairs with every supercluster listed for every group."""
    n_super = tables.sbbox.shape[0]
    n_groups = -(-ro.shape[0] // wl.GROUP_RAYS)
    order = torch.arange(n_super, dtype=torch.int32, device=ro.device)
    return wl.needed_pairs(
        tables, ro, rd, tmin, t_hit, order.expand(n_groups, n_super),
        torch.full((n_groups,), n_super, dtype=torch.int32, device=ro.device))


def call_cost(tables: wl.WorklistTables, ro, rd, tmin, t_hit,
              box_bytes: int) -> dict:
    """kernel_flops.cluster_sweep_cost of one call: the (ray, cluster)
    pairs and clusters it needs (needed_pairs)."""
    pairs, clusters = needed_pairs(tables, ro, rd, tmin, t_hit)
    return kf.cluster_sweep_cost(ro.shape[0], box_bytes, clusters, pairs)


def _dispatch(name, plain, kernel, box_bytes, tables, ro, rd, tmin,
              tmax) -> Hit:
    with roofline.kernel_region() as counter:
        if ro.device.type == "cpu":
            hit = plain(tables, ro, rd, tmin, tmax)[0]
        elif ro.device.type == "cuda":
            hit = kernel(tables, ro, rd, tmin, tmax)
        else:
            raise ValueError(f"unsupported device {ro.device}")
        if counter is not None:
            counter.add_kernel(name, call_cost(tables, ro, rd, tmin, hit.t,
                                               box_bytes))
    return hit


def cluster_intersect(tables, ro, rd, tmin, tmax) -> Hit:
    """Closest hit over every cluster: the plain version for CPU tensors,
    the kernel for CUDA tensors; under roofline.count_cost the call
    reports call_cost (the cluster boxes read)."""
    return _dispatch("cluster_intersect", cluster_intersect_plain,
                     cluster_intersect_kernel, n_clusters(tables) * 32,
                     tables, ro, rd, tmin, tmax)


def cluster_intersect_streamed(tables, ro, rd, tmin, tmax) -> Hit:
    """Closest hit over every supercluster's clusters: the plain version
    for CPU tensors, the kernel for CUDA tensors; under
    roofline.count_cost the call reports call_cost (the cluster and
    supercluster boxes read)."""
    return _dispatch("cluster_intersect_streamed",
                     cluster_intersect_streamed_plain,
                     cluster_intersect_streamed_kernel,
                     (tables.bbox.numel() + tables.sbbox.numel()) * 4,
                     tables, ro, rd, tmin, tmax)


def make_cluster_intersect(prim_verts: np.ndarray, prim_instance, device):
    """The Intersector over a fixed quad soup on `device`, by the cluster
    sweep (JAX make_cluster_intersect)."""
    tables = pack_tables(prim_verts, prim_instance, device)

    def intersect(ro, rd, tmin, tmax):
        return cluster_intersect(tables, ro, rd, tmin, tmax)

    return Intersector(intersect, tables=tables)


def make_cluster_intersect_hbm(prim_verts: np.ndarray, prim_instance, device):
    """The Intersector over a fixed quad soup on `device`, by the
    supercluster walk (JAX make_cluster_intersect_hbm)."""
    tables = pack_tables(prim_verts, prim_instance, device)

    def intersect(ro, rd, tmin, tmax):
        return cluster_intersect_streamed(tables, ro, rd, tmin, tmax)

    return Intersector(intersect, tables=tables)
