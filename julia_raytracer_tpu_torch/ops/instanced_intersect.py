"""Two-level instanced intersector: the work-item precull, the wrapper of
csrc/instanced_intersect.cu and its plain PyTorch version.

Replaces make_cluster_intersect_instanced and its Pallas TPU kernel
_make_kernel_instanced (julia_raytracer_tpu/ops/pallas_cluster.py).

  upload: the InstancedTables of scene/instanced.py on the device, tab as
    [total_sup*sup, 16, 128] and bbox as [total_sup*sup, 8].
  precull: per 1024-ray block, the work items some ray of the block
    enters (an exact slab test of every ray against every item's world
    box, the JAX `beam_precull`), ordered by t_low, the smallest entry
    over the block's rays (a stable sort), and their count. Plain
    tensor code on the rays' device, nothing read back; O(rays x items),
    so the [rays, items] temporaries are cut into chunks of blocks.
  instanced_intersect_kernel / instanced_intersect_plain: walk each
    block's candidates in order and stop once no ray's best t exceeds the
    next item's t_low; per item move each ray into shape space, cull each
    cluster of the item's supercluster against the ray's running best and
    test the 128 triangles of a cluster it wants. The two compute the
    same function (the plain version batches each item's triangle tests,
    then takes the clusters in the kernel's order) and agree bit for bit
    on the card; the plain version also counts the work.

`instanced_intersect` runs the precull and then the plain version for CPU
tensors or the kernel (one launch for all blocks) for CUDA tensors, and
normalises the rotated normals. `instanced_intersect_kernel.launches`
counts the kernel's launches.

Differences from the JAX function, none of which changes a closest hit:
the kernel stops at item rather than K-item round granularity (so there
is no `k_items` and no host loop over rounds); the cull is per ray rather
than per 128-lane row; there is no flat-grid variant (`JRT_INST_FLAT`):
the single launch already walks each block's whole list.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.cluster_tables import TRIS
from julia_raytracer_tpu_torch.ops.traversal import Hit

BLOCK_RAYS = 1024
SLACK = wl.SLACK
# [rays, items] float temporaries of the precull above this many bytes
# are cut into chunks of blocks (six of them are live at once)
PRECULL_BYTES = 1.5e9
FLAGS = ("-fmad=false",)


class InstancedDeviceTables(NamedTuple):
    tab: torch.Tensor  # f32 [total_sup*sup, 16, 128] shape-space tables
    bbox: torch.Tensor  # f32 [total_sup*sup, 8] cluster boxes
    inst_rows: torch.Tensor  # f32 [I, 24]
    wi_sup: torch.Tensor  # i32 [items]
    wi_inst: torch.Tensor  # i32 [items]
    wi_bbox: torch.Tensor  # f32 [items, 6] world boxes
    n_prims: int  # padded shape-space prim count
    sup: int


def upload(tables, device) -> InstancedDeviceTables:
    """scene/instanced.py InstancedTables -> tensors on `device`."""
    sup = tables.sup

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).contiguous().to(device)

    return InstancedDeviceTables(
        tab=put(tables.tab.reshape(-1, wl.ROWS, TRIS), torch.float32),
        bbox=put(tables.bbox.reshape(-1, 8), torch.float32),
        inst_rows=put(tables.inst_rows, torch.float32),
        wi_sup=put(tables.wi_sup, torch.int32),
        wi_inst=put(tables.wi_inst, torch.int32),
        wi_bbox=put(tables.wi_bbox.reshape(-1, 6), torch.float32),
        n_prims=int(tables.n_prims),
        sup=sup,
    )


def _block_keys(ro, rd, tmin, tmax, wi_bbox):
    """Rays of whole blocks -> [nb, items] nearest entry of the block's
    rays into each item's world box (+inf: no ray enters it)."""
    nb = ro.shape[0] // BLOCK_RAYS
    di = wl._inverse_dir(rd)
    enter = exit_ = None
    for a in range(3):
        o, d = ro[:, a:a + 1], di[:, a:a + 1]
        t0 = (wi_bbox[None, :, a] - o).mul_(d)
        t1 = (wi_bbox[None, :, 3 + a] - o).mul_(d)
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1, out=t0)
        enter = lo if enter is None else torch.maximum(enter, lo, out=enter)
        exit_ = hi if exit_ is None else torch.minimum(exit_, hi, out=exit_)
        del t1
    torch.maximum(enter, tmin[:, None], out=enter)
    torch.minimum(exit_, tmax[:, None], out=exit_)
    ray_hit = enter <= exit_.mul_(SLACK)
    del exit_
    enter = enter.clamp_(min=0.0).masked_fill_(~ray_hit, float("inf"))
    return enter.view(nb, BLOCK_RAYS, -1).amin(dim=1)


def precull(ro, rd, tmin, tmax, wi_bbox):
    """Candidate items of each 1024-ray block, front to back:
    (order [nb, items] i32, tlow [nb, items] f32 sorted, cnt [nb] i32).
    Rays are padded to whole blocks with zeros (tmin = tmax = 0), as the
    JAX package pads them."""
    n = ro.shape[0]
    nb = max(1, -(-n // BLOCK_RAYS))
    pad = nb * BLOCK_RAYS - n
    if pad:
        ro = torch.nn.functional.pad(ro, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rd, (0, 0, 0, pad))
        tmin = torch.nn.functional.pad(tmin, (0, pad))
        tmax = torch.nn.functional.pad(tmax, (0, pad))
    items = wi_bbox.shape[0]
    chunk = max(1, int(PRECULL_BYTES // (6 * BLOCK_RAYS * items * 4)))
    keys = torch.cat([
        _block_keys(*(x[b0 * BLOCK_RAYS:(b0 + chunk) * BLOCK_RAYS]
                      for x in (ro, rd, tmin, tmax)), wi_bbox)
        for b0 in range(0, nb, chunk)
    ])
    order = torch.argsort(keys, dim=1, stable=True)
    tlow = keys.gather(1, order)
    cnt = torch.isfinite(keys).sum(dim=1, dtype=torch.int32)
    return order.to(torch.int32), tlow, cnt


def _to_shape_space(ro, rd, xf):
    """World rays -> shape space by the instance rows xf [n, 24]
    (obj = world Ri + oi), in the kernel's arithmetic order."""
    def row(v, j):
        return (v[:, 0] * xf[:, j] + v[:, 1] * xf[:, 3 + j]) + v[:, 2] * xf[:, 6 + j]

    so = torch.stack([row(ro, j) + xf[:, 9 + j] for j in range(3)], dim=-1)
    sd = torch.stack([row(rd, j) for j in range(3)], dim=-1)
    return so, sd


def _cull_all(o, inv, tmin, tlim, boxes):
    """[n] rays against their [n, sup] cluster boxes: cluster_cull for
    every cluster of each ray's item at once -> [n, sup]."""
    t0 = (boxes[..., 0:3] - o[:, None]) * inv[:, None]
    t1 = (boxes[..., 3:6] - o[:, None]) * inv[:, None]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    exit_ = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    enter = torch.maximum(enter, tmin[:, None])
    exit_ = torch.minimum(exit_, tlim[:, None])
    return enter <= exit_ * SLACK


def instanced_intersect_plain(tables: InstancedDeviceTables, ro, rd, tmin,
                              tmax, order, tlow, cnt) -> tuple[Hit, dict]:
    """Plain PyTorch version of the kernel -> (Hit with the unnormalised
    world normal, work). One step per list position: the blocks still
    walking take their next item (after the stopping rule) and their rays
    move into shape space. Every cluster of the item a ray wants at the
    item's start (best only shrinks, so it wants no other later) has its
    closest hit below that start best found in one batch; then the
    clusters are folded in index order as the kernel takes them: a ray
    wants cluster j if it passes the cull against its running best, and
    takes the cluster's hit if that is below the running best (the closest
    hit below a smaller best is the same hit, or none). work counts the
    (ray, cluster) pairs that passed the cull (`pairs`), the (block, item)
    steps (`block_items`), the (block, cluster) table loads
    (`block_pairs`) and the distinct clusters, superclusters and instances
    read (`clusters`, `supers`, `instances`); reads counts back every
    step."""
    n, dev = ro.shape[0], ro.device
    nb, sup = cnt.shape[0], tables.sup
    blk = torch.arange(n, device=dev) // BLOCK_RAYS
    best = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, device=dev)
    bv = torch.zeros(n, device=dev)
    bn = torch.zeros((n, 3), device=dev)
    binst = torch.zeros(n, dtype=torch.int32, device=dev)
    bbox = tables.bbox.view(-1, sup, 8)
    touched = torch.zeros(bbox.shape[0] * sup, dtype=torch.bool, device=dev)
    touched_sup = torch.zeros(bbox.shape[0], dtype=torch.bool, device=dev)
    touched_inst = torch.zeros(tables.inst_rows.shape[0], dtype=torch.bool,
                               device=dev)
    count = {k: torch.zeros((), dtype=torch.int64, device=dev)
             for k in ("pairs", "block_items", "block_pairs")}
    walking = cnt > 0
    for k in range(order.shape[1] if n else 0):
        # the stopping rule: a block walks on while some ray's best t
        # exceeds the next item's nearest entry
        better = torch.zeros(nb * BLOCK_RAYS, dtype=torch.bool, device=dev)
        better[:n] = best > tlow[blk, k]
        walking &= (k < cnt) & better.view(nb, BLOCK_RAYS).any(dim=1)
        if not bool(walking.any()):
            break
        count["block_items"] += walking.sum()
        w = torch.nonzero(walking[blk]).squeeze(1)  # rays of walking blocks
        item = order[blk[w], k].long()
        sc = tables.wi_sup[item].long()
        inst = tables.wi_inst[item]
        xf = tables.inst_rows[inst.long()]
        touched_sup[sc] = True
        touched_inst[inst.long()] = True
        so, sd = _to_shape_space(ro[w], rd[w], xf)
        inv = wl._inverse_dir(sd)
        tmin_w, tmax_w, b = tmin[w], tmax[w], best[w]
        boxes = bbox[sc]  # [w, sup, 8]
        start = _cull_all(so, inv, tmin_w, torch.minimum(tmax_w, b), boxes)
        ri, ci = torch.nonzero(start, as_tuple=True)
        if ri.numel() == 0:
            continue
        c = tables.tab[sc[ri] * sup + ci]
        found, arg, t, u, v = wl._closest_tri(so[ri], sd[ri], tmin_w[ri],
                                              b[ri], c)
        ns = c.gather(2, arg[:, None, None].expand(-1, wl.ROWS, 1))[:, 12:15, 0]
        fx = xf[ri]
        # shape -> world normal: n_w = n_s R
        nw = torch.stack([(ns[:, 0] * fx[:, 12 + j] + ns[:, 1] * fx[:, 15 + j])
                          + ns[:, 2] * fx[:, 18 + j] for j in range(3)], dim=-1)

        def dense(x, fill):
            out = torch.full((w.numel(), sup) + x.shape[1:], fill,
                             dtype=x.dtype, device=dev)
            out[ri, ci] = x
            return out

        found_c, t_c, u_c, v_c = (dense(found, False), dense(t, 0.0),
                                  dense(u, 0.0), dense(v, 0.0))
        arg_c, n_c = dense(arg, 0), dense(nw, 0.0)
        bw_u, bw_v, bw_n = bu[w], bv[w], bn[w]
        bw_tri, bw_inst = best_tri[w], binst[w]
        for j in torch.unique(ci).tolist():
            want = start[:, j] & wl._cluster_cull(
                so, inv, tmin_w, torch.minimum(tmax_w, b), boxes[:, j])
            take = want & found_c[:, j] & (t_c[:, j] < b)
            count["pairs"] += want.sum()
            count["block_pairs"] += torch.zeros(
                nb, dtype=torch.bool, device=dev).index_fill_(
                    0, blk[w][want], True).sum()
            touched[(sc * sup + j)[want]] = True
            b = torch.where(take, t_c[:, j], b)
            bw_u = torch.where(take, u_c[:, j], bw_u)
            bw_v = torch.where(take, v_c[:, j], bw_v)
            bw_n = torch.where(take[:, None], n_c[:, j], bw_n)
            bw_tri = torch.where(take, (sc * sup + j) * TRIS + arg_c[:, j],
                                 bw_tri)
            bw_inst = torch.where(take, inst, bw_inst)
        best[w], bu[w], bv[w], bn[w] = b, bw_u, bw_v, bw_n
        best_tri[w], binst[w] = bw_tri, bw_inst
    work = {k: int(v) for k, v in count.items()}
    work.update(clusters=int(touched.sum()), supers=int(touched_sup.sum()),
                instances=int(touched_inst.sum()))
    prim = torch.where(best_tri >= 0, best_tri // 2, -1)
    prim = torch.where(prim >= tables.n_prims, -1, prim).to(torch.int32)
    hit = prim >= 0
    t = torch.where(hit, best, tmax)
    pos = ro + t[:, None] * rd
    return Hit(hit, prim, bu, bv, t, pos, bn, binst), work


def instanced_intersect_kernel(tables: InstancedDeviceTables, ro, rd, tmin,
                               tmax, order, tlow, cnt) -> Hit:
    """Launch csrc/instanced_intersect.cu on CUDA tensors (raises
    otherwise) -> Hit with the unnormalised world normal."""
    if ro.device.type != "cuda":
        raise ValueError(f"instanced_intersect_kernel: {ro.device} is not a "
                         "CUDA device")
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    c_total, items = tables.tab.shape[0], tables.wi_sup.shape[0]
    nb = max(1, -(-n // BLOCK_RAYS))
    wl._check(ro, f32, (n, 3), dev, "ro")
    wl._check(rd, f32, (n, 3), dev, "rd")
    wl._check(tmin, f32, (n,), dev, "tmin")
    wl._check(tmax, f32, (n,), dev, "tmax")
    wl._check(tables.tab, f32, (c_total, wl.ROWS, TRIS), dev, "tab")
    wl._check(tables.bbox, f32, (c_total, 8), dev, "bbox")
    wl._check(tables.inst_rows, f32, (tables.inst_rows.shape[0], 24), dev,
              "inst_rows")
    wl._check(tables.wi_inst, i32, (items,), dev, "wi_inst")
    wl._check(tables.wi_sup, i32, (items,), dev, "wi_sup")
    wl._check(order, i32, (nb, items), dev, "order")
    wl._check(tlow, f32, (nb, items), dev, "tlow")
    wl._check(cnt, i32, (nb,), dev, "cnt")
    prim = torch.empty(n, dtype=i32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    t = torch.empty(n, dtype=f32, device=dev)
    pos = torch.empty((n, 3), dtype=f32, device=dev)
    nrm = torch.empty((n, 3), dtype=f32, device=dev)
    inst = torch.empty(n, dtype=i32, device=dev)
    err = _lib().instanced_intersect_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        tables.tab.data_ptr(), tables.bbox.data_ptr(),
        tables.inst_rows.data_ptr(), tables.wi_sup.data_ptr(),
        tables.wi_inst.data_ptr(), order.data_ptr(), tlow.data_ptr(),
        cnt.data_ptr(), items, tables.sup, tables.n_prims, prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), t.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(), inst.data_ptr(), cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, "instanced_intersect")
    if n:  # the launcher launches nothing for no rays
        instanced_intersect_kernel.launches += 1
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


instanced_intersect_kernel.launches = 0


def _lib():
    lib = cuda_build.load("instanced_intersect", FLAGS)
    fn = lib.instanced_intersect_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, p, p, p, i, i, i,
                       p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def normalize_normal(hit: Hit) -> Hit:
    """The rotated element normal, normalised (outside the kernel, as the
    JAX package does)."""
    gn = hit.gnormal
    gl = torch.sqrt((gn * gn).sum(dim=-1, keepdim=True))
    return hit._replace(gnormal=gn / torch.where(gl > 0, gl, 1.0))


def instanced_intersect(tables: InstancedDeviceTables, ro, rd, tmin,
                        tmax) -> Hit:
    """Closest hit of rays ro/rd [N, 3], tmin/tmax [N] over the work
    items: precull, then the plain version for CPU tensors or the kernel
    for CUDA tensors; prim ids in the padded shape-space eval layout."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instanced_intersect: unsupported device {ro.device}")
    n = ro.shape[0]
    if tables.wi_sup.shape[0] == 0:  # no work items: every ray misses
        z = torch.zeros(n, device=ro.device)
        zi = torch.zeros(n, dtype=torch.int32, device=ro.device)
        return Hit(torch.zeros(n, dtype=torch.bool, device=ro.device), zi - 1,
                   z, z, tmax, ro + tmax[:, None] * rd, torch.zeros_like(ro), zi)
    lists = precull(ro, rd, tmin, tmax, tables.wi_bbox)
    if ro.device.type == "cpu":
        hit = instanced_intersect_plain(tables, ro, rd, tmin, tmax, *lists)[0]
    else:
        hit = instanced_intersect_kernel(tables, ro, rd, tmin, tmax, *lists)
    return normalize_normal(hit)


def make_instanced_intersect(tables, device):
    """intersect(ro, rd, tmin, tmax) -> Hit over the work items of a
    scene/instanced.py InstancedTables, on `device`."""
    dt = upload(tables, device)

    def intersect(ro, rd, tmin, tmax):
        return instanced_intersect(dt, ro, rd, tmin, tmax)

    intersect.tables = dt
    return intersect
