"""Two-level instanced intersector: the candidate cull, the wrappers of
csrc/candidate_cull.cu and csrc/instanced_intersect.cu and their plain
PyTorch versions.

Replaces make_cluster_intersect_instanced: its Pallas TPU kernel
_make_kernel_instanced and its fused-jnp candidate cull beam_precull
(julia_raytracer_tpu/ops/pallas_cluster.py).

  upload: the InstancedTables of scene/instanced.py on the device, tab as
    [total_sup*sup, 16, 128] and bbox as [total_sup*sup, 8].
  candidate_keys_kernel / candidate_keys_plain: per group of `group` rays
    (GROUP_RAYS = 256 by default; the JAX package's 1,024 in the tests) and
    per work item, the nearest entry of any of the group's rays into the
    item's world box (an exact slab test of every ray against every item,
    the JAX `beam_precull`), +inf where none enters. The kernel writes
    only the [groups, items] keys; the plain version computes [rays,
    items] temporaries in chunks of groups. They agree bit for bit.
  precull: the keys, each group's items ordered by them (a stable sort,
    torch.argsort), the sorted keys (t_low) and the count of finite keys;
    on the rays' device, nothing read back.
  instanced_intersect_kernel / instanced_intersect_plain: each warp of 32
    rays walks its group's candidates in order and stops once none of its
    rays' best t exceeds the next item's t_low; a ray enters an item if it
    passes the item's world box against its running best; per item the
    entering rays move into shape space, cull each cluster of the item's
    supercluster against their running best and take the closest hit of
    the 128 triangles of a cluster they want. The two compute the same
    function (the plain version batches each item's triangle tests, then
    takes the clusters in the kernel's order) and agree bit for bit on
    the card; the plain version also counts the work.

`instanced_intersect` runs the precull and then the plain versions for
CPU tensors or the kernels (one launch each for all rays) for CUDA
tensors, and normalises the rotated normals.
`candidate_keys_kernel.launches` and `instanced_intersect_kernel.launches`
count the kernels' launches.

Differences from the JAX function, none of which changes a closest hit:
the candidate lists belong to groups of 256 rays, not 1,024; the walk
stops at item, not K-item round, granularity, per warp (so there is no
`k_items` and no host loop over rounds); a ray skips an item whose world
box it does not enter against its running best (the boxes are rounded
outward from float64 corners in scene/instanced.py, so each holds its
supercluster's box, as a per-ray test needs; the JAX package's are
rounded to nearest and tested per 1,024-ray block only); the cull is per ray
rather than per 128-lane row; there is no flat-grid variant
(`JRT_INST_FLAT`): the single launch already walks each list whole.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.ops.cluster_tables import TRIS
from julia_raytracer_tpu_torch.ops.traversal import Hit

WARP = wl.WARP  # rays of a walking warp
# rays per candidate list (the JAX package's: 1,024): of 32-256, the sum
# of the precull and the kernel on an H100 is least at 256 on the hybrid
# scene's work-item rays and the instanced scene's camera rays, and ties
# 128 on its bounce rays (chip_smoke.py's group sweep, PERF.md section 6)
GROUP_RAYS = 256
SLACK = wl.SLACK
# [rays, items] float temporaries of the plain cull above this many bytes
# are cut into chunks of groups (six of them are live at once)
PRECULL_BYTES = 1.5e9
# fp32 operations of one (ray, item) slab test of the cull, counted in
# candidate_cull.cu
CULL_OPS_PER_TEST = 28
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


def _group_keys(ro, rd, tmin, tmax, boxes, group):
    """Rays of whole groups -> [groups, items] nearest entry of the group's
    rays into each box (+inf: no ray enters it; +0 for an entry at or
    before the origin)."""
    ng = ro.shape[0] // group
    di = wl._inverse_dir(rd)
    enter = exit_ = None
    for a in range(3):
        o, d = ro[:, a:a + 1], di[:, a:a + 1]
        t0 = (boxes[None, :, a] - o).mul_(d)
        t1 = (boxes[None, :, 3 + a] - o).mul_(d)
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1, out=t0)
        enter = lo if enter is None else torch.maximum(enter, lo, out=enter)
        exit_ = hi if exit_ is None else torch.minimum(exit_, hi, out=exit_)
        del t1
    torch.maximum(enter, tmin[:, None], out=enter)
    torch.minimum(exit_, tmax[:, None], out=exit_)
    ray_hit = enter <= exit_.mul_(SLACK)
    del exit_
    enter = torch.where(enter > 0.0, enter, 0.0).masked_fill_(~ray_hit,
                                                              float("inf"))
    return enter.view(ng, group, -1).amin(dim=1)


def candidate_keys_plain(ro, rd, tmin, tmax, boxes,
                         group: int = GROUP_RAYS):
    """Plain PyTorch version of the cull kernel: rays ro/rd [N, 3],
    tmin/tmax [N], boxes [items, >= 6] (min xyz, max xyz) -> keys
    [ceil(N / group), items] f32."""
    wl.check_group(group)
    ro, rd, tmin, tmax = wl.pad_rays(ro, rd, tmin, tmax, group)
    ng, items = ro.shape[0] // group, boxes.shape[0]
    boxes = boxes[:, :6]
    chunk = max(1, int(PRECULL_BYTES // (6 * group * max(items, 1) * 4)))
    return torch.cat([
        _group_keys(*(x[g0 * group:(g0 + chunk) * group]
                      for x in (ro, rd, tmin, tmax)), boxes, group)
        for g0 in range(0, ng, chunk)
    ])


def candidate_keys_kernel(ro, rd, tmin, tmax, boxes,
                          group: int = GROUP_RAYS):
    """Launch csrc/candidate_cull.cu on CUDA tensors (raises otherwise):
    the keys of candidate_keys_plain, with nothing of size [rays, items]
    in device memory."""
    if ro.device.type != "cuda":
        raise ValueError(f"candidate_keys_kernel: {ro.device} is not a CUDA "
                         "device")
    wl.check_group(group)
    n, dev, f32 = ro.shape[0], ro.device, torch.float32
    items = boxes.shape[0]
    wl._check(ro, f32, (n, 3), dev, "ro")
    wl._check(rd, f32, (n, 3), dev, "rd")
    wl._check(tmin, f32, (n,), dev, "tmin")
    wl._check(tmax, f32, (n,), dev, "tmax")
    if boxes.dim() != 2 or boxes.shape[1] < 6:
        raise ValueError(f"boxes: expected [items, >= 6], got {tuple(boxes.shape)}")
    wl._check(boxes, f32, tuple(boxes.shape), dev, "boxes")
    ng = max(1, -(-n // group))
    keys = torch.empty((ng, items), dtype=f32, device=dev)
    err = _cull_lib().candidate_cull_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        boxes.data_ptr(), boxes.shape[1], items, group, keys.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(err, "candidate_cull")
    if n and items:  # the launcher launches nothing for no rays or items
        candidate_keys_kernel.launches += 1
    return keys


candidate_keys_kernel.launches = 0


def precull(ro, rd, tmin, tmax, wi_bbox, group: int = GROUP_RAYS):
    """Candidate items of each group of `group` rays, front to back:
    (order [ng, items] i32, tlow [ng, items] f32 sorted, cnt [ng] i32):
    the cull's plain version for CPU tensors, its kernel for CUDA
    tensors."""
    keys = (candidate_keys_plain if ro.device.type == "cpu"
            else candidate_keys_kernel)(ro, rd, tmin, tmax, wi_bbox, group)
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
                              tmax, order, tlow, cnt,
                              group: int = GROUP_RAYS) -> tuple[Hit, dict]:
    """Plain PyTorch version of the kernel -> (Hit with the unnormalised
    world normal, work). One step per list position: the warps still
    walking take their next item (after the stopping rule); a ray enters
    it if it passes the item's world box against its running best, and
    the rays of warps with an entering ray move into shape space. Every
    cluster of the item an entering ray wants at the item's start (best
    only shrinks, so it wants no other later) has its closest hit below
    that start best found in one batch; then the clusters are folded in
    index order as the kernel takes them: a ray wants cluster j if it
    passes the cull against its running best, and takes the cluster's hit
    if that is below the running best (the closest hit below a smaller
    best is the same hit, or none). work counts what the kernel does:
    warps that walk (`groups`), (warp, item) steps (`steps`), the steps
    with an entering ray, each one mask vote (`votes`), (warp, cluster)
    table loads (`warp_pairs`), (ray, cluster) pairs that passed the cull
    (`pairs`), the real triangles of the pairs' clusters (`tri_slots`, as
    in worklist_intersect_plain), and the distinct clusters,
    superclusters and instances read (`clusters`, `supers`, `instances`);
    reads counts back every step."""
    wl.check_group(group)
    n, dev, sup = ro.shape[0], ro.device, tables.sup
    nw = -(-n // WARP)
    lane = torch.arange(n, device=dev)
    warp, row = lane // WARP, lane // group
    warp_row = torch.arange(nw, device=dev) * WARP // group
    warp_cnt = cnt[warp_row]
    inv_w = wl._inverse_dir(rd)
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
             for k in ("steps", "votes", "warp_pairs", "pairs", "tri_slots")}

    def warps_of(rays):
        return torch.zeros(nw, dtype=torch.bool, device=dev).index_fill_(
            0, warp[rays], True)

    walking = warp_cnt > 0
    groups = int(walking.sum())
    for k in range(order.shape[1] if n else 0):
        # the stopping rule: a warp walks on while one of its rays' best t
        # exceeds the next item's nearest entry
        better = torch.zeros(nw * WARP, dtype=torch.bool, device=dev)
        better[:n] = best > tlow[row, k]
        walking &= (k < warp_cnt) & better.view(nw, WARP).any(dim=1)
        if not bool(walking.any()):
            break
        count["steps"] += walking.sum()
        w = torch.nonzero(walking[warp]).squeeze(1)  # rays of walking warps
        item = order[row[w], k].long()
        enter = wl._cluster_cull(ro[w], inv_w[w], tmin[w],
                                 torch.minimum(tmax[w], best[w]),
                                 tables.wi_bbox[item])
        voting = warps_of(w[enter])
        count["votes"] += voting.sum()
        keep = voting[warp[w]]  # warps with no entering ray skip the item
        w, item, enter = w[keep], item[keep], enter[keep]
        if w.numel() == 0:
            continue
        sc = tables.wi_sup[item].long()
        inst = tables.wi_inst[item]
        xf = tables.inst_rows[inst.long()]
        touched_sup[sc[enter]] = True
        touched_inst[inst[enter].long()] = True
        so, sd = _to_shape_space(ro[w], rd[w], xf)
        inv = wl._inverse_dir(sd)
        tmin_w, tmax_w, b = tmin[w], tmax[w], best[w]
        boxes = bbox[sc]  # [w, sup, 8]
        start = enter[:, None] & _cull_all(so, inv, tmin_w,
                                           torch.minimum(tmax_w, b), boxes)
        ri, ci = torch.nonzero(start, as_tuple=True)
        if ri.numel() == 0:
            continue
        c = tables.tab[sc[ri] * sup + ci]
        found, arg, t, u, v = wl._closest_tri(so[ri], sd[ri], tmin_w[ri],
                                              b[ri], c)
        ns = c.gather(2, arg[:, None, None].expand(-1, wl.ROWS, 1))[:, 12:15, 0]
        fx = xf[ri]
        # shape -> world normal: n_w = n_s R
        nw_ = torch.stack([(ns[:, 0] * fx[:, 12 + j] + ns[:, 1] * fx[:, 15 + j])
                           + ns[:, 2] * fx[:, 18 + j] for j in range(3)], dim=-1)

        def dense(x, fill):
            out = torch.full((w.numel(), sup) + x.shape[1:], fill,
                             dtype=x.dtype, device=dev)
            out[ri, ci] = x
            return out

        found_c, t_c, u_c, v_c = (dense(found, False), dense(t, 0.0),
                                  dense(u, 0.0), dense(v, 0.0))
        arg_c, n_c = dense(arg, 0), dense(nw_, 0.0)
        real_c = dense(wl.real_tris(c), 0)
        bw_u, bw_v, bw_n = bu[w], bv[w], bn[w]
        bw_tri, bw_inst = best_tri[w], binst[w]
        for j in torch.unique(ci).tolist():
            want = start[:, j] & wl._cluster_cull(
                so, inv, tmin_w, torch.minimum(tmax_w, b), boxes[:, j])
            take = want & found_c[:, j] & (t_c[:, j] < b)
            count["pairs"] += want.sum()
            count["tri_slots"] += real_c[:, j][want].sum()
            count["warp_pairs"] += warps_of(w[want]).sum()
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
    work.update(groups=groups, clusters=int(touched.sum()),
                supers=int(touched_sup.sum()),
                instances=int(touched_inst.sum()))
    prim = torch.where(best_tri >= 0, best_tri // 2, -1)
    prim = torch.where(prim >= tables.n_prims, -1, prim).to(torch.int32)
    hit = prim >= 0
    t = torch.where(hit, best, tmax)
    pos = ro + t[:, None] * rd
    return Hit(hit, prim, bu, bv, t, pos, bn, binst), work


def instanced_intersect_kernel(tables: InstancedDeviceTables, ro, rd, tmin,
                               tmax, order, tlow, cnt,
                               group: int = GROUP_RAYS) -> Hit:
    """Launch csrc/instanced_intersect.cu on CUDA tensors (raises
    otherwise) -> Hit with the unnormalised world normal."""
    if ro.device.type != "cuda":
        raise ValueError(f"instanced_intersect_kernel: {ro.device} is not a "
                         "CUDA device")
    wl.check_group(group)
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    c_total, items = tables.tab.shape[0], tables.wi_sup.shape[0]
    ng = max(1, -(-n // group))
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
    wl._check(tables.wi_bbox, f32, (items, 6), dev, "wi_bbox")
    wl._check(order, i32, (ng, items), dev, "order")
    wl._check(tlow, f32, (ng, items), dev, "tlow")
    wl._check(cnt, i32, (ng,), dev, "cnt")
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
        tables.wi_inst.data_ptr(), tables.wi_bbox.data_ptr(),
        order.data_ptr(), tlow.data_ptr(), cnt.data_ptr(), items, tables.sup,
        group, tables.n_prims, prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        t.data_ptr(), pos.data_ptr(), nrm.data_ptr(), inst.data_ptr(),
        cuda_build.stream_handle(dev),
    )
    cuda_build.check(err, "instanced_intersect")
    if n:  # the launcher launches nothing for no rays
        instanced_intersect_kernel.launches += 1
    return Hit(prim >= 0, prim, u, v, t, pos, nrm, inst)


instanced_intersect_kernel.launches = 0


def _cull_lib():
    lib = cuda_build.load("candidate_cull", FLAGS)
    fn = lib.candidate_cull_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = cuda_build.load("instanced_intersect", FLAGS)
    fn = lib.instanced_intersect_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, p, p, p, p, i, i, i, i,
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
    items: precull, then the plain versions for CPU tensors or the kernels
    for CUDA tensors, with candidate lists per GROUP_RAYS rays; prim ids
    in the padded shape-space eval layout."""
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
