"""Two-level instanced intersector: the candidate cull, the wrappers of
csrc/candidate_cull.cu and csrc/instanced_intersect.cu and their plain
PyTorch versions.

Replaces make_cluster_intersect_instanced: its Pallas TPU kernel
_make_kernel_instanced and its fused-jnp candidate cull beam_precull
(julia_raytracer_tpu/ops/pallas_cluster.py).

  upload: the InstancedTables of scene/instanced.py on the device, tab as
    [total_sup*sup, 16, 128] and bbox as [total_sup*sup, 8], with the
    work items' clusters (item_clusters).
  item_clusters: the work items in Morton order of their box centres, cut
    into clusters of CLUSTER_ITEMS consecutive items, each with the union
    of its items' boxes (exact float32 min/max), and the root box over
    all. A ray's slab interval for a cluster's box holds its interval for
    every item in it (the slab arithmetic is monotone in the corners), so
    a group that enters no cluster enters none of its items, bit for bit.
  candidate_keys_plain: per group of `group` rays (GROUP_RAYS = 256 by
    default; the JAX package's 1,024 in the tests) and per work item, the
    nearest entry of any of the group's rays into the item's world box (an
    exact slab test of every ray against every item, the JAX
    `beam_precull`), +inf where none enters, computed from [rays, items]
    temporaries in chunks of groups. cluster_pass_plain: which clusters
    each group may enter and what the kernel tests.
  precull: each group's candidate items ordered by key, then item (what a
    stable sort of the keys gives), the sorted keys (t_low) and their
    count; on the rays' device, nothing read back. For CPU tensors the
    plain keys and a stable torch.argsort; for CUDA tensors
    candidate_lists_kernel, one launch that culls by cluster, then by
    item, and sorts each group's candidates on chip. The two agree bit
    for bit on order[:, :cnt], tlow[:, :cnt] and cnt; entries past cnt
    are unspecified and never read.
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
tensors, and normalises the rotated normals. The precull and the walk
are timed by the spans `precull` and `inst_walk` (utils/timing.py
device_span: device time by %globaltimer stamps at the span's ends, in an
eager body or a captured one, and the cull's counts). ops/curve_intersect.py
runs the same precull over the curve elements' boxes.
`candidate_lists_kernel.launches` and `instanced_intersect_kernel.launches`
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
from julia_raytracer_tpu_torch.ops.traversal import Hit, Intersector
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

WARP = wl.WARP  # rays of a walking warp
# rays per candidate list (the JAX package's: 1,024). With the cull in two
# levels the sum of the precull and the kernel on an H100 is least at 32
# on bounce rays (chip_smoke.py's group sweep, PERF.md section 6), but
# order and tlow are [groups, items]: 256 keeps them to 0.73 GB for a
# 1M-lane body of the 22,143-item sphereflake
GROUP_RAYS = 256
SLACK = wl.SLACK
# [rays, items] float temporaries of the plain cull above this many bytes
# are cut into chunks of groups (six of them are live at once)
PRECULL_BYTES = 1.5e9
FLAGS = ("-fmad=false",)
# work items a cluster of the cull: one a lane of a warp (kClusterItems
# in csrc/candidate_cull.cu)
CLUSTER_ITEMS = 32
# candidates a group sorts in shared memory; a group with more spills to
# its rows of order and tlow and is sorted there (kListCap)
LIST_CAP = 2048


class ItemClusters(NamedTuple):
    boxes: torch.Tensor  # f32 [items, 6] world boxes, in item order
    slot_item: torch.Tensor  # i32 [items] the item in each slot
    slot_boxes: torch.Tensor  # f32 [items, 6] boxes[slot_item]
    cluster_boxes: torch.Tensor  # f32 [clusters, 6] union of its slots' boxes
    root: torch.Tensor  # f32 [6] union of every box


class InstancedDeviceTables(NamedTuple):
    tab: torch.Tensor  # f32 [total_sup*sup, 16, 128] shape-space tables
    bbox: torch.Tensor  # f32 [total_sup*sup, 8] cluster boxes
    inst_rows: torch.Tensor  # f32 [I, 24]
    wi_sup: torch.Tensor  # i32 [items]
    wi_inst: torch.Tensor  # i32 [items]
    wi_bbox: torch.Tensor  # f32 [items, 6] world boxes
    n_prims: int  # padded shape-space prim count
    sup: int
    clusters: ItemClusters  # the work items' clusters, for the cull


def _morton(q):
    """int64 [n, 3] coordinates in [0, 1024) -> 30-bit Morton codes."""
    code = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return code


def item_clusters(boxes) -> ItemClusters:
    """World boxes [items, >= 6] -> their clusters (module docstring), on
    the boxes' device. Slots follow the Morton order of the box centres
    (ties by item); slot s is in cluster s // CLUSTER_ITEMS. A cluster's
    box is the union of its items' boxes taken per axis as [min(lo, hi),
    max(lo, hi)], the interval a slab test of a box sees; a NaN corner
    makes the union NaN, which the cull lets pass."""
    boxes = boxes[:, :6].to(torch.float32).contiguous()
    items, dev = boxes.shape[0], boxes.device
    lo = torch.minimum(boxes[:, :3], boxes[:, 3:])
    hi = torch.maximum(boxes[:, :3], boxes[:, 3:])
    centre = torch.nan_to_num((lo.double() + hi.double()) * 0.5, nan=0.0,
                              posinf=0.0, neginf=0.0)
    if items:
        c0 = centre.amin(dim=0)
        extent = (centre.amax(dim=0) - c0).clamp_min(1e-30)
        q = ((centre - c0) / extent * 1023).round().long().clamp_(0, 1023)
        slot_item = torch.argsort(_morton(q), stable=True)
    else:
        slot_item = torch.zeros(0, dtype=torch.int64, device=dev)
    nc = -(-items // CLUSTER_ITEMS)
    pad = nc * CLUSTER_ITEMS - items
    inf = float("inf")
    s_lo = torch.cat([lo[slot_item], torch.full((pad, 3), inf, device=dev)])
    s_hi = torch.cat([hi[slot_item], torch.full((pad, 3), -inf, device=dev)])
    c_lo = s_lo.view(nc, CLUSTER_ITEMS, 3).amin(dim=1)
    c_hi = s_hi.view(nc, CLUSTER_ITEMS, 3).amax(dim=1)
    root = (torch.cat([c_lo.amin(dim=0), c_hi.amax(dim=0)]) if nc
            else torch.tensor([inf] * 3 + [-inf] * 3, device=dev))
    return ItemClusters(
        boxes=boxes, slot_item=slot_item.to(torch.int32),
        slot_boxes=boxes[slot_item].contiguous(),
        cluster_boxes=torch.cat([c_lo, c_hi], dim=1).contiguous(),
        root=root.contiguous())


def as_clusters(items) -> ItemClusters:
    """An ItemClusters as it is; world boxes [items, >= 6] clustered."""
    return items if isinstance(items, ItemClusters) else item_clusters(items)


def upload(tables, device) -> InstancedDeviceTables:
    """scene/instanced.py InstancedTables -> tensors on `device`, the work
    items clustered on the host."""
    sup = tables.sup

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype).contiguous().to(device)

    wi_bbox = put(tables.wi_bbox.reshape(-1, 6), torch.float32)
    cl = item_clusters(torch.as_tensor(tables.wi_bbox.reshape(-1, 6),
                                       dtype=torch.float32))
    return InstancedDeviceTables(
        tab=put(tables.tab.reshape(-1, wl.ROWS, TRIS), torch.float32),
        bbox=put(tables.bbox.reshape(-1, 8), torch.float32),
        inst_rows=put(tables.inst_rows, torch.float32),
        wi_sup=put(tables.wi_sup, torch.int32),
        wi_inst=put(tables.wi_inst, torch.int32),
        wi_bbox=wi_bbox,
        n_prims=int(tables.n_prims),
        sup=sup,
        clusters=ItemClusters(wi_bbox, *(x.to(device) for x in cl[1:])),
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
    """The cull's keys in plain PyTorch: rays ro/rd [N, 3], tmin/tmax
    [N], boxes [items, >= 6] (min xyz, max xyz) -> keys [ceil(N / group),
    items] f32."""
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


def candidate_lists_plain(ro, rd, tmin, tmax, boxes,
                          group: int = GROUP_RAYS):
    """precull's lists from candidate_keys_plain and a stable
    torch.argsort, on the rays' device -> (order [ng, items] i32, tlow
    [ng, items] f32, cnt [ng] i32), every entry defined (past cnt: the
    items of +inf keys in item order)."""
    keys = candidate_keys_plain(ro, rd, tmin, tmax, boxes, group)
    order = torch.argsort(keys, dim=1, stable=True)
    return (order.to(torch.int32), keys.gather(1, order),
            torch.isfinite(keys).sum(dim=1, dtype=torch.int32))


def _may_enter(o, inv, tmin, tlim, boxes):
    """[r] rays against every box of [k, 6] -> [r, k]: whether a ray may
    enter a box, the slab test of slab_enter_exit with its compare negated
    so that a NaN passes (may_enter in csrc/candidate_cull.cu)."""
    t0 = (boxes[None, :, 0:3] - o[:, None]) * inv[:, None]
    t1 = (boxes[None, :, 3:6] - o[:, None]) * inv[:, None]
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    exit_ = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    enter = torch.maximum(enter, tmin[:, None])
    exit_ = torch.minimum(exit_, tlim[:, None])
    return ~(enter > exit_ * SLACK)


def cluster_pass_plain(ro, rd, tmin, tmax, items, group: int = GROUP_RAYS):
    """The kernel's first level in plain PyTorch, over groups of `group`
    rays padded as candidate_keys_plain pads them; items: an ItemClusters
    or world boxes. -> (entered [groups, clusters] bool: some ray of the
    group that may enter the root box may enter the cluster's box;
    counts): the kernel's counters as int64 tensors: `tested` the (group,
    item) pairs it slab-tests (the items of entered clusters),
    `cluster_tests` its (ray, cluster) tests (the rays that may enter the
    root box, against every cluster), `item_tests` its (ray, item) tests
    (the rays that may enter a cluster, against its items)."""
    wl.check_group(group)
    cl = as_clusters(items)
    ro, rd, tmin, tmax = wl.pad_rays(ro, rd, tmin, tmax, group)
    ng, nc = ro.shape[0] // group, cl.cluster_boxes.shape[0]
    per = (cl.slot_item.shape[0]
           - torch.arange(nc, device=ro.device) * CLUSTER_ITEMS).clamp(
               max=CLUSTER_ITEMS)  # items in each cluster
    inv = wl._inverse_dir(rd)
    live = _may_enter(ro, inv, tmin, tmax, cl.root[None])[:, 0]
    chunk = max(1, int(PRECULL_BYTES // (6 * group * max(nc, 1) * 4)))
    entered, rays_in = [], []
    for g0 in range(0, ng, chunk):
        s = slice(g0 * group, (g0 + chunk) * group)
        m = (_may_enter(ro[s], inv[s], tmin[s], tmax[s], cl.cluster_boxes)
             & live[s, None]).view(-1, group, nc)
        entered.append(m.any(dim=1))
        rays_in.append(m.sum(dim=1))
    entered = torch.cat(entered)
    return entered, dict(tested=(entered * per).sum(),
                         cluster_tests=live.sum() * nc,
                         item_tests=(torch.cat(rays_in) * per).sum())


COUNTERS = ("tested", "spills", "cluster_tests", "item_tests")


def candidate_lists_kernel(ro, rd, tmin, tmax, clusters: ItemClusters,
                           group: int = GROUP_RAYS):
    """Launch csrc/candidate_cull.cu on CUDA tensors (raises otherwise):
    precull's lists (order, tlow, cnt) from one launch of a CTA a group,
    nothing read back and every shape fixed by the inputs', and counts,
    the kernel's COUNTERS as 0-d int64 tensors on the device (those of
    cluster_pass_plain, and `spills`, the groups with more than LIST_CAP
    candidates)."""
    if ro.device.type != "cuda":
        raise ValueError(f"candidate_lists_kernel: {ro.device} is not a "
                         "CUDA device")
    wl.check_group(group)
    n, dev, f32, i32 = ro.shape[0], ro.device, torch.float32, torch.int32
    items, nc = clusters.slot_item.shape[0], clusters.cluster_boxes.shape[0]
    wl._check(ro, f32, (n, 3), dev, "ro")
    wl._check(rd, f32, (n, 3), dev, "rd")
    wl._check(tmin, f32, (n,), dev, "tmin")
    wl._check(tmax, f32, (n,), dev, "tmax")
    wl._check(clusters.slot_item, i32, (items,), dev, "slot_item")
    wl._check(clusters.slot_boxes, f32, (items, 6), dev, "slot_boxes")
    wl._check(clusters.cluster_boxes, f32, (nc, 6), dev, "cluster_boxes")
    wl._check(clusters.root, f32, (6,), dev, "root")
    ng = max(1, -(-n // group))
    order = torch.empty((ng, items), dtype=i32, device=dev)
    tlow = torch.empty((ng, items), dtype=f32, device=dev)
    cnt = torch.empty(ng, dtype=i32, device=dev)
    counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    err = _cull_lib().candidate_cull_launch(
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        clusters.root.data_ptr(), clusters.cluster_boxes.data_ptr(), nc,
        clusters.slot_boxes.data_ptr(), clusters.slot_item.data_ptr(), items,
        group, order.data_ptr(), tlow.data_ptr(), cnt.data_ptr(),
        counters.data_ptr(), cuda_build.stream_handle(dev))
    cuda_build.check(err, "candidate_cull")
    if n and items:  # the launcher launches nothing for no rays or items
        candidate_lists_kernel.launches += 1
    else:
        cnt.zero_()
    return order, tlow, cnt, dict(zip(COUNTERS, counters.unbind()))


timing.counter(candidate_lists_kernel, "launches")


def precull(ro, rd, tmin, tmax, items, group: int = GROUP_RAYS):
    """Candidate items of each group of `group` rays, front to back:
    (order [ng, items] i32, tlow [ng, items] f32, cnt [ng] i32), of which
    order[:, :cnt] and tlow[:, :cnt] hold the items with a finite key in
    the order of (key, item), which a stable sort of the keys gives, and
    their keys. items: the work items' ItemClusters, or their world boxes
    [items, >= 6] (clustered here). candidate_lists_plain for CPU tensors,
    candidate_lists_kernel for CUDA tensors. A `precull` span
    (utils/timing.py device_span) covers it: `groups`, `items`, `keys`
    (their product), and tensors read when the units are: `candidates`
    (the sum of cnt), `tested` and `spills` (the kernel's counters; on
    the CPU cluster_pass_plain's `tested` and the groups past
    LIST_CAP)."""
    cl = as_clusters(items)
    ng, n_items = max(1, -(-ro.shape[0] // group)), cl.boxes.shape[0]
    with timing.device_span("precull", ro.device, groups=ng, items=n_items,
                            keys=ng * n_items) as sp:
        with roofline.kernel_region() as counter:
            if ro.device.type == "cpu":
                order, tlow, cnt = candidate_lists_plain(ro, rd, tmin, tmax,
                                                         cl.boxes, group)
                counts = cluster_pass_plain(ro, rd, tmin, tmax, cl, group)[1]
                counts["spills"] = (cnt > LIST_CAP).sum()
            else:
                order, tlow, cnt, counts = candidate_lists_kernel(
                    ro, rd, tmin, tmax, cl, group)
            if counter is not None:
                counter.add_kernel("candidate_cull", kf.candidate_cull_cost(
                    ro.shape[0], ng, group, n_items,
                    cl.cluster_boxes.shape[0], int(counts["cluster_tests"]),
                    int(counts["item_tests"]), int(cnt.sum())))
        sp.add(candidates=cnt.sum(dtype=torch.int64), tested=counts["tested"],
               spills=counts["spills"])
    return order, tlow, cnt


def _to_shape_space(ro, rd, xf):
    """World rays -> shape space by the instance rows xf [n, 24]
    (obj = world Ri + oi), in the kernel's arithmetic order."""
    def row(v, j):
        return (v[:, 0] * xf[:, j] + v[:, 1] * xf[:, 3 + j]) + v[:, 2] * xf[:, 6 + j]

    so = torch.stack([row(ro, j) + xf[:, 9 + j] for j in range(3)], dim=-1)
    sd = torch.stack([row(rd, j) for j in range(3)], dim=-1)
    return so, sd


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
        start = enter[:, None] & wl.cull_all(so, inv, tmin_w,
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


timing.counter(instanced_intersect_kernel, "launches")


def _cull_lib():
    lib = cuda_build.load("candidate_cull", FLAGS)
    fn = lib.candidate_cull_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, i, p, p, i, i, p, p, p, p, p]
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


def needed_work(tables: InstancedDeviceTables, ro, rd, tmin, t_hit, order,
                cnt, group: int = GROUP_RAYS) -> dict:
    """What a walk over these candidate lists needs, with each ray's
    closest hit t_hit (the hit's t, tmax for a miss) as its bound: the
    (warp, item) steps in which some ray of the warp enters the item's
    world box before t_hit (`steps`), the (ray, cluster) pairs whose
    shape-space box the entering rays enter before t_hit (`pairs`), and
    the distinct clusters, superclusters and instances among those pairs
    (`clusters`, `supers`, `instances`). The kernel's walk against its
    running best does at least this (instanced_intersect_plain's work)."""
    n, dev, sup = ro.shape[0], ro.device, tables.sup
    inv_w = wl._inverse_dir(rd)
    bbox = tables.bbox.view(-1, sup, 8)
    touched = torch.zeros(bbox.shape[0] * sup, dtype=torch.bool, device=dev)
    touched_sup = torch.zeros(bbox.shape[0], dtype=torch.bool, device=dev)
    touched_inst = torch.zeros(tables.inst_rows.shape[0], dtype=torch.bool,
                               device=dev)
    cl_of = torch.arange(sup, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    n_items = max(order.shape[1], 1)
    for rays, k in wl.list_entries(cnt, group, n):
        item = order[rays // group, k].long()
        enter = wl._cluster_cull(ro[rays], inv_w[rays], tmin[rays],
                                 t_hit[rays], tables.wi_bbox[item])
        rays, k, item = rays[enter], k[enter], item[enter]
        steps += torch.unique((rays // WARP) * n_items + k).numel()
        step = max(1, wl.COUNT_TESTS // sup)
        for r, it in zip(rays.split(step), item.split(step)):
            sc, inst = tables.wi_sup[it].long(), tables.wi_inst[it].long()
            so, sd = _to_shape_space(ro[r], rd[r], tables.inst_rows[inst])
            want = wl.cull_all(so, wl._inverse_dir(sd), tmin[r], t_hit[r],
                               bbox[sc])
            pairs += want.sum()
            touched[(sc[:, None] * sup + cl_of)[want]] = True
            any_c = want.any(dim=1)
            touched_sup[sc[any_c]] = True
            touched_inst[inst[any_c]] = True
    return dict(steps=int(steps), pairs=int(pairs),
                clusters=int(touched.sum()), supers=int(touched_sup.sum()),
                instances=int(touched_inst.sum()))


def call_cost(tables: InstancedDeviceTables, ro, rd, tmin, t_hit, order, cnt,
              group: int = GROUP_RAYS) -> dict:
    """kernel_flops.instanced_intersect_cost of one call (needed_work)."""
    w = needed_work(tables, ro, rd, tmin, t_hit, order, cnt, group)
    return kf.instanced_intersect_cost(
        ro.shape[0], cnt.shape[0], w["steps"], w["supers"], tables.sup,
        w["instances"], w["clusters"], w["pairs"])


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
    lists = precull(ro, rd, tmin, tmax, tables.clusters)
    with roofline.kernel_region() as counter:
        with timing.device_span("inst_walk", ro.device):
            if ro.device.type == "cpu":
                hit = instanced_intersect_plain(tables, ro, rd, tmin, tmax,
                                                *lists)[0]
            else:
                hit = instanced_intersect_kernel(tables, ro, rd, tmin, tmax,
                                                 *lists)
        if counter is not None:
            counter.add_kernel("instanced_intersect", call_cost(
                tables, ro, rd, tmin, hit.t, lists[0], lists[2]))
    return normalize_normal(hit)


def make_instanced_intersect(tables, device, diff) -> Intersector:
    """The Intersector over the work items of a scene/instanced.py
    InstancedTables, on `device`; `diff(intersect, inst_rows)` makes its
    fixed-trip form, which re-tests a hit in its instance's shape space
    (ops/diff_hit.py instanced_diff, which imports this module). It is
    `graph_safe`: on the card both kernels allocate at shapes fixed by
    the inputs' and read nothing back, and the spans record into a
    capture's record (utils/timing.py CapturedSpans)."""
    dt = upload(tables, device)

    def intersect(ro, rd, tmin, tmax):
        return instanced_intersect(dt, ro, rd, tmin, tmax)

    return Intersector(intersect, graph_safe=True, tables=dt,
                       diff=diff(intersect, dt.inst_rows))
