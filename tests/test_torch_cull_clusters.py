"""The candidate cull's two levels on the CPU (ops/instanced_intersect.py
item_clusters, cluster_pass_plain): each cluster's box holds its items'
boxes bit for bit and the slots are a permutation of the items; a group
that enters an item may enter the item's cluster; and keys folded only
over the rays that may enter the root and the item's cluster, only for
items of clusters the group may enter (what csrc/candidate_cull.cu
computes), equal the plain keys of every (ray, item) pair, so the lists
are the plain lists. On the reduced instanced scene, a hybrid's work
items, the sphereflake at size factor 2 and 1,500 random boxes, with dead
lanes, a ragged last group and rays with NaN and infinite 1 / d."""

import pytest
import torch

from julia_raytracer_tpu_torch.ops import instanced_intersect as ii
from julia_raytracer_tpu_torch.ops import worklist_intersect as wl
from julia_raytracer_tpu_torch.render import scene_device
from julia_raytracer_tpu_torch.render.scene_device import build_device_scene
from julia_raytracer_tpu_torch.testing import (
    cull_boxes, cull_rays, hybrid_scene, instanced_scene, same_lists,
    sphereflake_scene,
)
from julia_raytracer_tpu_torch.utils import timing

CASES = ("instanced", "hybrid", "sphereflake", "random")
N_RAYS = 3000  # a ragged last group at every group size


def _boxes(case, monkeypatch):
    if case == "random":
        return cull_boxes(1500, seed=4)
    if case == "sphereflake":
        monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
        scene, kw = sphereflake_scene(2, 4), dict(hybrid_budget=8)
    elif case == "hybrid":
        scene, kw = hybrid_scene(4, 4, 3, 12), dict(instancing=True,
                                                    hybrid_budget=300)
    else:
        scene, kw = instanced_scene(3, (8, 6)), dict(instancing=True,
                                                     hybrid_budget=0)
    _, cfg = build_device_scene(scene, device="cpu", **kw)
    return ii.upload(cfg.inst_tables, "cpu").wi_bbox


def _rays(cl, seed):
    lo, hi = cl.root[:3], cl.root[3:]
    pad = (hi - lo) * 0.25
    return cull_rays((lo - pad).tolist(), (hi + pad).tolist(), N_RAYS, seed)


def _cluster_of_items(cl):
    out = torch.empty_like(cl.slot_item, dtype=torch.int64)
    out[cl.slot_item.long()] = torch.arange(len(cl.slot_item)) // ii.CLUSTER_ITEMS
    return out


@pytest.mark.parametrize("case", CASES)
def test_cluster_boxes_hold_their_items(case, monkeypatch):
    boxes = _boxes(case, monkeypatch)
    cl = ii.item_clusters(boxes)
    items = boxes.shape[0]
    nc = -(-items // ii.CLUSTER_ITEMS)
    assert cl.cluster_boxes.shape == (nc, 6) and cl.root.shape == (6,)
    assert torch.equal(torch.sort(cl.slot_item.long()).values,
                       torch.arange(items))
    assert torch.equal(cl.slot_boxes, boxes[cl.slot_item.long()])
    lo = torch.minimum(boxes[:, :3], boxes[:, 3:])
    hi = torch.maximum(boxes[:, :3], boxes[:, 3:])
    c = _cluster_of_items(cl)
    assert bool((cl.cluster_boxes[c, :3] <= lo).all())
    assert bool((cl.cluster_boxes[c, 3:] >= hi).all())
    # the union itself: each bound is some item's bound, exactly
    for k in range(nc):
        mine = c == k
        assert torch.equal(cl.cluster_boxes[k, :3], lo[mine].amin(dim=0))
        assert torch.equal(cl.cluster_boxes[k, 3:], hi[mine].amax(dim=0))
    assert torch.equal(cl.root[:3], lo.amin(dim=0))
    assert torch.equal(cl.root[3:], hi.amax(dim=0))
    if case in ("sphereflake", "random"):
        assert nc > 1
        # Morton order: clusters are smaller than the world
        size = (cl.cluster_boxes[:, 3:] - cl.cluster_boxes[:, :3]).prod(dim=1)
        assert float(size.median()) < float((cl.root[3:] - cl.root[:3]).prod())


@pytest.mark.parametrize("group", [32, 256, 1024])
@pytest.mark.parametrize("case", CASES)
def test_two_level_cull_keeps_the_plain_lists(case, group, monkeypatch):
    boxes = _boxes(case, monkeypatch)
    cl = ii.item_clusters(boxes)
    rays = _rays(cl, seed=group)
    keys = ii.candidate_keys_plain(*rays, boxes, group)
    entered, counts = ii.cluster_pass_plain(*rays, cl, group)
    ng, items = keys.shape
    c = _cluster_of_items(cl)
    finite = torch.isfinite(keys)
    assert bool(finite.any())
    if group == 32:
        assert not bool(finite.all()), "the cull drops some pairs"
    # every candidate lies in a cluster its group may enter
    assert bool(entered[:, c][finite].all())
    # keys folded over the rays that may enter the root and the cluster
    pr = wl.pad_rays(*rays, group)
    inv = wl._inverse_dir(pr[1])
    live = ii._may_enter(pr[0], inv, pr[2], pr[3], cl.root[None])[:, 0]
    votes = ii._may_enter(pr[0], inv, pr[2], pr[3], cl.cluster_boxes) & live[:, None]
    entry = ii._group_keys(*pr, boxes, 1)  # [rays, items]: no fold
    folded = torch.where(votes[:, c], entry, float("inf"))
    folded = folded.view(ng, group, items).amin(dim=1)
    folded = torch.where(entered[:, c], folded, float("inf"))
    assert torch.equal(folded.view(torch.int32), keys.view(torch.int32))
    # the lists from those keys are the plain lists
    order = torch.argsort(folded, dim=1, stable=True)
    mine = (order.to(torch.int32), folded.gather(1, order),
            torch.isfinite(folded).sum(dim=1, dtype=torch.int32))
    assert same_lists(mine, ii.precull(*rays, cl, group))
    # the kernel's counters
    per = torch.bincount(c, minlength=entered.shape[1])
    assert int(counts["tested"]) == int((entered * per).sum())
    assert int(counts["cluster_tests"]) == int(live.sum()) * entered.shape[1]
    assert int(counts["item_tests"]) == int(votes.sum(dim=0) @ per)
    if group == 32 and entered.shape[1] > 1:  # the clusters prune
        assert int(counts["tested"]) < ng * items


def test_precull_span_counts_tested_and_spills():
    boxes = cull_boxes(300, seed=1)
    cl = ii.item_clusters(boxes)
    rays = _rays(cl, seed=2)
    timing.reset()
    with timing.span("frame"):
        lists = ii.precull(*rays, cl, 32)
    (row,) = [r for p, r in timing.units()[-1]["table"].items()
              if p.endswith("/precull")]
    _, counts = ii.cluster_pass_plain(*rays, cl, 32)
    assert row["tested"] == int(counts["tested"]) > 0
    assert row["spills"] == 0
    assert row["candidates"] == int(lists[2].sum())
    assert row["keys"] == row["groups"] * row["items"] == lists[0].numel()
    assert row["tested"] < row["keys"]



def test_tested_share_reader(monkeypatch):
    """benchmark/metrics/cull_tested_share.render.py over the frames of a
    tiny sphereflake render on the CPU (size factor 2, forced through the
    cell's route): 100 x tested / keys of the precull spans, in (0, 100];
    None for frames without a precull (Cornell) and for precull spans
    without a `tested` count (a program before the count)."""
    from types import SimpleNamespace

    from benchmark import run
    from julia_raytracer_tpu_torch.render.renderer import (
        Params, Renderer, make_trace_state,
    )

    monkeypatch.setattr(scene_device, "_should_instance", lambda s: True)
    scene = sphereflake_scene(2, 4)
    params = Params(resolution=16, samples=1, batch=1, bounces=4,
                    hybrid_budget=8)
    r = Renderer(scene, params, device="cpu")
    timing.reset()
    r.trace_samples(make_trace_state(scene, params, device="cpu"))
    read = run.load_reader("cull_tested_share.render")
    window = SimpleNamespace(traffic={"mode": "render"}, t_start=0.0,
                             end_to_end={"setup_s": 0.0})
    units = timing.units()
    rows = [row for u in units for p, row in u["table"].items()
            if p.endswith("/precull")]
    keys = sum(row["keys"] for row in rows)
    share = read(window)
    assert 0 < share <= 100
    assert share == 100.0 * sum(row["tested"] for row in rows) / keys
    for row in rows:
        del row["tested"]
    monkeypatch.setattr(timing, "units", lambda: units)
    assert read(window) is None
    monkeypatch.setattr(timing, "units", lambda: [
        dict(u, table={p: v for p, v in u["table"].items()
                       if "/intersect/" not in p}) for u in units])
    assert read(window) is None
