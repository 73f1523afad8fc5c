"""Roofline accounting of the port on an NVIDIA H100 (port of
julia_raytracer_tpu/utils/roofline.py).

Peaks: the H100 SXM data sheet's 67 TFLOP/s of fp32 outside the tensor
cores (no operation of the path runs on them) and 3.35 TB/s of HBM
(H100_PEAK_FLOPS, H100_PEAK_HBM). Rates assume the card's full 700 W;
state a share beside the card's power limit.

  bound(n_bytes, n_ops): the least time the card could take for a call,
    the larger of its bytes over the HBM rate and its fp32 operations
    over the fp32 rate, always at the data sheet's peaks.
  roofline(flops, bytes, wall_s): the JAX package's utilization dict, over
    peaks that JRT_PEAK_TFLOPS and JRT_PEAK_HBM_GBS override as in the JAX
    package (read at each call; the note names the peaks used).
  count_cost(fn, *args): runs fn under a TorchDispatchMode that counts
    every ATen op it issues (the JAX package's `compiled_cost` over XLA's
    cost analysis has no PyTorch counterpart): 1 flop per output element
    of a pointwise op, the input elements of a reduction or scan, 2MNK of
    a matrix product, 0 of the rest; each tensor input's elements read
    once and each output's written once, at the element size; views cost
    nothing. It keeps a table by op name (calls, flops, bytes).
  kernel_region(): the hand-written kernels are ctypes calls, invisible to
    the mode, so each function that chooses between a kernel and its plain
    version runs either inside this region and reports the call's cost
    model (utils/kernel_flops.py) to the active counter; the counter
    ignores the ATen ops of a plain version (and of the count) inside the
    region, so the CPU and the card count the same.

The counter is on only inside count_cost: elsewhere kernel_region is a
null context and no op pays for it.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

H100_PEAK_FLOPS = 67e12  # fp32 outside the tensor cores, SXM data sheet
H100_PEAK_HBM = 3.35e12  # HBM3 bytes/s, SXM data sheet

_MFU_NOTE = (
    "flops/bytes from count_cost: the ATen ops of one sample counted by a "
    "TorchDispatchMode (1 flop per pointwise output element, the input "
    "elements of a reduction, 2MNK a matrix product; each input read and "
    "each output written once) plus each hand-written kernel's model "
    "(utils/kernel_flops.py, what the call's inputs need); peaks "
    "{tflops:g} TFLOP/s fp32 and {gbs:g} GB/s HBM ({source})"
)


def peaks() -> tuple[float, float, str]:
    """(flops/s, bytes/s, source) for roofline(): the H100 SXM data
    sheet's, or JRT_PEAK_TFLOPS / JRT_PEAK_HBM_GBS where set."""
    tf, gbs = os.environ.get("JRT_PEAK_TFLOPS"), os.environ.get(
        "JRT_PEAK_HBM_GBS")
    source = ("H100 SXM data sheet" if tf is None and gbs is None
              else "JRT_PEAK_TFLOPS/JRT_PEAK_HBM_GBS")
    return (float(tf) * 1e12 if tf is not None else H100_PEAK_FLOPS,
            float(gbs) * 1e9 if gbs is not None else H100_PEAK_HBM, source)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the fp32 rate."""
    t_bytes, t_ops = n_bytes / H100_PEAK_HBM, n_ops / H100_PEAK_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def roofline(flops_total: float, bytes_total: float, wall_s: float) -> dict:
    """Utilization dict for `flops_total`/`bytes_total` of work done in
    `wall_s` seconds on one card (the JAX package's keys)."""
    out = {}
    if wall_s <= 0:
        return out
    peak_flops, peak_hbm, source = peaks()
    if flops_total:
        achieved = flops_total / wall_s
        out["achieved_gflops"] = round(achieved / 1e9, 2)
        out["mfu"] = round(achieved / peak_flops, 6)
    if bytes_total:
        bw = bytes_total / wall_s
        out["hbm_gbs"] = round(bw / 1e9, 2)
        out["hbm_util"] = round(bw / peak_hbm, 4)
    if out:
        out["mfu_note"] = _MFU_NOTE.format(
            tflops=peak_flops / 1e12, gbs=peak_hbm / 1e9, source=source)
    return out


# ops whose work is their input elements (reductions and scans)
REDUCTIONS = frozenset((
    "sum", "nansum", "mean", "prod", "amax", "amin", "max", "min", "argmax",
    "argmin", "any", "all", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "std_mean", "logsumexp", "cumsum", "cumprod", "cummax",
    "cummin", "count_nonzero", "aminmax",
))
# matrix products: 2 x output elements x the first matrix's last dimension
# (the argument index of that matrix)
MATMULS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
           "addmm": 1, "baddbmm": 1, "addmv": 1, "addbmm": 1}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(flops, bytes) of one ATen op by count_cost's rules."""
    if _is_view(func):
        return 0.0, 0.0
    name = func.overloadpacket.__name__
    ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
    outs = _tensors(out)
    nbytes = float(sum(t.numel() * t.element_size() for t in ins + outs))
    if torch.Tag.pointwise in func.tags:
        flops = float(sum(t.numel() for t in outs))
    elif name in REDUCTIONS or torch.Tag.reduction in func.tags:
        flops = float(sum(t.numel() for t in ins[:1]))
    elif name in MATMULS and outs:
        a = args[MATMULS[name]]
        flops = 2.0 * outs[0].numel() * (a.shape[-1] if a.dim() else 1)
    else:
        flops = 0.0
    return flops, nbytes


class CostCounter(TorchDispatchMode):
    """The counter of count_cost: ATen ops by name and kernel models by
    kernel name, each {name: [calls, flops, bytes]}."""

    def __init__(self):
        super().__init__()
        self.ops: dict[str, list] = {}
        self.kernels: dict[str, list] = {}
        self._muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._muted:
            flops, nbytes = op_cost(func, args, kwargs, out)
            if flops or nbytes:
                _add(self.ops, func.overloadpacket.__name__, flops, nbytes)
        return out

    def add_kernel(self, name: str, cost: dict) -> None:
        """One call of kernel `name` of cost {"ops", "bytes"}."""
        _add(self.kernels, name, float(cost["ops"]), float(cost["bytes"]))

    def totals(self) -> dict:
        def tot(table, i):
            return math.fsum(v[i] for v in table.values())

        return dict(other_flops=tot(self.ops, 1), other_bytes=tot(self.ops, 2),
                    kernel_flops=tot(self.kernels, 1),
                    kernel_bytes=tot(self.kernels, 2))


def _add(table: dict, name: str, flops: float, nbytes: float) -> None:
    row = table.setdefault(name, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += flops
    row[2] += nbytes


# the counters of the count_cost calls running now, innermost last
_counters: list[CostCounter] = []


def count_cost(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its CostCounter)."""
    counter = CostCounter()
    _counters.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _counters.pop()
    return out, counter


@contextlib.contextmanager
def kernel_region():
    """Yields the active CostCounter (None outside count_cost), which
    ignores every ATen op issued inside the region: the caller reports
    the call's model to it with add_kernel."""
    if not _counters:
        yield None
        return
    counter = _counters[-1]
    counter._muted += 1
    try:
        yield counter
    finally:
        counter._muted -= 1
