"""Lane compactor for the unsorted two-phase wavefront dispatch: the
wrappers of csrc/lane_compact.cu and their plain PyTorch versions.

Replaces the Pallas TPU kernels of julia_raytracer_tpu/ops/pallas_compact.py
(_make_compact_kernel via compact_state, _make_expand_kernel via
expand_outputs). The integrator's state rides as ONE [P, n] int32 tensor:
f32 leaves enter as `.view(torch.int32)` and bool leaves as 0/1, and
nothing is converted back until the last step, so NaN payloads,
denormals and full-range u32 rng bits survive bit for bit.

  compact_planes(vals [P, n], alive [n], cap) -> [P, cap]: the alive
    lanes in stable lane order in the prefix; slots past the survivor
    count are unspecified (the plain version zeroes them, the kernel
    leaves them unwritten).
  expand_planes(narrow [P, cap], alive [n], fallback [P, n]) -> [P, n]:
    lane i takes narrow[:, rank(i)] when alive[i], else fallback[:, i].

n must be a multiple of TILE (1024). For CPU tensors the wrappers run
the plain versions; for CUDA tensors they launch the kernels (or raise).
`compact_planes.launches` and `expand_planes.launches` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from julia_raytracer_tpu_torch.ops import cuda_build
from julia_raytracer_tpu_torch.utils import kernel_flops as kf, roofline, timing

TILE = 1024


def leaves_to_planes(leaves) -> tuple[torch.Tensor, list]:
    """[n] / [n, k] leaves (float32, int32 or bool) -> ([P, n] int32,
    specs to invert). Floats are reinterpreted, never converted."""
    rows, specs = [], []
    for leaf in leaves:
        if leaf.dtype == torch.bool:
            xi = leaf.to(torch.int32)
        elif leaf.dtype == torch.int32:
            xi = leaf
        elif leaf.dtype == torch.float32:
            xi = leaf.contiguous().view(torch.int32)
        else:
            raise TypeError(f"unsupported state dtype {leaf.dtype}")
        rows.append(xi.reshape(leaf.shape[0], -1).T)
        specs.append((tuple(leaf.shape[1:]), leaf.dtype))
    return torch.cat(rows, dim=0).contiguous(), specs


def planes_to_leaves(planes: torch.Tensor, specs) -> list:
    """Inverse of leaves_to_planes at the planes' width."""
    leaves, i = [], 0
    n = planes.shape[1]
    for tail, dtype in specs:
        k = 1
        for d in tail:
            k *= d
        xi = planes[i:i + k].T.reshape((n,) + tail)
        if dtype == torch.bool:
            leaves.append(xi != 0)
        elif dtype == torch.float32:
            leaves.append(xi.contiguous().view(torch.float32))
        else:
            leaves.append(xi.contiguous())
        i += k
    return leaves


def compact_planes_plain(vals, alive, cap):
    idx = torch.nonzero(alive).reshape(-1)  # stable: ascending lane order
    out = torch.zeros((vals.shape[0], cap), dtype=vals.dtype, device=vals.device)
    m = min(idx.shape[0], cap)
    out[:, :m] = vals[:, idx[:m]]
    return out


def expand_planes_plain(narrow, alive, fallback):
    cap = narrow.shape[1]
    idx = torch.nonzero(alive).reshape(-1)[:cap]
    out = fallback.clone()
    out[:, idx] = narrow[:, : idx.shape[0]]
    return out


def _check(vals, alive, planes_n):
    p, n = planes_n
    if vals.dtype != torch.int32 or vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("planes must be a contiguous [P, n] int32 tensor")
    if alive.dtype != torch.bool or tuple(alive.shape) != (n,) \
            or not alive.is_contiguous():
        raise ValueError(f"alive must be a contiguous [{n}] bool tensor")
    if alive.device != vals.device:
        raise ValueError("planes and alive must be on one device")
    if n % TILE:
        raise ValueError(f"lane count {n} is not a multiple of {TILE}")


def compact_planes(vals, alive, cap: int):
    """Pack the alive lanes of vals [P, n] into the prefix of [P, cap]
    (the plain version for CPU tensors, the kernel for CUDA tensors; under
    roofline.count_cost the call reports kernel_flops.lane_compact_cost)."""
    with roofline.kernel_region() as counter:
        out = _compact_planes(vals, alive, cap)
        if counter is not None:
            counter.add_kernel("lane_compact", kf.lane_compact_cost(
                vals.shape[0], vals.shape[1], cap))
    return out


def _compact_planes(vals, alive, cap: int):
    if vals.device.type == "cpu":
        return compact_planes_plain(vals, alive, cap)
    if vals.device.type != "cuda":
        raise ValueError(f"compact_planes: unsupported device {vals.device}")
    p, n = vals.shape
    _check(vals, alive, (p, n))
    if not 0 <= cap <= n:
        raise ValueError(f"cap {cap} outside [0, {n}]")
    lib = _lib()
    out = torch.empty((p, cap), dtype=torch.int32, device=vals.device)
    counts = torch.empty(n // TILE, dtype=torch.int32, device=vals.device)
    err = lib.lane_compact_launch(
        vals.data_ptr(), alive.data_ptr(), counts.data_ptr(), p, n, cap,
        out.data_ptr(), cuda_build.stream_handle(vals.device),
    )
    cuda_build.check(err, "lane_compact")
    if n:  # the launcher launches nothing for no lanes
        compact_planes.launches += 1
    return out


timing.counter(compact_planes, "launches")


def expand_planes(narrow, alive, fallback):
    """Scatter narrow [P, cap] back to the alive lanes of [P, n]; other
    lanes keep fallback [P, n] (the plain version for CPU tensors, the
    kernel for CUDA tensors; under roofline.count_cost the call reports
    kernel_flops.lane_expand_cost)."""
    with roofline.kernel_region() as counter:
        out = _expand_planes(narrow, alive, fallback)
        if counter is not None:
            counter.add_kernel("lane_expand", kf.lane_expand_cost(
                narrow.shape[0], narrow.shape[1], fallback.shape[1]))
    return out


def _expand_planes(narrow, alive, fallback):
    if narrow.device.type == "cpu":
        return expand_planes_plain(narrow, alive, fallback)
    if narrow.device.type != "cuda":
        raise ValueError(f"expand_planes: unsupported device {narrow.device}")
    p, n = fallback.shape
    _check(fallback, alive, (p, n))
    if narrow.dtype != torch.int32 or narrow.dim() != 2 \
            or narrow.shape[0] != p or not narrow.is_contiguous() \
            or narrow.device != fallback.device:
        raise ValueError(f"narrow must be a contiguous [{p}, cap] int32 tensor")
    cap = narrow.shape[1]
    lib = _lib()
    out = torch.empty((p, n), dtype=torch.int32, device=narrow.device)
    counts = torch.empty(n // TILE, dtype=torch.int32, device=narrow.device)
    err = lib.lane_expand_launch(
        narrow.data_ptr(), alive.data_ptr(), counts.data_ptr(),
        fallback.data_ptr(), p, n, cap, out.data_ptr(),
        cuda_build.stream_handle(narrow.device),
    )
    cuda_build.check(err, "lane_expand")
    if n:  # the launcher launches nothing for no lanes
        expand_planes.launches += 1
    return out


timing.counter(expand_planes, "launches")


FLAGS = ()


def _lib():
    lib = cuda_build.load("lane_compact", FLAGS)
    if not lib.lane_compact_launch.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lane_compact_launch.argtypes = [p, p, p, i, i, i, p, p]
        lib.lane_compact_launch.restype = ctypes.c_int
        lib.lane_expand_launch.argtypes = [p, p, p, p, i, i, i, p, p]
        lib.lane_expand_launch.restype = ctypes.c_int
    return lib
