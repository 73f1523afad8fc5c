"""Wall-clock formatting for the CLI's progress/ETC lines, and the fence
every timing site uses (port of julia_raytracer_tpu/utils/timing.py)."""

from __future__ import annotations

import torch


def fence(x):
    """Wait until the work that produces `x` has run: for every CUDA
    tensor in `x` (a tensor, or a tuple or list of them, nested), a
    `torch.cuda.synchronize` of its device; CPU tensors and other values
    need none. Returns x unchanged."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            for item in v:
                visit(item)

    visit(x)
    for device in devices:
        torch.cuda.synchronize(device)
    return x


def format_seconds(seconds: float) -> str:
    """h:mm:ss.mmm, matching the reference CLI output format."""
    if seconds != seconds or seconds < 0:  # NaN / negative guard
        seconds = 0.0
    total_ms = int(round(seconds * 1000))
    ms = total_ms % 1000
    total_s = total_ms // 1000
    s = total_s % 60
    m = (total_s // 60) % 60
    h = total_s // 3600
    return f"{h}:{m:02d}:{s:02d}.{ms:03d}"
