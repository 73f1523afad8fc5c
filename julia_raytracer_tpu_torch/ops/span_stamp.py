"""The clock stamps of a utils/timing.py device_span: the wrapper of
csrc/span_stamp.cu and its plain version (device_span calls `stamp` at
each end of the span, eager or in a captured body).

`stamp(clock, end, counts=(), out=None)` writes, in the order of the
device's stream, the clock into `clock` (a 0-d int64 tensor), or at the
end the ns since the stamp `clock` holds, and copies the 0-d int64
tensors `counts` into `out` (an int64 tensor of k slots). For CUDA
tensors it is one launch of one thread reading %globaltimer, which a
CUDA graph captures as a kernel node; for CPU tensors, whose ops run as
they are issued, the host's perf_counter_ns.
"""

from __future__ import annotations

import ctypes
import time

from julia_raytracer_tpu_torch.ops import cuda_build

MAX_COUNTS = 8  # kMaxCounts in csrc/span_stamp.cu


def stamp(clock, end: bool, counts=(), out=None) -> None:
    """Stamp `clock` and copy `counts` into `out` (module docstring)."""
    if len(counts) > MAX_COUNTS:
        raise ValueError(f"span_stamp: {len(counts)} counts, at most "
                         f"{MAX_COUNTS}")
    if clock.device.type != "cuda":
        t = time.perf_counter_ns()
        for i, v in enumerate(counts):
            out[i] = v
        clock.fill_(t - int(clock) if end else t)
        return
    srcs = (ctypes.c_void_p * max(1, len(counts)))(
        *(v.data_ptr() for v in counts))
    err = _lib().span_stamp_launch(
        clock.data_ptr(), out.data_ptr() if counts else None, srcs,
        len(counts), int(end), cuda_build.stream_handle(clock.device))
    cuda_build.check(err, "span_stamp")


def _lib():
    lib = cuda_build.load("span_stamp")
    fn = lib.span_stamp_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return lib
