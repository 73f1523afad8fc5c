"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first
use with nvcc for Hopper (`sm_90a`) into a shared library under
`csrc/_build/` (listed in .gitignore), keyed by a hash of the source and
the flags, then loaded with ctypes. Nothing here runs at import time:
the CPU tests import every module on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when reused)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build only on a "
        "machine with the CUDA toolkit"
    )


def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, load it once."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        text = f.read()
    flags = BASE_FLAGS + tuple(extra_flags)
    key = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
