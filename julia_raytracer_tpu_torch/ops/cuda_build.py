"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first
use with nvcc for Hopper (`sm_90a`) into a shared library under
`csrc/_build/` (listed in .gitignore), keyed by a hash of the source, the
shared headers `csrc/*.cuh` and the flags, then loaded with ctypes. `build_all` starts one nvcc per
source, all at once. ptxas's report of each build is kept beside its
library (`.ptxas`), so `ptxas_info` holds it for a library built by an
earlier process too. The nvcc runs and the loads are the set-up spans
`lib_build` and `lib_load` (utils/timing.py). Nothing here runs at
import time: the CPU tests import every module on machines without nvcc
or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from julia_raytracer_tpu_torch.utils.timing import span

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas's register, shared-memory and spill report of each build
ptxas_info: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build only on a "
        "machine with the CUDA toolkit"
    )


def _lib_path(name: str, extra_flags: tuple) -> tuple[str, tuple, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        text = f.read()
    # the key covers the shared headers too (a source may include any)
    for header in sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")):
        with open(os.path.join(CSRC, header), "rb") as f:
            text += f.read()
    flags = BASE_FLAGS + tuple(extra_flags)
    key = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()[:16]
    return src, flags, os.path.join(BUILD_DIR, f"{name}-{key}.so")


def build_all(specs: dict[str, tuple]) -> None:
    """Build csrc/<name>.cu for each {name: extra nvcc flags} whose library
    is missing, one nvcc process per source, all started together."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for name, extra in specs.items():
        src, flags, lib_path = _lib_path(name, extra)
        if os.path.exists(lib_path):
            if os.path.exists(lib_path + ".ptxas"):
                with open(lib_path + ".ptxas") as f:
                    ptxas_info[name] = f.read()
            continue
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, src]
        running[name] = (cmd, tmp, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (cmd, tmp, lib_path, proc) in running.items():
        # the builds run at once: the spans add up to their wall time
        with span("lib_build", libs=1):
            out, err = proc.communicate()
        ptxas_info[name] = "\n".join(
            line for line in (out + err).splitlines()
            if "ptxas info" in line or "spill" in line)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{out}\n{err}")
        else:
            with open(lib_path + ".ptxas", "w") as f:
                f.write(ptxas_info[name])
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, load it once."""
    if name not in _loaded:
        build_all({name: tuple(extra_flags)})
        with span("lib_load", libs=1):
            _loaded[name] = ctypes.CDLL(_lib_path(name, extra_flags)[2])
    return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
