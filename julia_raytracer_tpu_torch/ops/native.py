"""ctypes bridge to the port's C++/OpenMP host builders
(csrc/host/cluster_tables.cpp; port of julia_raytracer_tpu/ops/native.py).

The cluster-table build is the hottest host-side step of a heavy scene's
set-up, and the hybrid build's world expansion the next: the library
computes the numpy paths' math (double per prim, f32 stores, for the
tables; float32 row-vector products in the einsum's order for the world
expansion) with OpenMP across clusters and prims.

The library is compiled on first use with `g++ -O3 -fopenmp -shared
-fPIC` into csrc/_build/ (listed in .gitignore), keyed by a hash of the
source and the flags as ops/cuda_build.py keys the CUDA libraries, and
loaded with ctypes. No failure is hidden: when g++ is on the PATH, a
build or load that fails raises. Only when there is no g++ at all do the
callers take their numpy paths, after one note on stderr. JRT_NO_NATIVE=1
takes the numpy paths (read at each call). The build and the load are
the set-up spans `lib_build` and `lib_load` (utils/timing.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

from julia_raytracer_tpu_torch.utils.timing import span

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "host", "cluster_tables.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "csrc", "_build")
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_no_compiler_noted = False


def _lib_path() -> str:
    with open(SRC, "rb") as f:
        text = f.read()
    key = hashlib.sha1(text + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"cluster_tables-{key}.so")


def _build(so: str, gxx: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process name: concurrent builders must not interleave their
    # output into one file before the atomic rename
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with span("lib_build", libs=1):
            proc = subprocess.run([gxx, *FLAGS, "-o", tmp, SRC],
                                  capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """The loaded library, or None when JRT_NO_NATIVE=1 or no g++ is on
    the PATH (the numpy paths run). Raises when g++ is present and the
    build or the load fails."""
    global _lib, _no_compiler_noted
    if os.environ.get("JRT_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None:
            return _lib
        so = _lib_path()
        if not os.path.exists(so):
            gxx = shutil.which("g++")
            if gxx is None:
                if not _no_compiler_noted:
                    print("note: no g++ on the PATH; the scene set-up takes "
                          "its numpy paths", file=sys.stderr)
                    _no_compiler_noted = True
                return None
            _build(so, gxx)
        with span("lib_load", libs=1):
            loaded = ctypes.CDLL(so)
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        loaded.build_cluster_tables.argtypes = [
            fp, ctypes.c_int64, ctypes.c_int64, fp, fp, fp]
        loaded.build_cluster_tables.restype = None
        loaded.world_expand_permute.argtypes = [
            fp, fp, ip, ip, ctypes.c_int64, fp]
        loaded.world_expand_permute.restype = None
        loaded.native_threads.argtypes = []
        loaded.native_threads.restype = ctypes.c_int
        _lib = loaded
        return _lib


def threads() -> int:
    """The OpenMP threads the library's loops run on (0 without it)."""
    loaded = lib()
    return int(loaded.native_threads()) if loaded is not None else 0


def _require(a: np.ndarray, dtype, shape: tuple, name: str) -> None:
    if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
        raise ValueError(f"{name}: expected C-contiguous {np.dtype(dtype)} "
                         f"{shape}, got {a.dtype} {a.shape}")


def build_cluster_tables_native(pv32: np.ndarray, q: int, c: int,
                                tfm: np.ndarray, nrm4: np.ndarray,
                                bbox: np.ndarray) -> bool:
    """Fill tfm [c, 12, 128] / nrm4 rows 0..2 [c, 4, 128] / bbox [c, 8] in
    place from pv32 [q, 4, 3] f32. Returns False when the library is not
    in use (the caller runs the numpy path)."""
    loaded = lib()
    if loaded is None:
        return False
    _require(pv32, np.float32, (q, 4, 3), "prim verts")
    _require(tfm, np.float32, (c, 12, 128), "tfm")
    _require(nrm4, np.float32, (c, 4, 128), "nrm")
    _require(bbox, np.float32, (c, 8), "bbox")
    if c * 64 < q:
        raise ValueError(f"{c} clusters cannot hold {q} prims")
    fp = ctypes.POINTER(ctypes.c_float)
    loaded.build_cluster_tables(
        pv32.ctypes.data_as(fp), ctypes.c_int64(q), ctypes.c_int64(c),
        tfm.ctypes.data_as(fp), nrm4.ctypes.data_as(fp),
        bbox.ctypes.data_as(fp))
    return True


def world_expand_permute_native(shape_verts: np.ndarray, frames: np.ndarray,
                                src_prim: np.ndarray, src_inst: np.ndarray,
                                out: np.ndarray) -> bool:
    """out[k] = shape_verts[src_prim[k]] @ R[src_inst[k]] + t[src_inst[k]]
    in one streaming OpenMP pass (row-vector convention, frames [I, 4, 3]:
    rows 0..2 R, row 3 t). Returns False when the library is not in use."""
    loaded = lib()
    if loaded is None:
        return False
    n = len(out)
    _require(shape_verts, np.float32, (len(shape_verts), 4, 3), "shape verts")
    _require(frames, np.float32, (len(frames), 4, 3), "frames")
    _require(src_prim, np.int32, (n,), "src_prim")
    _require(src_inst, np.int32, (n,), "src_inst")
    _require(out, np.float32, (n, 4, 3), "out")
    if n and (src_prim.min() < 0 or src_prim.max() >= len(shape_verts)
              or src_inst.min() < 0 or src_inst.max() >= len(frames)):
        raise ValueError("src_prim/src_inst index outside the verts/frames")
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    loaded.world_expand_permute(
        shape_verts.ctypes.data_as(fp), frames.ctypes.data_as(fp),
        src_prim.ctypes.data_as(ip), src_inst.ctypes.data_as(ip),
        ctypes.c_int64(n), out.ctypes.data_as(fp))
    return True
