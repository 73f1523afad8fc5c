"""Disk cache of the host products of a scene's set-up (port of
julia_raytracer_tpu/utils/diskcache.py).

Heavy scenes pay tens of seconds of host-side numpy work (flatten, BVH,
light tables, cluster tables, the kernel choice, the hybrid world soup)
before the first ray. Products are keyed by a content hash of the
scene's files, so edits invalidate them.

The port keeps its own directory (`~/.cache/julia_raytracer_tpu_torch`,
or `JRT_CACHE_DIR`) and its own BUILDER_VERSION token: the two packages'
layouts differ (the port rounds work-item boxes outward, for one), so one
package's key must never name the other's products. `save_arrays` writes
through a temporary file named for the process and thread before the
atomic rename, so concurrent writers of one product never interleave.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np

_ENV = "JRT_CACHE_DIR"

# Bump when the LAYOUT of any cached product changes (prim order, table
# format, hybrid partition rule, the kernel-selection costs' meaning, ...):
# scene content alone cannot see a change of the builders, and a stale
# product would be silently wrong.
BUILDER_VERSION = "torch-v1"
# products of scenes above this many prims are saved (only heavy scenes
# are worth the disk space), as in the JAX package
CACHE_MIN_PRIMS = 200_000


def cache_dir() -> str:
    d = os.environ.get(_ENV)
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache",
                         "julia_raytracer_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def scene_cache_key(scene_path: str, *extra: str) -> str:
    """Content key: sha1 over the scene JSON bytes plus (name, size,
    mtime_ns) of every file under the scene directory, plus any extra
    tokens (e.g. 'sah' for the high-quality BVH) and BUILDER_VERSION.
    "" (nothing is cached) when the scene file cannot be read."""
    h = hashlib.sha1()
    try:
        with open(scene_path, "rb") as f:
            h.update(f.read())
    except OSError:
        return ""
    root = os.path.dirname(os.path.abspath(scene_path))
    entries = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((os.path.relpath(p, root), st.st_size, st.st_mtime_ns))
    for e in sorted(entries):
        h.update(repr(e).encode())
    for e in extra:
        h.update(e.encode())
    h.update(BUILDER_VERSION.encode())
    return h.hexdigest()[:20]


def _path(key: str, tag: str) -> str:
    return os.path.join(cache_dir(), f"{key}_{tag}.npz")


def load_arrays(key: str, tag: str) -> dict | None:
    """The product saved under (key, tag), or None (no key, no file, or a
    file that does not read back as an npz)."""
    if not key:
        return None
    path = _path(key, tag)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError):
        return None


def save_arrays(key: str, tag: str, arrays: dict) -> None:
    """Save a product under (key, tag); nothing without a key. A full or
    read-only disk loses the product, not the run."""
    if not key:
        return
    path = _path(key, tag)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
