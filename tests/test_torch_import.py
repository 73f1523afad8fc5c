"""The port stands alone: in a fresh interpreter whose import system
refuses `jax`, the JAX package `julia_raytracer_tpu` and the image
libraries PIL and cv2 (absent on the machine with the card), every module
of julia_raytracer_tpu_torch (and chip_smoke.py) imports, the modules of
every ported path among them (the heavy-scene path's regroup_intersect and
kernel_select, the instanced path's scene/instanced.py and
instanced_intersect, the cluster intersectors, the CLI with its
denoiser, augmentation, image codecs and timing, the differentiable
path with its multi-process train step, and the numpy copies of the
subdivision tessellator and its OBJ reader, the scene set-up's disk
cache and C++ host builders, the cost accounting), and no module of those
names is loaded. Source scans reject any import of the JAX ones, and of
PIL or cv2, in the package and in chip_smoke.py, and any mention of the
JAX package's C++ source or cache directory in the package's files (the
port builds its own copy, csrc/host/cluster_tables.cpp, and caches under
its own directory)."""

import re

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys

def blocked(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "julia_raytracer_tpu", "PIL", "cv2")

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
import julia_raytracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
loaded = sorted(m for m in sys.modules if blocked(m))
assert not loaded, loaded
print(" ".join(names))
print(len(names))
"""

# the modules of each ported path, the instanced path's among them
REQUIRED = {
    "julia_raytracer_tpu_torch.ops.dense_intersect",
    "julia_raytracer_tpu_torch.ops.lane_compact",
    "julia_raytracer_tpu_torch.ops.worklist_intersect",
    "julia_raytracer_tpu_torch.ops.regroup_intersect",
    "julia_raytracer_tpu_torch.utils.kernel_select",
    "julia_raytracer_tpu_torch.ops.cluster_intersect",
    "julia_raytracer_tpu_torch.ops.instanced_intersect",
    "julia_raytracer_tpu_torch.scene.instanced",
    "julia_raytracer_tpu_torch.render.integrator",
    "julia_raytracer_tpu_torch.profile_path",
    "julia_raytracer_tpu_torch.cli",
    "julia_raytracer_tpu_torch.render.denoise",
    "julia_raytracer_tpu_torch.scene.augment",
    "julia_raytracer_tpu_torch.utils.imgio",
    "julia_raytracer_tpu_torch.utils.timing",
    "julia_raytracer_tpu_torch.render.diff",
    "julia_raytracer_tpu_torch.ops.diff_hit",
    "julia_raytracer_tpu_torch.parallel.mesh",
    "julia_raytracer_tpu_torch.parallel.distributed",
    "julia_raytracer_tpu_torch.scene.subdiv",
    "julia_raytracer_tpu_torch.scene.objio",
    "julia_raytracer_tpu_torch.utils.diskcache",
    "julia_raytracer_tpu_torch.ops.native",
    "julia_raytracer_tpu_torch.utils.kernel_flops",
    "julia_raytracer_tpu_torch.utils.roofline",
}


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert int(lines[-1]) >= 30
    assert REQUIRED <= set(lines[-2].split()), REQUIRED - set(lines[-2].split())


def _port_sources(suffixes=(".py",)):
    pkg = os.path.join(ROOT, "julia_raytracer_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, names in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        files += [os.path.join(dirpath, n) for n in names if n.endswith(suffixes)]
    return files


def test_port_names_no_jax_native_source_or_cache():
    jax_cache = re.compile(r"""["']\.cache["']\s*,\s*["']julia_raytracer_tpu["']""")
    sources = _port_sources((".py", ".cpp", ".cu", ".cuh"))
    assert any(p.endswith(os.path.join("csrc", "host", "cluster_tables.cpp"))
               for p in sources)
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "native/cluster_tables.cpp" not in text, path
        assert not jax_cache.search(text), path


def test_no_image_library_in_port_sources():
    for path in _port_sources():
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import PIL", "from PIL",
                                         "import cv2", "from cv2")), (path, s)


def test_no_jax_import_in_port_sources():
    for path in _port_sources():
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (path, s)
                assert not s.startswith((
                    "from julia_raytracer_tpu.", "import julia_raytracer_tpu.",
                    "from julia_raytracer_tpu import",
                )), (path, s)
                assert s != "import julia_raytracer_tpu", (path, s)
