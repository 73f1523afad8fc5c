"""The port imports without JAX: in a fresh interpreter whose import
system refuses `jax`, every module of julia_raytracer_tpu_torch (and
chip_smoke.py) imports, and the only module it loads from the JAX
package is the numpy-only julia_raytracer_tpu.ops.bvh (with its parent
packages)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this test")
        return None

sys.meta_path.insert(0, BlockJax())
import julia_raytracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
ref = sorted(m for m in sys.modules if m.split(".")[0] == "julia_raytracer_tpu")
assert ref == ["julia_raytracer_tpu", "julia_raytracer_tpu.ops",
               "julia_raytracer_tpu.ops.bvh"], ref
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(ROOT, "julia_raytracer_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), path
                if s.startswith(("from julia_raytracer_tpu.",
                                 "import julia_raytracer_tpu.")):
                    assert "julia_raytracer_tpu.ops.bvh" in s, (path, s)
