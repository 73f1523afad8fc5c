"""The port stands alone: in a fresh interpreter whose import system
refuses both `jax` and the JAX package `julia_raytracer_tpu`, every module
of julia_raytracer_tpu_torch (and chip_smoke.py) imports, the modules of
every ported path among them (the heavy-scene path's regroup_intersect and
kernel_select, the instanced path's scene/instanced.py and
instanced_intersect, and the cluster intersectors included), and no module
of either name is loaded. A source scan rejects any import of the two in the
package and in chip_smoke.py."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys

def blocked(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "julia_raytracer_tpu")

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


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(ROOT, "julia_raytracer_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (path, s)
                assert not s.startswith((
                    "from julia_raytracer_tpu.", "import julia_raytracer_tpu.",
                    "from julia_raytracer_tpu import",
                )), (path, s)
                assert s != "import julia_raytracer_tpu", (path, s)
