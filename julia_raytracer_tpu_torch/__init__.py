"""julia_raytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside `julia_raytracer_tpu` (the JAX reference, kept
as it is). It keeps the reference's layout and function names
(`utils/`, `scene/`, `ops/`, `render/`) so each function has a
counterpart to be held against. Plain tensor code is PyTorch; every
Pallas TPU kernel on the ported path is a hand-written Hopper (sm_90a)
CUDA kernel under `csrc/`, built with nvcc on first use
(`ops/cuda_build.py`). Each kernel's wrapper runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.

The package imports torch and numpy, never jax, and nothing of the JAX
package: what it needs of its numpy-only host code (the BVH builder, the
cluster tables, the PLY reader and the scene loader) it keeps as its own
copies. Entry points run on the card unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"
