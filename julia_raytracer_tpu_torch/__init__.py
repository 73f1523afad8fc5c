"""julia_raytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside `julia_raytracer_tpu` (the JAX reference, kept
as it is). It keeps the reference's layout and function names
(`utils/`, `scene/`, `ops/`, `render/`) so each function has a
counterpart to be held against. Plain tensor code is PyTorch; every
Pallas TPU kernel on the ported path is a hand-written Hopper (sm_90a)
CUDA kernel under `csrc/`, built with nvcc on first use
(`ops/cuda_build.py`). Each kernel's wrapper runs its plain PyTorch
version for CPU tensors and launches the kernel for CUDA tensors.

The package imports torch and numpy, never jax. From the JAX package it
imports only `julia_raytracer_tpu.ops.bvh`, which is numpy-only.
"""

__version__ = "0.1.0"
