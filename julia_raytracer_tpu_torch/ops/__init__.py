"""Per-ray operators and the wrappers of the hand-written CUDA kernels."""
