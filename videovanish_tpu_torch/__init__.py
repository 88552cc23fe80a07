"""PyTorch/CUDA port of videovanish_tpu for NVIDIA Hopper GPUs.

The JAX package (videovanish_tpu) stays the reference; this package imports
nothing of it and nothing of JAX. Its hand-written kernels are in
`ops/csrc/` and build at first use (`ops/kernels.py`).
"""
