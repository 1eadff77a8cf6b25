"""llamagen_tpu_torch: the PyTorch + CUDA port of llamagen_tpu.

The JAX package `llamagen_tpu` stays the reference; this package holds its
counterparts, module for module, written in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (`csrc/`, built by `ops/_build.py` into `.build/`
at the repository root on first use). It imports no JAX; it reuses the
JAX-free `llamagen_tpu.config` and `llamagen_tpu.utils.convert` modules.
"""
