"""llamagen_tpu_torch: the PyTorch + CUDA port of llamagen_tpu.

The JAX package `llamagen_tpu` stays the reference; this package holds its
counterparts, module for module, written in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (`csrc/`, built by `ops/_build.py` into `.build/`
at the repository root on first use). It imports nothing of JAX and
nothing of the JAX package: where it needs a JAX-free module of that
package (the model zoo, the checkpoint loader, the code datasets, the
metrics log) it keeps its own copy.
"""
