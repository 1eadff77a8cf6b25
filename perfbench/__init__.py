"""The benchmark of `llamagen_tpu_torch` on one NVIDIA H100: the
harness `run.py` runs the cells of the repository's `BENCHMARK.json`."""
