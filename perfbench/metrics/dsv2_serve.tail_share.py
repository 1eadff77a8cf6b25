"""Share of the traced cycle's device time spent outside K6, K7 and K2:
the router, the dispatch and combine, the absorbed bmms, norms, RoPE,
embeddings and sampling, in %."""

from perfbench.metrics import _mla_moe


def read(trace):
    if _mla_moe.facts(trace) is None or not trace.ops:
        return None
    total = trace.device_s()
    kernels = trace.device_s(*_mla_moe.K6, *_mla_moe.K7, *_mla_moe.K2)
    return 100.0 * (total - kernels) / total
