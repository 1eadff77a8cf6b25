"""6 * params * tokens of the traced steps (`counts.train_step_flops`;
attention and the remat recompute not counted) over the traced span's
length, over 989 TFLOP/s, in %."""

from perfbench import counts


def read(trace):
    if trace is None or trace.facts.get("driver") != "train" or not trace.ops:
        return None
    f = trace.facts
    flops = f["steps"] * counts.train_step_flops(f["config"], f["batch"])
    return 100.0 * flops / trace.window_s / counts.PEAK_BF16_FLOPS
