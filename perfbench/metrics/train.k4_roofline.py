"""K4 (`csrc/train_attention.cu`) against its bound: one causal forward
and one backward per layer and step at [B, S, H, D] (`counts.
k4_step_bound_s`, the larger of bytes over 3.35 TB/s and operations over
989 TFLOP/s), over the device time of the kernels whose names hold
"train_attention", in %. The remat recompute of the forward is not
counted as needed work."""

from perfbench import counts


def read(trace):
    if trace is None or trace.facts.get("driver") != "train":
        return None
    k4_s = trace.device_s("train_attention")
    if k4_s <= 0:
        return None
    f = trace.facts
    c = f["config"]
    s = c["cls_token_num"] + c["block_size"] - 1
    bound = f["steps"] * counts.k4_step_bound_s(
        f["batch"], s, c["n_head"], c["head_dim"], c["n_layer"])
    return 100.0 * bound / k4_s
