"""K2 (`csrc/int8_matmul.cu`) against its bound: for every layer and head
matmul of the traced cycle (the decode steps at 2P rows, and t2i's
admission prefills at 2A x 120 rows), the larger of its bytes over 3.35
TB/s and its 2MKN operations over 989 TFLOP/s (`counts.k2_bound_s`),
summed, divided by the device time of the kernels whose names hold
"int8_mma" or "int8_matmul", in %."""

from perfbench import counts


def read(trace):
    if trace is None or trace.facts.get("driver") != "serve":
        return None
    k2_s = trace.device_s("int8_mma", "int8_matmul")
    if k2_s <= 0:
        return None
    f = trace.facts
    c = f["config"]
    rows = 2 * len(f["pads"])
    bound = f["n_steps"] * counts.decode_k2_bound_s(c, rows)
    bound += sum(counts.prefill_k2_bound_s(c, 2 * len(a) * c["cls_token_num"])
                 for a in f["admissions"])
    return 100.0 * bound / k2_s
