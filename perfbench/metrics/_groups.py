"""Kernel groups of a training step by name (as the repository's
`tests/bench_torch_train.py` groups them)."""


def group(name: str) -> str:
    low = name.lower()
    if "train_attention" in low:
        return "k4"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv"
    if "gemm" in low or "cutlass" in low or "xmma" in low \
            or low.startswith("nvjet"):
        return "matmul"
    if "foreach" in low or "adam" in low or "multi_tensor" in low:
        return "optimizer"
    if "spin_kernel" in low:
        return "marker"
    return "other"
