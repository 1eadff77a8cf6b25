"""The byte and operation counts against hand counts and the bounds the
repository's kernel table (PERF.md) records for the same calls."""

import json

import pytest

from perfbench import counts, harness


def ms(flops, nbytes):
    return 1e3 * counts.bound_s(flops, nbytes)


def test_k1_int8_b128_pos288_matches_the_kernel_table():
    # 128 rows x (288 int8 k|v rows of 2048 B + 288 x 2 bf16 scales
    # + q, new row, out, tail row: 4 x 2048 ... ) = 77.2 MB -> 0.0231 ms
    nbytes = counts.k1_bytes([288] * 128, 16, 16, 64)
    assert nbytes == 128 * (288 * (2048 + 4) + 2048 + 4096 + 2048 + 4096)
    assert ms(0, nbytes) == pytest.approx(0.0231, abs=5e-5)


def test_k1_counts_only_valid_rows_and_flushes():
    # pos 100, pad 40: int8 rows [40, 96), tail rows [96, 100)
    one = counts.k1_bytes([100], 2, 2, 64, pads=[40])
    f = 128
    assert one == 56 * (2 * f + 4) + 4 * 2 * f * 2 + 2 * (2 * f + 2 * f * 2)
    # pos 31 flushes 32 rows
    flush = counts.k1_bytes([31], 2, 2, 64)
    assert flush == 31 * 2 * f * 2 + 2 * (2 * f + 2 * f * 2) \
        + 32 * (2 * f + 4)
    assert counts.k1_flops([10], 4, 64, pads=[3]) == 4 * 4 * 64 * 8


@pytest.mark.parametrize("m,k,n,want", [
    (16, 1024, 3072, 0.0010),    # GPT-L wqkv at B 16: bytes
    (1920, 1280, 3840, 0.0191),  # GPT-XL wqkv, a t2i admission: operations
    (128, 1024, 16384, 0.0064),  # the GPT-L int8 head at B 128: bytes
])
def test_k2_matches_the_kernel_table(m, k, n, want):
    assert 1e3 * counts.k2_bound_s(m, k, n) == pytest.approx(want, abs=6e-5)


def test_k4_matches_the_kernel_table():
    shape = (32, 576, 16, 64)
    assert ms(counts.k4_fwd_flops(*shape),
              counts.k4_fwd_bytes(*shape)) == pytest.approx(0.0454, abs=1e-4)
    assert ms(0, counts.k4_dq_bytes(*shape)) == pytest.approx(0.0683,
                                                              abs=1e-4)
    # the whole backward reads five tensors and writes three
    assert counts.k4_bwd_bytes(*shape) == 8 * 32 * 576 * 16 * 64 * 2 \
        + 32 * 16 * 576 * 4
    # q.k and p.v: 2 x 2D operations for each of the 6 causal pairs
    assert counts.k4_fwd_flops(1, 3, 1, 2) == 2 * 2 * 2 * (1 + 2 + 3)


def config(name):
    return json.loads((harness.BENCH_DIR / "configs" / f"{name}.json")
                      .read_text())


def test_model_counts():
    c = config("gpt-l-c2i-384")
    assert counts.n_params(c) == 342_910_976  # upstream's GPT-L: 343M
    per_layer = 1024 * 3072 + 1024 * 1024 + 3 * 1024 * 2816
    assert counts.matmul_params(c) == 24 * per_layer + 1024 * 16384
    # one row at position 0: the matmuls and one key a layer
    assert counts.decode_step_flops(c, [0]) == \
        2 * counts.matmul_params(c) + 24 * 4 * 16 * 64
    assert counts.train_step_flops(c, 32) == 6 * 342_910_976 * 32 * 576
    x = config("gpt-xl-t2i-256")
    assert 775e6 < counts.n_params(x) < 780e6
    # a pad of 119 leaves one valid row: keys 1 + ... per position
    t = 120
    keys = sum(p + 1 - min(119, p) for p in range(t))
    assert keys == 119 + 1
