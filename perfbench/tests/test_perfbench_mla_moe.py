"""The MLA + MoE cell's counts (`counts/mla_moe.py`) against hand counts, its
eight readers on a made-up trace, and whole runs of the cell at a tiny
size on the CPU: sound, it reads `correct` true and every reader that the
CPU can feed reads; with the served tokens altered, `correct` false."""

import time

import numpy as np
import pytest
import torch

from perfbench import counts, faults, harness
from perfbench.counts import mla_moe
from perfbench.drivers import serve_mla_moe

CELL = "dsv2lite-c2i384-serve-capacity"
TINY = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=32,
            qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            num_hidden_layers=3, vocab_size=64, num_classes=10,
            block_size=16,
            traffic=dict(pairs=8, groups=2, group_gap_steps=8,
                         warm_cycles=1, greedy_every=2, check_requests=2,
                         # f32 on both sides: a sound tiny run reads 0
                         limits={"greedy_gap": 1e-3}))


def config():
    return harness.find_cell(CELL).config


def test_k6_bytes_and_flops_by_hand():
    c = config()
    # pos 288: 288 latent rows of 1,152 B, the new row read and written,
    # q (16 x 576 bf16) and out (16 x 512 bf16)
    assert mla_moe.k6_bytes([288], c) == 288 * 1152 + 2 * 1152 \
        + 16 * 576 * 2 + 16 * 512 * 2
    # 289 keys x 16 heads x (576 + 512) multiply-adds
    assert mla_moe.k6_flops([288], c) == 289 * 16 * 2 * 1088
    # a step at 1,024 rows spread over 0-575: 27 layers of latent rows
    # (~9.2 GB) and of q, out and the new rows (~1.0 GB)
    pos = np.linspace(0, 575, 1024).astype(int).tolist()
    total = 27 * mla_moe.k6_bytes(pos, c)
    assert 10.0e9 < total < 10.3e9


def test_k7_counts_by_hand():
    c = config()
    w = 64 * (2048 * 2816 + 1408 * 2048)
    assert w == 553_648_128
    pairs = 6144
    acts = pairs * (2048 + 2816) * 2 + pairs * (1408 + 2048) * 2
    assert mla_moe.k7_layer_bytes(c, 1024) == w + 64 * (2816 + 2048) * 4 \
        + acts
    assert mla_moe.k7_layer_flops(c, 1024) == 2 * pairs * 3 * 2048 * 1408
    # bytes-bound at decode: 26 layers of ~0.66 GB over 3.35 TB/s
    assert mla_moe.k7_step_bound_s(c, 1024) == pytest.approx(
        26 * mla_moe.k7_layer_bytes(c, 1024) / counts.PEAK_BYTES_PER_S)


def test_k2_shapes_and_active_parameters():
    c = config()
    mm = mla_moe.k2_matmuls(c)
    assert mm == [(2048, 3072, 27), (2048, 576, 27), (2048, 2048, 27),
                  (2048, 10944, 2), (10944, 2048, 1), (2048, 2816, 52),
                  (2816, 2048, 26), (2048, 16384, 1)]
    dense = sum(k * n * calls for k, n, calls in mm)
    kv_b = 27 * 16 * 256 * 512
    routed = 26 * (64 * 2048 + 6 * 3 * 2048 * 1408)
    assert mla_moe.active_params(c) == dense + kv_b + routed
    # 2.28 B active of 15.36 B (DeepSeek-V2-Lite's published 2.4 B counts
    # its embedding of 102,400 ids and a head as wide)
    assert 2.27e9 < mla_moe.active_params(c) < 2.28e9
    one = mla_moe.decode_step_flops(c, [0])
    assert one == 2 * mla_moe.active_params(c) + 27 * 16 * 2 * 1088


def trace(n_steps=2, pairs=4):
    c = config()
    pos_end = np.array([5, 9, 3, 7])[:pairs]
    ops = [("mla_decode_kernel", 0.0, 100.0),
           ("void (anonymous namespace)::moe_int8_kernel<__nv_bfloat16, "
            "128>(__nv_bfloat16 const*, signed char const*)", 100.0, 400.0),
           ("void (anonymous namespace)::int8_mma_kernel<__nv_bfloat16, "
            "64>(__nv_bfloat16 const*)", 400.0, 600.0),
           ("triton_poi_fused", 600.0, 700.0), ("topk", 800.0, 900.0)]
    t = harness.Trace(ops, [], 1e-3)
    t.facts.update(config=c, driver="serve_mla_moe", pos_end=pos_end,
                   n_steps=n_steps, pads=np.zeros(pairs, np.int64),
                   moe_expert_rows=[[2, 2, 4, 0], [3, 3, 1, 1]],
                   host_ms_per_step=0.25)
    return t


def read(name, t):
    return harness.metric_reader(name)(t)


def test_readers_on_a_made_up_trace():
    t = trace()
    c = config()
    # the positions of the two traced steps, CFG rows doubled
    steps = [[3, 7, 1, 5] * 2, [4, 8, 2, 6] * 2]
    k6 = 27 * sum(mla_moe.k6_bytes(p, c) for p in steps)
    assert read("dsv2_serve.mla_roofline", t) == pytest.approx(
        100 * k6 / counts.PEAK_BYTES_PER_S / 100e-6)
    assert read("dsv2_serve.moe_roofline", t) == pytest.approx(
        100 * 2 * mla_moe.k7_step_bound_s(c, 8) / 300e-6)
    assert read("dsv2_serve.k2_roofline", t) == pytest.approx(
        100 * 2 * mla_moe.k2_step_bound_s(c, 8) / 200e-6)
    flops = sum(mla_moe.decode_step_flops(c, p) for p in steps)
    assert read("dsv2_serve.mfu", t) == pytest.approx(
        100 * flops / 1e-3 / counts.PEAK_BF16_FLOPS)
    # 200 of 800 device us outside the three kernels; 700 of 1000 busy
    assert read("dsv2_serve.tail_share", t) == pytest.approx(25.0)
    assert read("dsv2_serve.device_idle_share", t) == pytest.approx(20.0)
    # layer 0: 4 of a mean 2; layer 1: 3 of a mean 2
    assert read("dsv2_serve.expert_load_imbalance", t) == pytest.approx(2.0)
    assert read("dsv2_serve.host_ms_per_step", t) == 0.25


@pytest.mark.parametrize("name", [
    "dsv2_serve.mfu", "dsv2_serve.mla_roofline", "dsv2_serve.moe_roofline",
    "dsv2_serve.k2_roofline", "dsv2_serve.tail_share",
    "dsv2_serve.device_idle_share", "dsv2_serve.expert_load_imbalance",
    "dsv2_serve.host_ms_per_step"])
def test_readers_find_nothing_in_another_drivers_trace(name):
    t = trace()
    t.facts["driver"] = "serve"
    assert read(name, t) is None
    assert read(name, None) is None


def tiny_run(trace=False, plant=lambda kind, obj: obj):
    return harness.Run(harness.find_cell(CELL), 123456789012, 0.5, trace,
                       torch.device("cpu"), time.time(), shrink=TINY,
                       plant=plant)


@pytest.mark.parametrize("fault", [None, "token"])
def test_a_tiny_run_is_correct_and_a_fault_is_not(fault):
    plant = faults.FAULTS[fault] if fault else (lambda kind, obj: obj)
    out = serve_mla_moe.run(tiny_run(plant=plant))
    assert out.correct is (fault is None), out.checks
    assert out.metrics["img_per_s"] > 0
    assert out.readings["tokens_checked"] == 2 * 16


def test_a_tiny_traced_run_reads_the_counter():
    run = tiny_run(trace=True)
    res = harness.result_line(run.cell, serve_mla_moe.run(run), True)
    assert res["correct"], res
    # no device on the CPU: only the program's counter and the host span
    # have something
    assert set(res["metrics"]) == {"dsv2_serve.expert_load_imbalance",
                                   "dsv2_serve.host_ms_per_step"}
    assert res["metrics"]["dsv2_serve.expert_load_imbalance"]["value"] >= 1
    assert res["metrics"]["dsv2_serve.host_ms_per_step"]["value"] > 0


def test_reference_counts_and_weights_load_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.mla_moe, perfbench.counts.mla_moe, "
            "perfbench.weights_mla_moe; "
            "print(sorted(m for m in sys.modules if m.startswith('llamagen')))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
