"""The plain reference (`perfbench/reference/`) against the port at a tiny
size on the CPU, both in float32, so that what is left is the order of
floating-point sums: tolerances a few ulps of the values compared."""

import numpy as np
import pytest
import torch

from perfbench import weights as wts
from perfbench.drivers import gpt_config, train as train_driver
from perfbench.reference import gpt as ref
from perfbench.reference import vq as vq_ref
from perfbench.tests.tiny import SHRINK
from perfbench import harness

SEED = 2 ** 33 + 7


def tiny_config(workload):
    cell = harness.find_cell(workload,
                             harness.BENCH_DIR / "tests" / "_bench_all.json")
    shrink = {k: v for k, v in SHRINK[workload].items() if k != "traffic"}
    return {**cell.config, **shrink}, {**cell.traffic,
                                       **SHRINK[workload]["traffic"]}


def port_engine(c, w, pairs, cfg_scale):
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine

    model = gpt.Transformer(gpt_config(c), dtype=torch.float32)
    model.load_state_dict(w)
    quantize_gpt_params(model, quantize_head=True)
    return ServeEngine(model, num_pairs=pairs, max_new_tokens=c["block_size"],
                       sampling_params=SamplingParams(cfg_scale=cfg_scale,
                                                      temperature=0.0),
                       chunk=5, compute_dtype=torch.float32,
                       cache_dtype=torch.int8)


def served_gap(logits, tokens):
    best = logits.max(-1).values
    return float((best - logits.gather(-1, tokens[..., None])[..., 0]).max())


def test_serve_c2i_greedy_tokens_are_the_reference_argmax():
    c, _ = tiny_config("c2i-l384-serve-capacity")
    w = wts.gpt_weights(c, SEED, "cpu", torch.float32)
    labels = np.array([3, 7, 0, 9, 3])
    tokens = torch.as_tensor(port_engine(c, w, 3, 2.0).generate(labels))
    logits = ref.serve_logits(w, c, torch.as_tensor(labels), tokens, 2.0)
    assert logits.shape == (5, c["block_size"], c["vocab_size"])
    # f32 on both sides: the served token is the reference's best to
    # within rounding of logits of size ~0.1
    assert served_gap(logits, tokens) < 1e-5
    # and the int4 control is not: its argmax differs somewhere
    ctl = ref.serve_logits(w, c, torch.as_tensor(labels), tokens, 2.0,
                           weight_bits=4).argmax(-1)
    assert (ctl != tokens).any()


def test_serve_t2i_greedy_tokens_are_the_reference_argmax():
    c, t = tiny_config("t2i-xl256-serve-capacity")
    w = wts.gpt_weights(c, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(0)
    n, rows = 4, c["cls_token_num"]
    pads = torch.tensor([0, 3, 6, 7])
    masks = torch.arange(rows)[None, :] >= pads[:, None]
    caps = torch.randn(n, rows, c["caption_dim"], generator=g) \
        * masks[..., None]
    tokens = torch.as_tensor(port_engine(c, w, 2, 7.5).generate_t2i(
        caps, masks))
    logits = ref.serve_logits(w, c, caps, tokens, 7.5, pads)
    assert served_gap(logits, tokens) < 1e-4  # cfg 7.5 scales the rounding


def test_int8_cache_rows_are_read_back_as_the_engine_stores_them():
    x = torch.randn(3, 5, 64)
    back = ref.quant_rows(x)
    scale = x.abs().amax(-1, keepdim=True) / 127 + 1e-8
    assert torch.equal(back, torch.clamp(torch.round(x / scale), -127, 127)
                       * scale.to(torch.bfloat16).float())
    w = torch.randn(6, 10)
    from llamagen_tpu_torch.ops.quant_matmul import quantize_weight
    q, s = quantize_weight(w.t())
    assert torch.equal(ref.quant_weight(w, 8), (q.float() * s).t())


@pytest.mark.parametrize("workload", ["c2i-l384-train", "t2i-xl256-train"])
def test_train_steps_match_the_port_in_f32(workload):
    from llamagen_tpu_torch.models.vq import VQModel
    from llamagen_tpu_torch.train import c2i, t2i

    c, t = tiny_config(workload)
    run = harness.Run(harness.find_cell(
        workload, harness.BENCH_DIR / "tests" / "_bench_all.json"), SEED, 1,
        False, torch.device("cpu"), 0.0,
        shrink=dict(SHRINK[workload]))
    tc = c["train"]
    w = wts.gpt_weights(c, SEED, "cpu", torch.float32)
    kw = dict(lr=tc["lr"], weight_decay=tc["weight_decay"],
              beta1=tc["betas"][0], beta2=tc["betas"][1],
              max_grad_norm=tc["max_grad_norm"], warmup_steps=0,
              compute_dtype=torch.float32, remat="full", weights=w)
    if c["model_type"] == "c2i":
        state, step_fn = c2i.build_trainer(gpt_config(c), "cpu", **kw)
    else:
        vcfg, shapes = train_driver.vq_shapes(c["vq"])
        vq = VQModel(vcfg, dtype=torch.float32, encoder=True)
        # the VQ weights as the benchmark makes them (bf16), computed in f32
        vq.load_state_dict({k: v.float() for k, v in wts.vq_weights(
            shapes, SEED, "cpu", torch.bfloat16).items()})
        state, step_fn = t2i.build_trainer(gpt_config(c), vq, "cpu", **kw)
    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    losses, grad_norm, first = [], None, None
    for i in range(3):
        _, m = step_fn(state, train_driver._program_batch(
            run, train_driver.batch_at(run, i)), SEED % 2 ** 40)
        losses.append(float(m["loss"]))
        if i == 0:
            grad_norm = float(m["grad_norm"])
            first = {k: float(state.optimizer.opt.state[p]["exp_avg"].norm())
                     / (1 - tc["betas"][0]) for k, p in params.items()}
    program = {"losses": losses, "grad_norm": grad_norm, "grad_leaf": first,
               "change_leaf": {k: float((p.detach() - start[k]).norm())
                               for k, p in params.items()}}
    codes = []
    if c["model_type"] == "t2i":  # f32 on both sides: the same codes
        with torch.no_grad():
            codes = [vq.encode(train_driver.batch_at(run, i)["images"])[2]
                     .reshape(t["batch"], -1) for i in range(3)]
    batches, code_gap = train_driver.reference_batches(run, codes)
    assert code_gap in (None, 0.0)
    reference = ref.train_steps(w, c, tc, batches, SEED % 2 ** 40)
    got = train_driver.compare(program, reference)
    # f32 on both sides, the same dropout masks: sums in another order
    assert got["loss"] < 1e-5 and got["grad_norm"] < 1e-4
    assert got["grad_leaf"] < 1e-3 and got["change_leaf"] < 1e-3


def test_vq_encode_ids_match_the_port():
    from llamagen_tpu_torch.models.vq import VQModel

    c, _ = tiny_config("t2i-xl256-train")
    vcfg, shapes = train_driver.vq_shapes(c["vq"])
    vw = wts.vq_weights(shapes, SEED, "cpu", torch.float32)
    vq = VQModel(vcfg, dtype=torch.float32, encoder=True)
    vq.load_state_dict(vw)
    images = torch.rand(3, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        port = vq.encode(images)[2].reshape(3, -1)
    assert torch.equal(vq_ref.encode_ids(vw, c["vq"], images), port)
