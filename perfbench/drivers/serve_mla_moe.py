"""The serving driver of the MLA + MoE configurations (`configs/dsv2-*.json`):
the program's slot engine (`serve/engine.py::ServeEngine`) over
`models/mla_moe.py`, at a fixed number of CFG pairs, closed loop, in the
staggered steady state, as `drivers/serve.py` drives the GPT (its
`Traffic` draws the requests).

Set-up: the model is laid out on the meta device, then the ends and one
layer at a time are made on the card from the seed (bf16,
`weights_mla_moe.py`) and quantised at once (W8A16, the experts stacked
for K7), so the bf16 model is never whole on the card; a bf16 latent
cache. Then the slots are filled in `groups` groups, one a cycle of
`group_gap_steps` decode steps, and `warm_cycles` more cycles warm every
shape.

The window opens (after a sync, with the engine's stats reset) and closes
with a sync. `img_per_s` counts the tokens sampled in it over the tokens
of an image; `image_latency_p95_s` is the 95th percentile of admission to
harvest over the images completed in it. With `--trace 1` the window's
second cycle is profiled; the trace's facts carry the engine's
`moe_expert_rows` over the window and the host milliseconds a decode step
of the harness's "step" span over the untraced cycles. `stats()` after
the window goes into the readings (`decode_graphed_share`,
`moe_expert_rows`).

Correctness: requests `i % greedy_every == 0` are greedy. After the
window a sample of the greedy requests finished in it, drawn from the
seed, goes to the plain reference (`reference/mla_moe.py::serve_logits`);
the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position. With "control" in the
run's extras (`calibrate.py --control`), also the gap of the int4
reference's first choices, and the share of routed (row, position, layer)
whose top-k expert set differs between the program, teacher-forced
through its own decode step on the same tokens, and the reference.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import harness, weights_mla_moe as wts
from perfbench.drivers.serve import Traffic
from perfbench.reference import mla_moe as ref


def program_config(c: Dict):
    """The program's MLAMoEConfig for a configuration file."""
    from llamagen_tpu_torch.config import MLAMoEConfig

    rs = c["rope_scaling"]
    if c["q_lora_rank"] is not None or c["topk_method"] != "greedy" \
            or c["scoring_func"] != "softmax" or c["norm_topk_prob"]:
        raise ValueError(f"{c['name']}: the program runs no q low-rank, "
                         f"greedy softmax routing without renormalising")
    return MLAMoEConfig(
        dim=c["hidden_size"], n_layer=c["num_hidden_layers"],
        n_head=c["num_attention_heads"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        dense_ffn_dim=c["intermediate_size"],
        moe_ffn_dim=c["moe_intermediate_size"],
        n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        top_k=c["num_experts_per_tok"],
        first_k_dense=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        norm_eps=c["rms_norm_eps"], rope_base=float(c["rope_theta"]),
        rope_factor=float(rs["factor"]),
        mscale_all_dim=float(rs["mscale_all_dim"]),
        initializer_range=c["initializer_range"],
        num_classes=c["num_classes"],
        class_dropout_prob=c["class_dropout_prob"], model_type="c2i",
        vocab_size=c["vocab_size"], cls_token_num=c["cls_token_num"],
        block_size=c["block_size"])


@torch.no_grad()
def build_model(c: Dict, seed: int, dev: torch.device,
                dtype: torch.dtype = torch.bfloat16):
    """The program's model with the seed's weights, W8A16, made one layer
    at a time (module docstring)."""
    from llamagen_tpu_torch.models import mla_moe

    cfg = program_config(c)
    model = mla_moe.MLAMoETransformer(cfg, device="meta", dtype=dtype)
    for mod in (model.tok_embeddings, model.cls_embedding, model.norm,
                model.output):
        mod.to_empty(device=dev)
    for k, v in wts.end_weights(c, seed, dev, dtype).items():
        model.get_parameter(k).copy_(v)
    model.output.quantize_()
    for i, layer in enumerate(model.layers):
        layer.to_empty(device=dev)
        prefix = f"layers.{i}."
        layer.load_state_dict({k[len(prefix):]: v for k, v in
                               wts.layer_weights(c, seed, i, dev,
                                                 dtype).items()})
        mla_moe.quantize_layer_(layer)
    model.freqs_cis = torch.tensor(
        mla_moe._freqs_cis_2d_np(cfg.grid_size, cfg.qk_rope_head_dim,
                                 cfg.rope_base, cfg.cls_token_num),
        device=dev)
    model.expert_rows = torch.zeros_like(model.expert_rows, device=dev)
    return model.eval()


def build_engine(r: harness.Run):
    """The program's model and engine for the cell (set-up)."""
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine

    c, t, dev = r.config, r.traffic, r.device
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = build_model(c, r.seed, dev, dtype)
    sp = SamplingParams(cfg_scale=t["cfg_scale"],
                        temperature=t["temperature"], top_k=t["top_k"],
                        top_p=t["top_p"])
    eng = ServeEngine(model, num_pairs=t["pairs"],
                      max_new_tokens=c["block_size"], sampling_params=sp,
                      chunk=t["group_gap_steps"], seed=r.seed % 2 ** 63,
                      compute_dtype=dtype, cache_dtype=dtype)
    greedy = SamplingParams(cfg_scale=t["cfg_scale"], temperature=0.0,
                            top_k=t["top_k"], top_p=t["top_p"])
    return model, r.plant("engine", eng), sp, greedy


def run(r: harness.Run) -> harness.Outcome:
    c, t, dev = r.config, r.traffic, r.device
    model, eng, sp, greedy_sp = build_engine(r)
    traffic = Traffic(c, t, r.seed, dev)
    spans = harness.Spans()
    n_tok = c["block_size"]
    reqs: List[Any] = []  # (request, traffic entry)

    def submit(n: int) -> None:
        for _ in range(n):
            e = traffic.next()
            q = eng.submit(e["label"], sp=greedy_sp if e["greedy"] else sp)
            reqs.append((q, e))

    done = [0]

    def cycle() -> int:
        before = eng.steps_run
        with spans.span("step"):
            eng._admit_and_step()
        with spans.span("harvest"):
            eng._harvest()
        submit(eng._completed - done[0])  # closed loop: refill at once
        done[0] = eng._completed
        return eng.steps_run - before

    def progress() -> int:
        return eng._completed * n_tok + sum(
            n_tok - int(eng._slot_remaining[i]) for i in range(eng.num_pairs)
            if eng.slot_request[i] is not None)

    per = t["pairs"] // t["groups"]
    for _ in range(t["groups"]):  # the stagger: one group a cycle
        submit(per)
        cycle()
    for _ in range(t["warm_cycles"]):
        cycle()

    r.sync()
    eng.reset_stats()  # the window's gauges and expert counts
    spans.reset()
    done[0] = 0
    w0, t0 = time.time(), time.perf_counter()
    p0, steps0 = progress(), eng.steps_run
    trace, traced_steps, cycles = None, 0, 0
    while True:
        if r.trace and cycles == 1:
            traced_steps, trace = harness.profile(cycle, spans)
            pos_end = eng._slot_pos.copy()
        else:
            cycle()
        cycles += 1
        if time.perf_counter() - t0 >= r.seconds \
                and (trace is not None or not r.trace):
            break
    r.sync()
    w1, t1 = time.time(), time.perf_counter()
    p1, steps = progress(), eng.steps_run - steps0
    stats = eng.stats()
    finished = [(q, e) for q, e in reqs
                if q.finished_at is not None and w0 <= q.finished_at <= w1]
    lat = [q.finished_at - q.admitted_at for q, _ in finished]
    metrics = {"img_per_s": (p1 - p0) / n_tok / (t1 - t0),
               "image_latency_p95_s": float(np.percentile(lat, 95))
               if lat else float("inf"),
               "setup_s": w0 - r.started}
    if trace is not None:
        trace = trace()  # the profile read after the window
        trace.facts.update(
            config=c, driver="serve_mla_moe", pos_end=pos_end,
            n_steps=traced_steps, pads=np.zeros(eng.num_pairs, np.int64),
            moe_expert_rows=stats["moe_expert_rows"],
            host_ms_per_step=1e3 * spans.seconds.get("step", 0.0)
            / max(steps - traced_steps, 1))
    device = harness.device_record(dev, 1)

    greedy = [(q, e) for q, e in finished if e["greedy"]]
    rng = np.random.default_rng([r.seed % 2 ** 64, 3])
    pick = sorted(rng.choice(len(greedy), min(len(greedy),
                                              t["check_requests"]),
                             replace=False)) if greedy else []
    sample = [greedy[i] for i in pick]
    routes = program_routes(model, sample, dev) \
        if "control" in r.extra and sample else None
    del eng, model
    harness.free_device(dev)
    checks, readings = judge(r, sample, routes)
    readings.update(decode_graphed_share=stats["decode_graphed_share"],
                    moe_expert_rows=stats["moe_expert_rows"],
                    window_cycles=cycles)
    return harness.Outcome(attempted=len(finished), failed=0,
                           metrics=metrics, device=device, checks=checks,
                           trace=trace, readings=readings)


@torch.no_grad()
def program_routes(model, sample, dev) -> List[torch.Tensor]:
    """The program's top-k expert ids [2N, T, k] per routed layer (cond
    rows first) on the sample's served tokens, teacher-forced through its
    decode step on a cache of its own (calibration only)."""
    from llamagen_tpu_torch.models import mla_moe

    cfg = model.cfg
    labels = torch.as_tensor([e["label"] for _, e in sample], device=dev)
    tokens = torch.as_tensor(np.stack([q.result for q, _ in sample]),
                             device=dev)
    n, t = tokens.shape
    dtype = model.tok_embeddings.weight.dtype
    cache = mla_moe.init_cache(cfg, 2 * n, cfg.max_seq_len, dtype, dev)
    seen: List[torch.Tensor] = []
    table = model.cls_embedding.embedding_table.weight
    emb = torch.cat([table[labels], table[torch.full_like(
        labels, cfg.num_classes)]])
    for i in range(t):
        if i:
            emb = model.tok_embeddings.weight[tokens[:, i - 1]].repeat(2, 1)
        pos = torch.full((2 * n,), i, dtype=torch.int32, device=dev)
        mla_moe.decode_step_slots(model, emb, pos, cache, dtype,
                                  route_ids=seen)
    layers = cfg.n_moe_layers
    return [torch.stack(seen[l::layers], dim=1) for l in range(layers)]


def judge(r: harness.Run, sample, routes=None):
    """The widest gap by which a served greedy token's logit lies below
    the reference's best; with the control, also the int4 reference's
    and the routing agreement (module docstring)."""
    c, t, dev = r.config, r.traffic, r.device
    limit = t["limits"]["greedy_gap"]
    if not sample:
        return {"greedy_gap": {"value": float("inf"), "limit": limit}}, {}
    tokens = torch.as_tensor(np.stack([q.result for q, _ in sample]),
                             device=dev)
    labels = torch.as_tensor([e["label"] for _, e in sample], device=dev)
    # the program's dtypes (`build_engine`)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    ref_routes: List[torch.Tensor] = []
    logits = ref.serve_logits(c, r.seed, dev, labels, tokens, t["cfg_scale"],
                              route_ids=ref_routes, latent_dtype=dt,
                              weight_dtype=dt)
    best = logits.max(-1).values
    gaps = best - logits.gather(-1, tokens[..., None])[..., 0]
    checks = {"greedy_gap": {"value": float(gaps.max()), "limit": limit}}
    readings = {"greedy_gap": float(gaps.max()),
                "tokens_checked": int(tokens.numel())}
    if "control" in r.extra:
        ctl = ref.serve_logits(c, r.seed, dev, labels, tokens,
                               t["cfg_scale"], weight_bits=4,
                               latent_dtype=dt, weight_dtype=dt).argmax(-1)
        readings["control_gap"] = float(
            (best - logits.gather(-1, ctl[..., None])[..., 0]).max())
    if routes is not None:
        differ = [(a.sort(-1).values != b.sort(-1).values).any(-1)
                  for a, b in zip(routes, ref_routes)]
        readings["route_differ_share"] = float(
            torch.stack(differ).float().mean())
    return checks, readings
