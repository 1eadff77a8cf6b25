"""The serving driver: the program's slot engine (`serve/engine.py::
ServeEngine`) at a fixed number of CFG pairs, closed loop, in the
staggered steady state.

Set-up: weights from the seed (bf16 on the device), the program's W8A16
quantisation of the layers and the head, an int8 KV cache; then the
slots are filled in `groups` equal groups, one group a cycle, each cycle
`group_gap_steps` decode steps long (the engine's chunk), so that from
then on one group finishes and is refilled every cycle. Two more cycles
warm every shape the window uses.

The window opens and closes with a device sync. `img_per_s` counts the
tokens sampled in it (the host mirror's progress of every slot, the
completed requests' and the running ones') over the tokens of an image;
`image_latency_p95_s` is the 95th percentile of admission to harvest
over the images completed in it. With `--trace 1` the window's second
cycle (one stagger period) is profiled.

Correctness: requests `i % greedy_every == 0` are greedy (temperature
0). After the window a sample of the greedy requests finished in it,
drawn from the seed, goes to the plain reference (`reference/gpt.py::
serve_logits`), which rebuilds the weights from the seed; the number
compared is the widest gap by which a served token's logit lies below
the reference's best at its position.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import harness, weights as wts
from perfbench.drivers import gpt_config
from perfbench.reference import gpt as ref


class Traffic:
    """The requests of a serving mix, from the seed: class labels uniform
    over the classes (c2i), or captions drawn from a pool of random
    T5-width rows with their valid counts uniform in [valid_min,
    valid_max] and left pads (t2i); request i is greedy where i %
    greedy_every == 0, the others sample."""

    def __init__(self, c: Dict, t: Dict, seed: int, dev: torch.device):
        self.c, self.t = c, t
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.count = 0
        self.t2i = c["model_type"] == "t2i"
        if self.t2i:
            n, rows = t["caption_pool"], c["cls_token_num"]
            feats = torch.empty(n, rows, c["caption_dim"], device=dev)
            feats.normal_(0.0, 1.0, generator=wts.generator(seed, 2, dev))
            valid = self.rng.integers(t["valid_min"], t["valid_max"] + 1, n)
            self.pads = rows - valid
            keep = torch.arange(rows, device=dev)[None, :] \
                >= torch.as_tensor(self.pads, device=dev)[:, None]
            self.captions = (feats * keep[..., None]).cpu()
            self.masks = keep.cpu()

    def next(self) -> Dict[str, Any]:
        i, self.count = self.count, self.count + 1
        greedy = i % self.t["greedy_every"] == 0
        if self.t2i:
            return {"pool": int(self.rng.integers(len(self.pads))),
                    "greedy": greedy}
        return {"label": int(self.rng.integers(self.c["num_classes"])),
                "greedy": greedy}


def build_engine(r: harness.Run):
    """The program's model and engine for the cell (set-up)."""
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine

    c, t, dev = r.config, r.traffic, r.device
    model = gpt.Transformer(gpt_config(c), device=dev, dtype=torch.bfloat16)
    model.load_state_dict(wts.gpt_weights(c, r.seed, dev, torch.bfloat16))
    model.eval()
    quantize_gpt_params(model, quantize_head=True)
    sp = SamplingParams(cfg_scale=t["cfg_scale"],
                        temperature=t["temperature"], top_k=t["top_k"],
                        top_p=t["top_p"])
    eng = ServeEngine(model, num_pairs=t["pairs"],
                      max_new_tokens=c["block_size"], sampling_params=sp,
                      chunk=t["group_gap_steps"], seed=r.seed % 2 ** 63,
                      compute_dtype=torch.bfloat16, cache_dtype=torch.int8)
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
    admitted: List[List[int]] = []  # pads of each admission (traced)

    if eng.t2i:
        admit = eng._admit_captions

        def admit_spanned(taken):
            for start in range(0, len(taken), eng._abatch):
                admitted.append([int(traffic.pads[q.pool])
                                 for _, q in taken[start:start
                                                   + eng._abatch]])
            with spans.span("admission"):
                admit(taken)

        eng._admit_captions = admit_spanned

    def submit(n: int) -> None:
        for _ in range(n):
            e = traffic.next()
            s = greedy_sp if e["greedy"] else sp
            if eng.t2i:
                q = eng.submit_caption(traffic.captions[e["pool"]],
                                       traffic.masks[e["pool"]], sp=s)
                q.pool = e["pool"]
            else:
                q = eng.submit(e["label"], sp=s)
            reqs.append((q, e))

    done = [0]

    def cycle() -> int:
        before = eng.steps_run
        with spans.span("step"):
            eng._admit_and_step()
        steps = eng.steps_run - before
        with spans.span("harvest"):
            eng._harvest()
        submit(eng._completed - done[0])  # closed loop: refill at once
        done[0] = eng._completed
        return steps

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
    spans.reset()
    w0, t0 = time.time(), time.perf_counter()
    p0, steps0 = progress(), eng.steps_run
    trace, traced_steps, cycles = None, 0, 0
    while True:
        if r.trace and cycles == 1:
            admitted.clear()
            traced_steps, trace = harness.profile(cycle, spans)
            pos_end = eng._slot_pos.copy()
            pads = (eng.state.prefix_pad.cpu().numpy()
                    if eng.t2i else np.zeros(eng.num_pairs, np.int64))
            adm = list(admitted)
        else:
            cycle()
        cycles += 1
        if time.perf_counter() - t0 >= r.seconds \
                and (trace is not None or not r.trace):
            break
    r.sync()
    w1, t1 = time.time(), time.perf_counter()
    p1, steps = progress(), eng.steps_run - steps0
    setup_s = w0 - r.started
    finished = [(q, e) for q, e in reqs
                if q.finished_at is not None and w0 <= q.finished_at <= w1]
    lat = [q.finished_at - q.admitted_at for q, _ in finished]
    metrics = {"img_per_s": (p1 - p0) / n_tok / (t1 - t0),
               "image_latency_p95_s": float(np.percentile(lat, 95))
               if lat else float("inf"),
               "setup_s": setup_s}
    if trace is not None:
        trace = trace()  # the profile read after the window
        trace.facts.update(
            config=c, driver="serve", pos_end=pos_end, n_steps=traced_steps,
            pads=pads, admissions=adm,
            host_ms_per_step=1e3 * spans.seconds.get("step", 0.0)
            / max(steps - traced_steps, 1))
    device = harness.device_record(dev, 1)

    # the check, after the window: a sample of the greedy requests
    greedy = [(q, e) for q, e in finished if e["greedy"]]
    rng = np.random.default_rng([r.seed % 2 ** 64, 3])
    pick = sorted(rng.choice(len(greedy), min(len(greedy),
                                              t["check_requests"]),
                             replace=False)) if greedy else []
    sample = [greedy[i] for i in pick]
    del eng, model
    harness.free_device(dev)
    checks, readings = judge(r, sample, traffic)
    return harness.Outcome(attempted=len(finished), failed=0,
                           metrics=metrics, device=device, checks=checks,
                           trace=trace, readings=readings)


def judge(r: harness.Run, sample, traffic: Traffic):
    """The widest gap by which a served greedy token's logit lies below
    the reference's best (and, with "control" in `r.extra`, that of the
    tokens the int4 control puts first)."""
    c, t, dev = r.config, r.traffic, r.device
    limit = t["limits"]["greedy_gap"]
    if not sample:
        return {"greedy_gap": {"value": float("inf"), "limit": limit}}, {}
    tokens = torch.as_tensor(np.stack([q.result for q, _ in sample]),
                             device=dev)
    pads = None
    if c["model_type"] == "t2i":
        cond = torch.stack([traffic.captions[e["pool"]]
                            for _, e in sample]).to(dev)
        pads = torch.as_tensor([int(traffic.pads[e["pool"]])
                                for _, e in sample], device=dev)
    else:
        cond = torch.as_tensor([e["label"] for _, e in sample], device=dev)
    w = wts.gpt_weights(c, r.seed, dev, torch.bfloat16)
    logits = ref.serve_logits(w, c, cond, tokens, t["cfg_scale"], pads)
    best = logits.max(-1).values
    gaps = best - logits.gather(-1, tokens[..., None])[..., 0]
    checks = {"greedy_gap": {"value": float(gaps.max()), "limit": limit}}
    readings = {"greedy_gap": float(gaps.max()),
                "tokens_checked": int(tokens.numel())}
    if "control" in r.extra:
        ctl = ref.serve_logits(w, c, cond, tokens, t["cfg_scale"], pads,
                               weight_bits=4).argmax(-1)
        readings["control_gap"] = float(
            (best - logits.gather(-1, ctl[..., None])[..., 0]).max())
    return checks, readings
