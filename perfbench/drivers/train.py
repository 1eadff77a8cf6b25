"""The training driver: the program's training step (`train/c2i.py::
make_train_step`, or `train/t2i.py`'s over a frozen bf16 VQ-16 encode) on
one card, as `build_trainer` makes it: bf16 compute over f32 masters,
AdamW, EMA, full remat and the configuration's dropouts.

Set-up builds the trainer from weights made from the seed and drives it
through the check steps (their batches all differ, each drawn from the
seed and the step's index, through the window's own call), then one
more; the window then dispatches steps until `--seconds` have passed,
each step's loss read back `ahead_steps` steps late (a few seconds of
steps queued ahead of the one waited for, so that the card runs on while
the host stalls). When the time is up nothing more is sent, every step
sent is waited for, and the clock is read after that wait:
`train_samples_per_s` is the batch times all those steps over all that
time. With `--trace 1` three of the window's steps are profiled.

Correctness: the first step's loss and global gradient norm, each
leaf's norm of the first gradient as the optimizer took it (Adam's first
moment after one step over 1 - beta1), the losses of the check steps and
each leaf's norm of the change over them are held against the plain
reference (`reference/gpt.py::train_steps`), run after the window on
weights and batches made again from the seed.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import harness, weights as wts
from perfbench.drivers import gpt_config
from perfbench.reference import gpt as ref


def batch_at(r: harness.Run, i: int) -> Dict[str, torch.Tensor]:
    """Batch i of the run, from the seed: c2i class labels and codes
    uniform; t2i images uniform in [-1, 1], caption rows normal(0, 1)
    with valid counts uniform in [valid_min, valid_max], left-padded."""
    c, t, dev = r.config, r.traffic, r.device
    g = wts.generator(r.seed, 1000 + i, dev)
    b = t["batch"]
    if c["model_type"] == "c2i":
        return {"cond": torch.randint(0, c["num_classes"], (b,),
                                      generator=g, device=dev),
                "tokens": torch.randint(0, c["vocab_size"],
                                        (b, c["block_size"]), generator=g,
                                        device=dev)}
    size, rows = c["image_size"], c["cls_token_num"]
    images = torch.rand(b, size, size, 3, generator=g, device=dev) * 2 - 1
    caps = torch.randn(b, rows, c["caption_dim"], generator=g, device=dev)
    valid = torch.randint(t["valid_min"], t["valid_max"] + 1, (b,),
                          generator=g, device=dev)
    masks = torch.arange(rows, device=dev)[None, :] >= (rows - valid)[:, None]
    return {"images": images, "cond": caps * masks[..., None],
            "masks": masks.to(torch.int32),
            "valid": torch.ones(b, device=dev)}


def _program_batch(r: harness.Run, b: Dict[str, torch.Tensor]):
    from llamagen_tpu_torch.train import c2i, t2i

    if r.config["model_type"] == "c2i":
        return c2i.Batch(labels=b["cond"], tokens=b["tokens"])
    return t2i.T2IBatch(images=b["images"], captions=b["cond"],
                        emb_masks=b["masks"], valid=b["valid"])


def vq_shapes(vc: Dict):
    from llamagen_tpu_torch.config import VQConfig
    from llamagen_tpu_torch.models.vq import VQModel

    cfg = VQConfig(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in vc.items()})
    meta = VQModel(cfg, device="meta", encoder=True)
    return cfg, [(k, tuple(v.shape)) for k, v in meta.state_dict().items()]


def build_trainer(r: harness.Run, spans: harness.Spans, codes: List):
    """The program's trainer for the cell (set-up). While `codes` holds
    None at its end, the ids of each VQ encode replace it (t2i)."""
    from llamagen_tpu_torch.models.vq import VQModel
    from llamagen_tpu_torch.train import c2i, t2i

    c, dev = r.config, r.device
    tc = c["train"]
    kw = dict(lr=tc["lr"], weight_decay=tc["weight_decay"],
              beta1=tc["betas"][0], beta2=tc["betas"][1],
              max_grad_norm=tc["max_grad_norm"],
              warmup_steps=tc["warmup_steps"], use_ema=True,
              ema_decay=tc["ema_decay"], param_dtype=torch.float32,
              compute_dtype=torch.bfloat16, remat=tc["remat"],
              weights=wts.gpt_weights(c, r.seed, dev, torch.float32))
    if c["model_type"] == "c2i":
        return c2i.build_trainer(gpt_config(c), dev, **kw)
    vcfg, shapes = vq_shapes(c["vq"])
    vq_model = VQModel(vcfg, device=dev, dtype=torch.bfloat16, encoder=True)
    vq_model.load_state_dict(wts.vq_weights(shapes, r.seed, dev,
                                            torch.bfloat16))
    vq_model.eval()
    encode = vq_model.encode

    def encode_spanned(*a, **k):
        with spans.span("vq_encode"):
            out = encode(*a, **k)
        if codes and codes[-1] is None:
            codes[-1] = out[2].reshape(out[2].shape[0], -1).clone()
        return out

    vq_model.encode = encode_spanned
    return t2i.build_trainer(gpt_config(c), vq_model, dev, **kw)


class LateReads:
    """Each step's loss copied behind the step into pinned host memory,
    with an event after the copy, and read only once `ahead` newer steps
    have been dispatched: waiting on the event waits for that step alone,
    where reading the device tensor would wait for every step sent."""

    def __init__(self, ahead: int, device: torch.device):
        self.ahead, self.cuda = ahead, device.type == "cuda"
        n = ahead + 2
        self.host = torch.empty(n, dtype=torch.float32,
                                pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(n)] \
            if self.cuda else []
        self.pending: collections.deque = collections.deque()
        self.sent = 0
        self.losses: List[float] = []

    def push(self, loss: torch.Tensor) -> None:
        i = self.sent % len(self.host)
        self.host[i].copy_(loss.detach().float(), non_blocking=self.cuda)
        if self.cuda:
            self.events[i].record()
        self.pending.append(i)
        self.sent += 1
        while len(self.pending) > self.ahead:
            self._read()

    def drain(self) -> None:
        while self.pending:
            self._read()

    def _read(self) -> None:
        i = self.pending.popleft()
        if self.cuda:
            self.events[i].synchronize()
        self.losses.append(float(self.host[i]))


def run(r: harness.Run) -> harness.Outcome:
    c, t, dev = r.config, r.traffic, r.device
    spans = harness.Spans()
    codes: List = []  # the program's VQ codes of the check steps (t2i)
    state, step_fn = build_trainer(r, spans, codes)
    step_fn = r.plant("train_step", step_fn)
    seed = r.seed % 2 ** 40  # the trainer's dropout seed
    names = [n for n, _ in state.model.named_parameters()]
    count = [0]

    def step():
        if count[0] < t["check_steps"]:
            codes.append(None)
        with spans.span("data"):
            b = _program_batch(r, batch_at(r, count[0]))
        with spans.span("step"):
            _, m = step_fn(state, b, seed)
        count[0] += 1
        return m

    # the check steps, through the window's call
    params = dict(state.model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    losses: List[torch.Tensor] = []
    m = step()
    losses.append(m["loss"])
    grad_norm = m["grad_norm"]
    b1 = r.config["train"]["betas"][0]
    opt_state = state.optimizer.opt.state
    grad_leaf = torch.stack([
        torch.linalg.vector_norm(opt_state[params[n]]["exp_avg"].double())
        / (1 - b1) if params[n] in opt_state else
        torch.zeros((), dtype=torch.float64, device=dev) for n in names])
    for _ in range(t["check_steps"] - 1):
        losses.append(step()["loss"])
    change = torch.stack([
        torch.linalg.vector_norm((params[n].detach() - start[n]).double())
        for n in names])
    del start
    program = {"losses": [float(x) for x in losses],
               "grad_norm": float(grad_norm),
               "grad_leaf": dict(zip(names, grad_leaf.tolist())),
               "change_leaf": dict(zip(names, change.tolist())),
               "codes": [x for x in codes if x is not None]}
    for _ in range(t["warm_steps"]):
        float(step()["loss"])

    late = LateReads(t.get("ahead_steps", 8), dev)
    r.sync()
    spans.reset()
    w0, t0 = time.time(), time.perf_counter()
    steps, trace = 0, None
    while True:
        if r.trace and steps == 1:
            n = t["trace_steps"]
            _, trace = harness.profile(
                lambda: [float(step()["loss"]) for _ in range(n)], spans)
            steps += n
        else:
            late.push(step()["loss"])
            steps += 1
        if time.perf_counter() - t0 >= r.seconds \
                and (trace is not None or not r.trace):
            break
    late.drain()
    r.sync()
    t1 = time.perf_counter()
    metrics = {"train_samples_per_s": steps * t["batch"] / (t1 - t0),
               "setup_s": w0 - r.started}
    if trace is not None:
        trace = trace()  # the profile read after the window
        trace.facts.update(config=c, driver="train", steps=t["trace_steps"],
                           batch=t["batch"])
    device = harness.device_record(dev, 1)
    del state, step_fn
    harness.free_device(dev)
    checks, readings = judge(r, program)
    return harness.Outcome(attempted=steps, failed=0, metrics=metrics,
                           device=device, checks=checks, trace=trace,
                           readings=readings)


def reference_batches(r: harness.Run, codes: List[torch.Tensor],
                      control: bool = False):
    """The check steps' batches made again from the seed, and (t2i) the
    widest gap of the program's VQ codes `codes`: by how much the squared
    distance from the plain encode's l2-normalised latent to the chosen
    code exceeds that to the nearest code, over every position. The GPT
    steps then take the program's codes as their tokens: the reference
    follows the program from there, the encode being judged by itself.
    With `control`, the codes judged are those of the float8 control
    encode instead (the GPT steps keep the program's)."""
    c, t = r.config, r.traffic
    out, gap = [], None
    if c["model_type"] == "t2i":
        from perfbench.reference import vq as vq_ref
        _, shapes = vq_shapes(c["vq"])
        vw = wts.vq_weights(shapes, r.seed, r.device, torch.bfloat16)
        gap = 0.0
    for i in range(t["check_steps"]):
        b = batch_at(r, i)
        if gap is not None and (i >= len(codes) or codes[i].shape
                                != (t["batch"], c["block_size"])):
            # codes missing or of the wrong shape: no encode to judge
            gap = float("inf")
            b["tokens"] = torch.cat([
                vq_ref.encode_ids(vw, c["vq"], b["images"][j:j + 8])
                for j in range(0, t["batch"], 8)])
            del b["images"]
        elif gap is not None:
            for j in range(0, t["batch"], 8):
                img = b["images"][j:j + 8]
                d = vq_ref.distances(vw, c["vq"], img)
                mine = (vq_ref.encode_ids(vw, c["vq"], img, fp8=True)
                        if control else codes[i][j:j + 8])
                got = d.gather(-1, mine[..., None])[..., 0]
                gap = max(gap, float((got - d.min(-1).values).max()))
            b["tokens"] = codes[i]
            del b["images"]
        out.append(b)
    return out, gap


def compare(p: Dict[str, Any], q: Dict[str, Any]) -> Dict[str, float]:
    """The numbers compared between a program's readings `p` and the
    reference's `q`: the largest relative gap of a check step's loss, of
    the first step's gradient norm, and, by the worst leaf, of the first
    gradient's and of the change's norms, each against the reference
    leaf's norm or the median leaf's, whichever is larger. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(p["losses"], q["losses"]))
    gn = abs(p["grad_norm"] - q["grad_norm"]) / q["grad_norm"]
    g_med = float(np.median(list(q["grad_leaf"].values())))
    c_med = float(np.median(list(q["change_leaf"].values())))
    grad = max(abs(p["grad_leaf"][k] - v) / max(v, g_med)
               for k, v in q["grad_leaf"].items())
    change = max(abs(p["change_leaf"][k] - v) / max(v, c_med)
                 for k, v in q["change_leaf"].items()
                 if q["grad_leaf"][k] >= g_med / 1000)
    return {"loss": loss, "grad_norm": gn, "grad_leaf": grad,
            "change_leaf": change}


def judge(r: harness.Run, program: Dict[str, Any]):
    c, t = r.config, r.traffic
    w = wts.gpt_weights(c, r.seed, r.device, torch.float32)
    batches, code_gap = reference_batches(r, program["codes"])
    seed = r.seed % 2 ** 40
    reference = ref.train_steps(w, c, c["train"], batches, seed)
    got = compare(program, reference)
    if code_gap is not None:
        got["vq_code_gap"] = code_gap
    limits = t["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()
              if limits.get(k) is not None}
    readings = {"program": got}
    if "control" in r.extra:
        readings["control"] = compare(
            ref.train_steps(w, c, c["train"], batches, seed,
                            fp8_linear=True), reference)
        if code_gap is not None:
            readings["control"]["vq_code_gap"] = reference_batches(
                r, program["codes"], control=True)[1]
    return checks, readings
