"""Serving-engine throughput and where its step time goes, for the PyTorch
port on one GPU (the counterpart of `tests/bench_engine.py`).

Not a pytest file:

    python tests/bench_torch_engine.py [--model GPT-L] [--pairs 64]
        [--reqs 192] [--bf16] [--profile-steps 32] [--out out.json]
    python tests/bench_torch_engine.py --t2i [--pairs 8] [--reqs 24]

Defaults: `bench.py`'s engine point: GPT-L 384 (576 tokens), random
seeded weights with a random head, W8A16 layer weights and head + int8 KV
cache, 64 CFG pairs (128 rows), 3 x 64 requests, chunk 64, cfg 2.0,
sampled at temperature 1.0. `--pairs 16 --reqs 48` is the point of
`tests/bench_engine.py`, which quantises the head too; `--bf16`: bf16
weights, head and cache. `--t2i`: the t2i engine at
`tests/bench_t2i_engine.py`'s point: GPT-XL 256 px (120 caption tokens,
256 image tokens), W8A16 layers and head + int8 KV, 8 pairs, 24 caption
requests left-padded by counts in [0, 60) from RandomState(0), cfg 7.5;
the profile also times one admission of `--pairs` captions (the batched
caption prefill and the scatter into the slots).

1. Throughput at capacity: after a warm-up drain, `--reqs` requests queued
   at once; prints img/s, wall time, steps, ms per step and the engine's
   `stats()` (e2e, TTFT, TPOT mean and percentiles).
2. A `torch.profiler` pass at capacity (every slot busy, around the mean
   position: `--pairs` requests admitted and run to position 256):
   `--profile-steps` engine steps run on the host clock (ending in a
   device sync), then as many again under the profiler; per engine step:
   wall ms, device busy ms (the union of kernel intervals), the idle
   share, kernels launched and device ms by group, grouped as
   `tests/bench_torch_sample.py` groups them.

Prints a JSON object as its last line (and writes it to `--out`). Needs a
CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch_sample import _profile  # noqa: E402
from chip_smoke import t2i_engine_requests  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default=None, help="GPT-L (c2i), GPT-XL (t2i)")
    p.add_argument("--pairs", type=int, default=None, help="64 (t2i: 8)")
    p.add_argument("--reqs", type=int, default=None, help="192 (t2i: 24)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--t2i", action="store_true")
    p.add_argument("--profile-steps", type=int, default=32)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t2i = args.t2i
    args.model = args.model or ("GPT-XL" if t2i else "GPT-L")
    args.pairs = args.pairs or (8 if t2i else 64)
    args.reqs = args.reqs or (24 if t2i else 192)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # c2i: 384 px; t2i: 256 px after 120 caption tokens
    tokens = 256 if t2i else 576
    start = 120 if t2i else 0  # a slot's position after admission
    cfg = gpt_config(args.model, block_size=tokens,
                     cls_token_num=start or 1,
                     model_type="t2i" if t2i else "c2i")
    model = gpt.init_weights(gpt.Transformer(cfg, device=dev,
                                             dtype=torch.bfloat16), seed=0)
    with torch.no_grad():  # the reference init zeroes the head
        model.output.weight.normal_(0.0, 0.02, generator=torch.Generator(
            device=dev).manual_seed(1))
    model.eval()
    if not args.bf16:  # both JAX engine benches quantise the head too
        quantize_gpt_params(model, quantize_head=True)
    sp = SamplingParams(cfg_scale=7.5 if t2i else 2.0)

    def engine(chunk):
        return ServeEngine(model, num_pairs=args.pairs, max_new_tokens=tokens,
                           sampling_params=sp, chunk=chunk,
                           compute_dtype=torch.bfloat16,
                           cache_dtype=torch.bfloat16 if args.bf16
                           else torch.int8)

    if t2i:
        caps, masks = t2i_engine_requests(args.reqs)

        def run(eng, idx):
            return eng.generate_t2i(caps[idx], masks[idx])

        def submit(eng, i):
            eng.submit_caption(caps[i], masks[i])
    else:
        labels = np.asarray([i * 17 % 1000 for i in range(args.reqs)])

        def run(eng, idx):
            return eng.generate(labels[idx])

        def submit(eng, i):
            eng.submit(labels[i])

    eng = engine(64)
    res = {"card": smi, "model": args.model, "kind": "t2i" if t2i else "c2i",
           "pairs": args.pairs, "requests": args.reqs,
           "weights_kv": "bf16" if args.bf16 else
           "W8A16 layers and head + int8 KV"}

    # 1. throughput at capacity, after a warm-up drain
    run(eng, np.arange(args.pairs) % args.reqs)
    torch.cuda.synchronize()
    eng.reset_stats()
    steps0, adm0 = eng.steps_run, eng.admissions
    t0 = time.time()
    out = run(eng, np.arange(args.reqs))
    secs = time.time() - t0
    steps = eng.steps_run - steps0
    assert out.shape == (args.reqs, tokens)
    res.update(seconds=secs, img_s=args.reqs / secs, steps=steps,
               admissions=eng.admissions - adm0,
               ms_per_step=1e3 * secs / steps, stats=eng.stats())
    print(f"engine {args.model} {16 * int(tokens ** 0.5)} {res['kind']} "
          f"({args.pairs} pairs, {res['weights_kv']}): {args.reqs} requests "
          f"in {secs:.2f} s = {res['img_s']:.3f} img/s, {steps} steps, "
          f"{res['ms_per_step']:.2f} ms/step")
    print("stats " + json.dumps(res["stats"]))

    # 2. the profile at capacity: every slot busy for the steps profiled,
    # around the mean position of a request (c2i from position 256, t2i
    # from 216: 120 caption rows + 96)
    del eng
    eng = engine(args.profile_steps)
    first = start + (96 if t2i else 256)
    assert first + 2 * args.profile_steps <= start + tokens
    if t2i:  # one admission of `pairs` captions, profiled alone
        def admission():
            for i in range(args.pairs):
                submit(eng, i)
            taken = [(i, eng.pending.get()) for i in range(args.pairs)]
            eng._admit_captions(taken)
            torch.cuda.synchronize()
            return 1

        res["admission"] = _profile(admission)
        r = res["admission"]
        print(f"t2i admission of {args.pairs} captions ({2 * args.pairs} x "
              f"120 rows): wall {r['wall_ms']:.2f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, {r['kernels']:.0f} kernels")
        for g, ms in sorted(r["device_ms_by_group"].items(),
                            key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {g}")
        eng = engine(args.profile_steps)
    for i in range(args.pairs):
        submit(eng, i)
    while eng.steps_run < first - start:  # admission, then to `first`
        eng._admit_and_step()

    def steps_at_capacity():
        before = eng.steps_run
        eng._admit_and_step()
        torch.cuda.synchronize()
        return eng.steps_run - before

    res["engine_step"] = _profile(steps_at_capacity)
    res["engine_step"]["positions"] = [
        start + eng.steps_run - 2 * args.profile_steps,
        start + eng.steps_run - 1]
    eng.run_until_idle()
    r = res["engine_step"]
    print(f"engine step (x{r['units']}, {2 * args.pairs} rows): wall "
          f"{r['wall_ms']:.2f} ms, device busy {r['device_busy_ms']:.3f} ms "
          f"(idle {100 * r['idle_share']:.1f} %), {r['kernels']:.0f} "
          f"kernels")
    for g, ms in sorted(r["device_ms_by_group"].items(),
                        key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {g}")
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
