"""Times of the decode attention (K1), W8A16 matmul (K2), W4 matmul (K3)
and chunk attention (K5) kernels of one tree of the PyTorch port, for A/B
comparisons of kernel designs on one GPU.

Not a pytest file:

    python tests/bench_torch_kernels.py [--root DIR] [--label NAME] [out.json]
    python tests/bench_torch_kernels.py --sweep [out.json]

`--root` is the root of a checkout whose `llamagen_tpu_torch` is timed
(default: this one), for instance an unpacked `git archive` of an earlier
commit; its kernels build into its own `.build/`. The timing code is this
tree's `chip_smoke.py` (`time_decode_attention`, `time_int8_matmul`,
`time_w4_matmul`, `time_chunk_attention` without the plain versions and
library calls): K1 per call at pos 288, B 16, S 640, int8 and bf16 caches,
16 heads x 64 (and int8 at 32 heads x 100 where the tree takes it); K2
per call at B 16 on the five GPT-L and four GPT-3B layer shapes; K3 per
call at the five GPT-L layer shapes, B 16 and 80, grouped g128; K5 per
call at pos 288, B 16, 16 heads x 64, bf16, C 5, 1 and 8. Each is a CUDA
graph of one call per buffer set. Run trees in turns in one call (A, B,
B, A): numbers from different cards or calls are not comparable.

`--sweep` times this tree's kernels at launch geometries other than the
ones `w4_geometry`, `int8_geometry` and `chunk_geometry` pick, by calling
the C entry points directly: K3 at every cluster size its group size
allows (grouped g128 and per channel, B 16 and 80), K2 at 64- and
128-column tiles (B 16, the GPT-L and GPT-3B shapes), K5 at 1, 2, 4 and
8 splits (C 5 and 1 at pos 288; C 5 at pos 32 and 560).

Prints a JSON object as its last line (and writes it to `out.json` when
given). Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def sweep(smoke, dev):
    """{label: ms} of K3 and K5 at forced launch geometries."""
    import torch
    from llamagen_tpu_torch.ops import _build
    from llamagen_tpu_torch.ops import w4_matmul as w4

    def stream():  # read inside the call, so graph capture sees its stream
        return torch.cuda.current_stream().cuda_stream

    g = torch.Generator(device=dev).manual_seed(5)
    res = {}
    k3 = _build.c_function("w4_matmul_bf16", 4, 9)
    for name, (k, n) in smoke.GPT_L_MATMULS.items():
        if name == "w3":  # w1's shape
            continue
        k2, bn = k // 2, w4._pick_bn(n)
        sets = max(24, -(-128 * 2 ** 20 // (k * n // 2)))
        for seg in (128, None):
            layers = [w4.pack_w4(torch.randn(k, n, generator=g, device=dev)
                                 * 0.02, per_channel=seg is None)
                      for _ in range(sets)]
            unit, done = seg or 16, set()
            for want in range(1, 9):
                per = -(-(-(-k2 // unit)) // want)
                kb = per * unit
                ks = -(-k2 // kb)
                if ks in done:
                    continue
                done.add(ks)
                for b in (16, 80):
                    if w4._smem_bytes(kb, b, seg) > w4._MAX_SMEM:
                        continue
                    x = torch.randn(b, k, generator=g, device=dev).to(
                        torch.bfloat16)
                    out = torch.empty(b, n, dtype=torch.bfloat16,
                                      device=dev)
                    res[f"K3 {name} {'g128' if seg else 'per-channel'} B "
                        f"{b} cluster {ks}"] = smoke.graph_ms([
                            lambda w=w, x=x, out=out, ks=ks, kb=kb, b=b:
                            _build.check(k3(
                                x.data_ptr(), w[0].data_ptr(),
                                w[1].data_ptr(), out.data_ptr(), b, k2, n,
                                bn, w[1].shape[1], seg or 0, ks, kb, b,
                                stream()), "w4_matmul_bf16")
                            for w in layers])
            del layers
    from llamagen_tpu_torch.ops import quant_matmul as qm
    k2 = _build.c_function("int8_matmul_bf16", 4, 7)
    sms = _build.sm_count(dev.index or 0)
    for name, (k, n) in dict(smoke.GPT_L_MATMULS,
                             **smoke.GPT_3B_MATMULS).items():
        if name == "w3":  # w1's shape
            continue
        layers = [qm.quantize_weight(torch.randn(k, n, generator=g,
                                                 device=dev) * 0.02)
                  for _ in range(24)]
        x = torch.randn(16, k, generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty(16, n, dtype=torch.bfloat16, device=dev)
        for cols in (64, 128):
            geo = qm.int8_geometry(16, k, n, sms, cols=cols)
            res[f"K2 {name} B 16 cols {cols} cluster {geo.ks}"] = \
                smoke.graph_ms([
                    lambda w=w, geo=geo: _build.check(k2(
                        x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(),
                        out.data_ptr(), 16, k, n, geo.cols, geo.ks, geo.kb,
                        geo.bc, stream()), "int8_matmul_bf16")
                    for w in layers])
        del layers
    k5 = _build.c_function("chunk_attention_bf16_bf16", 6, 8, 1)
    b, h, s = 16, 16, 640
    for c, pos in ((5, 288), (1, 288), (5, 32), (5, 560)):
        states = [smoke.chunk_state(dev, b, h, h, s, c, torch.bfloat16,
                                    100 + i) for i in range(24)]
        pos_t = torch.full((b,), pos, dtype=torch.int32, device=dev)
        out = torch.empty_like(states[0][0])
        for nsplit in (1, 2, 4, 8):
            res[f"K5 C {c} pos {pos} splits {nsplit}"] = smoke.graph_ms([
                lambda st=st, nsplit=nsplit: _build.check(k5(
                    st[0].data_ptr(), st[1].data_ptr(), st[2].data_ptr(),
                    pos_t.data_ptr(), None, out.data_ptr(), b, c, s, h, h,
                    64, 1, nsplit, 64 ** -0.5, stream()),
                    "chunk_attention_bf16_bf16")
                for st in states])
        del states
    for key, ms in res.items():
        print(f"{key}: {ms:.4f} ms", flush=True)
    return res


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import llamagen_tpu_torch
    from llamagen_tpu_torch.ops import _build
    if Path(llamagen_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {llamagen_tpu_torch.__file__}, "
                         f"not the package under {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: {root}, library {_build.build().name}, card "
          f"{card}", flush=True)
    if args.sweep:
        res = {"label": args.label, "card": card, "sweep_ms": sweep(smoke,
                                                                    dev)}
    else:
        shapes = (("bf16", 16, 64), ("int8", 16, 64), ("int8", 32, 100))
        try:  # a tree before head_dim 100 refuses it on the card
            k1 = smoke.time_decode_attention(dev, full=False, shapes=shapes)
        except ValueError as e:
            print(f"K1 at head_dim 100: {e}", flush=True)
            k1 = smoke.time_decode_attention(dev, full=False,
                                             shapes=shapes[:2])
        k2 = smoke.time_int8_matmul(dev, full=False)
        k3 = smoke.time_w4_matmul(dev, full=False)
        k5 = smoke.time_chunk_attention(dev, full=False)
        res = {"label": args.label, "root": str(root), "card": card,
               "k1_ms": {key: t["ms"] for key, t in k1.items()},
               "k2_ms": {key: t["ms"] for key, t in k2.items()},
               "k3_ms": {f"{name} B {b}": t["ms"]
                         for (name, b), t in k3.items()},
               "k5_ms": {f"C {c}": t["ms"] for c, t in k5.items()}}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
