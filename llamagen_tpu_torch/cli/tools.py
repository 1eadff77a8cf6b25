"""Utility tools CLI (PyTorch port), the subcommands of
`llamagen_tpu/cli/tools.py`:

  quantize-ckpt     pre-quantise a GPT checkpoint for serving: W8A16
                    (`--mode int8`) or the W4A16 kernel layout (`w4`: group
                    scales, `w4-pc`: per-channel scales), its int4 levels by
                    round-to-nearest or calibrated GPTQ (`--method gptq`),
                    optionally after AWQ equalisation (`--awq`). The output
                    is a `torch.save` state dict whose `weight_q` /
                    `weight_w4b` keys `cli/common.py::load_gpt` loads
                    (`sample_c2i --gpt-ckpt` / `--draft-gpt-ckpt`).
  convert-ckpt      a released checkpoint in any of upstream's dict layouts
                    (a plain state dict, {"model"}, {"module"},
                    {"state_dict"}; `module.` prefixes) -> the port's plain
                    f32 state dict
  validate-release  released weights end to end: convert, hold the port
                    against upstream LlamaGen (`--reference`; SKIP when it
                    is absent), sample a grid, print the FID protocol
  check-codes       decode dumped code grids to an image grid
  class-name        ImageNet class names (the port's copy of the table)
  export-hub        a checkpoint -> a hub-layout directory (`utils/hub.py`),
                    optionally pushed
  index-images      walk an image tree, keep what opens, write
                    image_paths.json (alias: openimage-json)
  plot-metrics      loss and throughput curves from metrics.jsonl

PIL, matplotlib, safetensors and huggingface_hub are imported inside the
subcommands that use them.

  python -m llamagen_tpu_torch.cli.tools quantize-ckpt --in c2i_L_384.pt \\
      --out c2i_L_384_gptq.pt --mode w4 --method gptq --awq \\
      --gpt-model GPT-L --image-size 384
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import (get_device, load_gpt, load_vq,
                                           save_image_grid)
from llamagen_tpu_torch.config import GPTConfig


def calibration_set(args, cfg: GPTConfig, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cond, tokens [n, block_size]) of the GPTQ / AWQ calibration pass:
    token ids from `--calib-codes` (a .npy dump [N, L], `extract_codes`
    layout) or random ids, then random class labels, from
    RandomState(--calib-seed), as the JAX CLI draws them. A t2i model gets
    random caption features [n, T, caption_dim] (normal, drawn after the
    labels) in place of labels."""
    rng = np.random.RandomState(args.calib_seed)
    n = args.calib_samples
    if args.calib_codes:
        codes = np.load(args.calib_codes, mmap_mode="r")
        tokens = np.asarray(codes[:n]).reshape(n, -1)[:, :cfg.block_size]
    else:
        tokens = rng.randint(0, cfg.vocab_size, size=(n, cfg.block_size))
    cond = rng.randint(0, cfg.num_classes, size=(n,))
    if cfg.model_type == "t2i":
        cond = rng.standard_normal(
            (n, cfg.cls_token_num, cfg.caption_dim)).astype(np.float32)
    return (torch.as_tensor(cond, device=device),
            torch.as_tensor(tokens.astype(np.int64), device=device))


def cmd_quantize_ckpt(args, hessians=None) -> None:
    """int8: W8A16; w4 / w4-pc: W4A16 levels by round-to-nearest or
    GPTQ, after AWQ equalisation with `--awq` (both calibrate on the same
    `calibration_set`). `hessians` goes to `gptq_quantize_gpt_params`."""
    from llamagen_tpu_torch.ops.awq import awq_equalize_gpt_params
    from llamagen_tpu_torch.ops.gptq import gptq_quantize_gpt_params
    from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k

    device = get_device(args.device)
    model = load_gpt(args.input, args.gpt_model, args.image_size,
                     args.downsample_size, torch.bfloat16, device,
                     model_type=args.model_type)
    w4 = dict(per_channel=args.mode == "w4-pc", group_size=args.group)
    calibrated = args.mode != "int8" and (args.awq or args.method == "gptq")
    if calibrated:
        cond, tokens = calibration_set(args, model.cfg, device)
    if args.mode != "int8" and args.awq:
        awq_equalize_gpt_params(model, cond, tokens, verbose=True, **w4)
    if args.mode == "int8":
        quantize_gpt_params(model, quantize_head=args.quantize_head)
    elif args.method == "gptq":
        gptq_quantize_gpt_params(model, cond, tokens,
                                 int8_head=args.quantize_head, verbose=True,
                                 hessians=hessians, **w4)
    else:
        quantize_gpt_params_w4k(model, int8_head=args.quantize_head, **w4)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               args.output)
    print(f"quantized ({args.mode}, {args.method}"
          f"{', awq' if calibrated and args.awq else ''}) {args.input} -> "
          f"{args.output}")


def cmd_convert_ckpt(args) -> None:
    cpu = torch.device("cpu")
    if args.kind == "gpt":
        model = load_gpt(args.input, args.gpt_model, args.image_size,
                         args.downsample_size, torch.float32, cpu,
                         model_type=args.model_type)
    else:
        model = load_vq(args.input, args.vq_model, args.codebook_size,
                        args.codebook_embed_dim, torch.float32, cpu,
                        encoder=True)
    torch.save(model.state_dict(), args.output)
    print(f"converted {args.input} -> {args.output}")


def _oracle(args, model, vq) -> str:
    """The conversion gate against upstream LlamaGen on the CPU, in f32:
    teacher-forced logits, greedy CFG tokens, VQ encode ids and
    decode_code. Returns the summary line; raises ImportError when the
    reference (or torch's pieces it needs) cannot be imported."""
    import sys

    from llamagen_tpu_torch.models import gpt as gpt_lib
    from llamagen_tpu_torch.ops.generate import generate
    from llamagen_tpu_torch.utils.convert import load_torch_state_dict

    if args.reference not in sys.path:
        sys.path.insert(0, args.reference)
    from autoregressive.models import generate as ref_generate
    from autoregressive.models.gpt import GPT_models
    from tokenizer.tokenizer_image.vq_model import VQ_models

    cfg = model.cfg
    n = args.oracle_tokens
    ref = GPT_models[args.gpt_model](
        vocab_size=cfg.vocab_size, block_size=cfg.block_size,
        num_classes=cfg.num_classes, cls_token_num=cfg.cls_token_num,
        model_type=args.gpt_type)
    # strict=False tolerates the derived buffers only; a missing weight
    # would run the gate on random init
    inc = ref.load_state_dict(load_torch_state_dict(args.gpt_pt),
                              strict=False)
    bad = [k for k in inc.missing_keys
           if not k.endswith(("freqs_cis", "causal_mask"))]
    if bad or inc.unexpected_keys:
        raise AssertionError(f"reference GPT state dict mismatch: missing "
                             f"{bad}, unexpected {inc.unexpected_keys}")
    ref = ref.eval().float()
    rng = np.random.RandomState(0)
    labels = torch.as_tensor(rng.randint(0, cfg.num_classes, size=(2,)))
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, n)))
    with torch.no_grad():
        ref_logits, _ = ref(tokens[:, :-1], labels,
                            input_pos=torch.arange(cfg.cls_token_num + n - 1),
                            targets=tokens)
        ours, _ = gpt_lib.forward_train(model, labels, tokens[:, :-1],
                                        train=False)
    err = (ours[:, :n] - ref_logits[:, cfg.cls_token_num - 1:][:, :n]) \
        .abs().max().item()
    if not err < args.oracle_atol:
        raise AssertionError(f"teacher-forced GPT logits diverge: "
                             f"max|err| {err:.2e}")
    ref_seq = ref_generate.generate(ref, labels, n, cfg_scale=2.0,
                                    sample_logits=False)
    seq = generate(model, labels, max_new_tokens=n, cfg_scale=2.0,
                   sample_logits=False, compute_dtype=torch.float32,
                   cache_dtype=torch.float32)
    if not torch.equal(seq, ref_seq.long()):
        raise AssertionError("greedy CFG tokens differ from the reference")

    ref_vq = VQ_models[args.vq_model](
        codebook_size=args.codebook_size,
        codebook_embed_dim=args.codebook_embed_dim)
    inc = ref_vq.load_state_dict(load_torch_state_dict(args.vq_pt),
                                 strict=False)
    if inc.missing_keys or inc.unexpected_keys:
        raise AssertionError(f"reference VQ state dict mismatch: missing "
                             f"{inc.missing_keys}, unexpected "
                             f"{inc.unexpected_keys}")
    ref_vq = ref_vq.eval().float()
    x = torch.as_tensor(np.random.RandomState(42).uniform(
        -1, 1, size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        _, _, (_, _, ref_idx) = ref_vq.encode(x.permute(0, 3, 1, 2))
        _, _, idx = vq.encode(x)
        grid = idx.shape[1]
        if not torch.equal(idx.reshape(2, -1), ref_idx.reshape(2, -1)):
            raise AssertionError("VQ encode ids differ from the reference")
        ref_img = ref_vq.decode_code(
            ref_idx.reshape(2, -1).long(),
            shape=(2, vq.cfg.codebook_embed_dim, grid, grid))
        img = vq.decode_code(idx)
    rec = (img - ref_img.permute(0, 2, 3, 1)).abs().max().item()
    if not rec < args.oracle_atol * 10:
        raise AssertionError(f"VQ decode_code diverges: max|err| {rec:.2e}")
    return (f"gpt logits max|err| {err:.1e}; greedy tokens 100%; vq ids "
            f"100%; decode max|err| {rec:.1e}")


def cmd_validate_release(args) -> None:
    """Released weights in one command; each step prints PASS or SKIP:
    1. convert: the GPT and VQ `.pt` files -> the port's f32 state dicts
       under --out (`gpt.pt`, `vq.pt`);
    2. oracle: the same state dicts in upstream LlamaGen (`--reference`)
       against the port (`_oracle`), SKIP without --reference or when it
       cannot be imported;
    3. sample: an 8-image CFG grid (bf16) on --device, `sample_grid.png`;
    4. the FID protocol: the `cli/sample_c2i_fid.py` and `cli/evaluate.py`
       commands for the converted weights, printed to run."""
    from llamagen_tpu_torch.ops.generate import generate

    os.makedirs(args.out, exist_ok=True)
    cpu = torch.device("cpu")
    model = load_gpt(args.gpt_pt, args.gpt_model, args.image_size,
                     args.downsample_size, torch.float32, cpu,
                     model_type=args.gpt_type)
    vq = load_vq(args.vq_pt, args.vq_model, args.codebook_size,
                 args.codebook_embed_dim, torch.float32, cpu, encoder=True)
    gpt_path = os.path.join(args.out, "gpt.pt")
    vq_path = os.path.join(args.out, "vq.pt")
    torch.save(model.state_dict(), gpt_path)
    torch.save(vq.state_dict(), vq_path)
    print(f"[1/4 convert] PASS  {args.gpt_pt} -> {gpt_path}, "
          f"{args.vq_pt} -> {vq_path}")

    if args.skip_oracle:
        print("[2/4 oracle ] SKIP  (--skip-oracle)")
    elif args.reference is None:
        print("[2/4 oracle ] SKIP  (no --reference)")
        print("NOTE: the oracle gate did not run: the conversion is "
              "not held against the reference.")
    else:
        try:
            print(f"[2/4 oracle ] PASS  {_oracle(args, model, vq)}")
        except ImportError as e:
            print(f"[2/4 oracle ] SKIP  ({e}; point --reference at the "
                  f"LlamaGen repo to gate the conversion)")
            print("NOTE: the oracle gate did not run: the conversion is "
                  "not held against the reference.")

    device = get_device(args.device)
    model = model.to(device, torch.bfloat16)
    vq = vq.to(device, torch.bfloat16)
    panel = [int(c) for c in args.classes.split(",")]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    seq = generate(model, torch.tensor(panel, device=device),
                   max_new_tokens=model.cfg.block_size, generator=gen,
                   cfg_scale=args.cfg_scale)
    latent = args.image_size // args.downsample_size
    imgs = vq.decode_code(seq.reshape(len(panel), latent, latent))
    png = os.path.join(args.out, "sample_grid.png")
    save_image_grid(imgs.float().cpu().numpy(), png, nrow=4)
    print(f"[3/4 sample ] PASS  {png}")
    # {sample_dir}/{model}-{size}-size-{eval}-cfg-{cfg}-seed-{seed}.npz
    sample_name = (f"{args.gpt_model}-{args.image_size}-size-256"
                   f"-cfg-{args.cfg_scale}-seed-0")
    print("[4/4 FID protocol] run:")
    print(f"  python -m llamagen_tpu_torch.cli.sample_c2i_fid \\\n"
          f"      --vq-ckpt {vq_path} --gpt-ckpt {gpt_path} "
          f"--gpt-model {args.gpt_model} \\\n"
          f"      --image-size {args.image_size} --image-size-eval 256 "
          f"--cfg-scale {args.cfg_scale} \\\n"
          f"      --num-samples 50000 --sample-dir {args.out} --npz")
    print(f"  python -m llamagen_tpu_torch.cli.evaluate "
          f"VIRTUAL_imagenet256_labeled.npz \\\n"
          f"      {args.out}/{sample_name}.npz")


def cmd_check_codes(args) -> None:
    vq = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                 args.codebook_embed_dim, torch.float32,
                 get_device(args.device))
    if args.codes.endswith(".npy"):
        codes = np.load(args.codes)
    else:
        with np.load(args.codes) as z:
            codes = z["codes"][:args.num]
    codes = codes.reshape(-1, codes.shape[-1])[:args.num]
    grid = int(codes.shape[-1] ** 0.5)
    idx = torch.as_tensor(codes.astype(np.int64),
                          device=vq.post_quant_conv.weight.device)
    imgs = vq.decode_code(idx.reshape(-1, grid, grid))
    save_image_grid(imgs.float().cpu().numpy(), args.out, nrow=4)
    print(f"decoded {codes.shape[0]} code grids -> {args.out}")


def class_names():
    """{"id": name} of the 1,000 ImageNet classes (the port's copy)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "imagenet_classes.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cmd_class_name(args) -> None:
    names = class_names()
    for cid in args.ids:
        print(f"{cid}: {names[str(cid)]}")


def cmd_export_hub(args) -> None:
    """A checkpoint (or seeded random weights) -> `utils/hub.py`'s
    directory layout, pushed with `--push`."""
    from llamagen_tpu_torch.utils import hub

    cpu = torch.device("cpu")
    if args.kind == "gpt":
        model = load_gpt(args.ckpt, args.model, args.image_size, 16,
                         torch.float32, cpu, model_type=args.model_type)
    else:
        model = load_vq(args.ckpt, args.model, 16384, 8, torch.float32, cpu,
                        encoder=True)
    d = hub.save_pretrained(args.out, model.state_dict(), model.cfg,
                            model_kind=args.kind)
    print(f"saved hub layout to {d}")
    if args.push:
        print(f"pushed to {hub.push_to_hub(d, args.push)}")


def _check_images(data_path, chunk):
    """Pool worker of `cmd_index_images` (module level, so it pickles):
    the paths whose images open and verify."""
    from PIL import Image

    good = []
    for rel in chunk:
        try:
            with Image.open(os.path.join(data_path, rel)) as im:
                im.verify()
            good.append(rel)
        except Exception:
            pass
    return good


def cmd_index_images(args) -> None:
    """The image paths of a tree (relative, sorted) whose files open, as
    JSON (upstream `tools/openimage_json.py`)."""
    import multiprocessing as mp

    exts = {".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff", ".webp"}
    paths = []
    for root, _, files in os.walk(args.data_path):
        rel_root = os.path.relpath(root, args.data_path)
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in exts:
                paths.append(f if rel_root == "." else
                             os.path.join(rel_root, f))
    paths.sort()
    workers = args.workers or max(mp.cpu_count() // 2, 4)
    if workers > 1 and len(paths) > 64:
        units = [(args.data_path, paths[i::workers]) for i in range(workers)]
        with mp.Pool(processes=workers) as pool:
            valid = sorted(p for sub in pool.starmap(_check_images, units)
                           for p in sub)
    else:
        valid = _check_images(args.data_path, paths)
    out = args.out or os.path.join(args.data_path, "image_paths.json")
    with open(out, "w") as fh:
        json.dump(valid, fh, indent=4)
    print(f"{len(valid)}/{len(paths)} valid image paths -> {out}")


def cmd_plot_metrics(args) -> None:
    """Loss and samples/s against the step, one line per experiment
    (metrics.jsonl as the trainers write it)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit("plot-metrics needs matplotlib")

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for exp_dir in args.exp_dirs:
        path = (exp_dir if exp_dir.endswith(".jsonl")
                else os.path.join(exp_dir, "metrics.jsonl"))
        steps, losses, sps = [], [], []
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                if "loss" in rec:
                    steps.append(rec["step"])
                    losses.append(rec["loss"])
                    sps.append(rec.get("samples_per_sec"))
        label = os.path.basename(os.path.normpath(exp_dir))
        axes[0].plot(steps, losses, label=label)
        if any(v is not None for v in sps):
            axes[1].plot(steps, sps, label=label)
    axes[0].set_xlabel("step"), axes[0].set_ylabel("loss")
    axes[1].set_xlabel("step"), axes[1].set_ylabel("samples/s")
    for ax in axes:
        ax.legend(framealpha=0.5)
    fig.tight_layout()
    fig.savefig(args.out, dpi=args.dpi)
    plt.close(fig)
    print(f"figure -> {args.out}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize-ckpt")
    q.add_argument("--in", dest="input", required=True)
    q.add_argument("--out", dest="output", required=True)
    q.add_argument("--mode", default="int8", choices=["int8", "w4", "w4-pc"])
    q.add_argument("--gpt-model", default="GPT-B")
    q.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    q.add_argument("--image-size", type=int, default=256)
    q.add_argument("--downsample-size", type=int, default=16)
    q.add_argument("--quantize-head", action="store_true")
    q.add_argument("--method", default="rtn", choices=["rtn", "gptq"],
                   help="w4 levels: round-to-nearest or calibrated GPTQ")
    q.add_argument("--awq", action="store_true",
                   help="AWQ equalisation first (w4 modes; either method)")
    q.add_argument("--group", type=int, default=128,
                   choices=[64, 128, 256, 512], help="w4 group-scale rows")
    q.add_argument("--calib-codes", default=None,
                   help="calibration ids: a .npy code dump [N, L]")
    q.add_argument("--calib-samples", type=int, default=128)
    q.add_argument("--calib-seed", type=int, default=0)
    q.add_argument("--device", default="cuda")
    q.set_defaults(fn=cmd_quantize_ckpt)

    c = sub.add_parser("convert-ckpt")
    c.add_argument("--kind", choices=["gpt", "vq"], required=True)
    c.add_argument("--in", dest="input", required=True)
    c.add_argument("--out", dest="output", required=True)
    c.add_argument("--gpt-model", default="GPT-B")
    c.add_argument("--vq-model", default="VQ-16")
    c.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    c.add_argument("--image-size", type=int, default=256)
    c.add_argument("--downsample-size", type=int, default=16)
    c.add_argument("--codebook-size", type=int, default=16384)
    c.add_argument("--codebook-embed-dim", type=int, default=8)
    c.set_defaults(fn=cmd_convert_ckpt)

    v = sub.add_parser("validate-release",
                       help="released weights: convert, the reference "
                            "gate, a sample grid, the FID protocol")
    v.add_argument("--gpt-pt", required=True)
    v.add_argument("--vq-pt", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--gpt-model", default="GPT-B")
    v.add_argument("--vq-model", default="VQ-16")
    v.add_argument("--gpt-type", default="c2i", choices=["c2i"])
    v.add_argument("--image-size", type=int, default=384)
    v.add_argument("--downsample-size", type=int, default=16)
    v.add_argument("--codebook-size", type=int, default=16384)
    v.add_argument("--codebook-embed-dim", type=int, default=8)
    v.add_argument("--cfg-scale", type=float, default=2.0)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--classes", default="207,360,387,974,88,979,417,279")
    v.add_argument("--reference", default=None,
                   help="upstream LlamaGen checkout for the oracle gate; "
                        "the gate SKIPs without it")
    v.add_argument("--skip-oracle", action="store_true")
    v.add_argument("--oracle-tokens", type=int, default=16)
    v.add_argument("--oracle-atol", type=float, default=5e-3)
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_validate_release)

    k = sub.add_parser("check-codes")
    k.add_argument("--codes", required=True, help=".npy or packed .npz")
    k.add_argument("--vq-ckpt", default=None)
    k.add_argument("--vq-model", default="VQ-16")
    k.add_argument("--codebook-size", type=int, default=16384)
    k.add_argument("--codebook-embed-dim", type=int, default=8)
    k.add_argument("--num", type=int, default=16)
    k.add_argument("--out", default="check_codes.png")
    k.add_argument("--device", default="cuda")
    k.set_defaults(fn=cmd_check_codes)

    h = sub.add_parser("export-hub")
    h.add_argument("--kind", choices=["gpt", "vq"], required=True)
    h.add_argument("--model", required=True)
    h.add_argument("--ckpt", default=None)
    h.add_argument("--image-size", type=int, default=256)
    h.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    h.add_argument("--out", required=True)
    h.add_argument("--push", default=None,
                   help="hub repo id (credentials and network access)")
    h.set_defaults(fn=cmd_export_hub)

    n = sub.add_parser("class-name")
    n.add_argument("ids", type=int, nargs="+")
    n.set_defaults(fn=cmd_class_name)

    for alias in ("index-images", "openimage-json"):
        ii = sub.add_parser(alias)
        ii.add_argument("--data-path", required=True)
        ii.add_argument("--out", default=None,
                        help="default: <data-path>/image_paths.json")
        ii.add_argument("--workers", type=int, default=0)
        ii.set_defaults(fn=cmd_index_images)

    pm = sub.add_parser("plot-metrics")
    pm.add_argument("exp_dirs", nargs="+",
                    help="experiment directories or metrics.jsonl paths")
    pm.add_argument("--out", default="metrics.png")
    pm.add_argument("--dpi", type=int, default=200)
    pm.set_defaults(fn=cmd_plot_metrics)

    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
