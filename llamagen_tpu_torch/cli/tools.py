"""Utility tools CLI (PyTorch port).

Counterpart of `llamagen_tpu/cli/tools.py`; one subcommand is ported:

  quantize-ckpt   pre-quantise a GPT checkpoint for serving: W8A16
                  (`--mode int8`) or the W4A16 kernel layout (`w4`: group
                  scales, `w4-pc`: per-channel scales). The output is a
                  `torch.save` state dict whose `weight_q` / `weight_w4b`
                  keys `cli/common.py::load_gpt` recognises, so
                  `sample_c2i --gpt-ckpt` / `--draft-gpt-ckpt` load it.

  python -m llamagen_tpu_torch.cli.tools quantize-ckpt --in c2i_L_384.pt \\
      --out c2i_L_384_w4.pt --mode w4 --gpt-model GPT-L --image-size 384
"""

from __future__ import annotations

import argparse

import torch

from llamagen_tpu_torch.cli.common import get_device, load_gpt
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k


def cmd_quantize_ckpt(args) -> None:
    """Round-to-nearest quantisation of the layer matmuls (and, with
    --quantize-head, an int8 head) of a bf16 model."""
    if args.method != "rtn" or args.awq:
        raise NotImplementedError(
            "GPTQ and AWQ are not ported yet (ROADMAP.md, Queue 1, slice 7: "
            "quantization beyond W8A16)")
    device = get_device(args.device)
    model = load_gpt(args.input, args.gpt_model, args.image_size,
                     args.downsample_size, torch.bfloat16, device)
    if args.mode == "int8":
        quantize_gpt_params(model, quantize_head=args.quantize_head)
    else:
        quantize_gpt_params_w4k(model, per_channel=args.mode == "w4-pc",
                                int8_head=args.quantize_head,
                                group_size=args.group)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               args.output)
    print(f"quantized ({args.mode}) {args.input} -> {args.output}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser("quantize-ckpt")
    q.add_argument("--in", dest="input", required=True)
    q.add_argument("--out", dest="output", required=True)
    q.add_argument("--mode", default="int8", choices=["int8", "w4", "w4-pc"])
    q.add_argument("--gpt-model", default="GPT-B")
    q.add_argument("--image-size", type=int, default=256)
    q.add_argument("--downsample-size", type=int, default=16)
    q.add_argument("--quantize-head", action="store_true")
    q.add_argument("--method", default="rtn", choices=["rtn", "gptq"],
                   help="w4 level chooser: rtn (gptq is not ported yet)")
    q.add_argument("--awq", action="store_true",
                   help="AWQ equalisation pre-pass (not ported yet)")
    q.add_argument("--group", type=int, default=128,
                   choices=[64, 128, 256, 512], help="w4 group-scale rows")
    q.add_argument("--device", default="cuda")
    q.set_defaults(fn=cmd_quantize_ckpt)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
