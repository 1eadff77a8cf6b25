"""Interactive c2i demo server (PyTorch port).

Counterpart of `llamagen_tpu/cli/app.py`, with the same flags plus
`--device` (default `cuda`) and `--no-gradio`: class-conditional
generation over HTTP, backed by the continuous-batching `ServeEngine`.
cfg_scale, temperature, top-k and top-p are per-request data in the
engine's slots. As in JAX, one lock around submit + run_until_idle
serialises the HTTP requests: each runs alone in the engine. The VQ
decoder runs on the engine's device. Uses Gradio when it is installed
(unless `--no-gradio`), otherwise a dependency-free stdlib HTTP server:

  GET /generate?class_id=&cfg_scale=&temperature=&top_k=&top_p=  -> PNG
  GET /stats                                                     -> JSON

  python -m llamagen_tpu_torch.cli.app --gpt-ckpt c2i_B_256.pt \
      --vq-ckpt vq_ds16_c2i.pt --quantize int8
  curl "localhost:7860/generate?class_id=207&cfg_scale=3.5" -o dog.png
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from llamagen_tpu_torch.cli.common import _png, get_device, load_gpt, load_vq
from llamagen_tpu_torch.models import gpt as gpt_lib
from llamagen_tpu_torch.models import vq as vq_lib
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine


def quantize(model: gpt_lib.Transformer, mode: str) -> gpt_lib.Transformer:
    """`--quantize`: none, int8 (W8A16), w4 (grouped W4A16) or w4-pc."""
    if mode == "int8":
        from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
        return quantize_gpt_params(model)
    if mode in ("w4", "w4-pc"):
        from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
        return quantize_gpt_params_w4k(model, per_channel=mode == "w4-pc")
    return model


class DemoBackend:
    """The engine, the VQ decoder and their lock. `from_args` loads both
    from the CLI's flags; the constructor takes built models."""

    def __init__(self, gpt_model: gpt_lib.Transformer, vq_model: vq_lib.VQModel,
                 sampling_params: SamplingParams, num_slots: int = 4,
                 chunk: int = 64, compute_dtype: torch.dtype = torch.bfloat16):
        self.latent = gpt_model.cfg.grid_size
        self.gpt, self.vq = gpt_model, vq_model
        self.engine = ServeEngine(
            gpt_model, num_pairs=num_slots,
            max_new_tokens=self.latent * self.latent,
            sampling_params=sampling_params, chunk=chunk,
            compute_dtype=compute_dtype)
        self._default_sp = self.engine.sp
        self._lock = threading.Lock()

    @classmethod
    def from_args(cls, args) -> "DemoBackend":
        device = get_device(args.device)
        dtype = torch.bfloat16
        gpt = load_gpt(args.gpt_ckpt, args.gpt_model, args.image_size,
                       args.downsample_size, dtype, device)
        vq = load_vq(args.vq_ckpt, args.vq_model, args.codebook_size,
                     args.codebook_embed_dim, dtype, device)
        sp = SamplingParams(cfg_scale=args.cfg_scale, top_k=args.top_k,
                            top_p=args.top_p, temperature=args.temperature)
        return cls(quantize(gpt, args.quantize), vq, sp,
                   num_slots=args.num_slots, chunk=args.chunk,
                   compute_dtype=dtype)

    def generate_png(self, class_id: int, cfg_scale=None, temperature=None,
                     top_k=None, top_p=None) -> bytes:
        d = self._default_sp
        sp = SamplingParams(
            cfg_scale=d.cfg_scale if cfg_scale is None else float(cfg_scale),
            temperature=(d.temperature if temperature is None
                         else float(temperature)),
            top_k=d.top_k if top_k is None else int(top_k),
            top_p=d.top_p if top_p is None else float(top_p))
        with self._lock:  # one thread at a time runs the engine loop
            req = self.engine.submit(class_id, sp=sp)
            self.engine.run_until_idle()
        idx = torch.from_numpy(req.result).to(self.engine.device)
        img = self.vq.decode_code(idx.reshape(1, self.latent, self.latent))
        arr = img[0].float().cpu().numpy()
        return _png(np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8))


def make_server(backend: DemoBackend, port: int,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The stdlib HTTP server of the two endpoints (port 0: any free
    port, `server.server_address[1]`)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/generate":
                q = urllib.parse.parse_qs(url.query)
                class_id = int(q.get("class_id", ["207"])[0])
                opt = {k: q[k][0] for k in
                       ("cfg_scale", "temperature", "top_k", "top_p")
                       if k in q}
                self._send("image/png", backend.generate_png(class_id, **opt))
            elif url.path == "/stats":
                self._send("application/json",
                           json.dumps(backend.engine.stats()).encode())
            else:
                self.send_response(404)
                self.end_headers()

        def _send(self, content_type: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(backend: DemoBackend, port: int) -> None:
    server = make_server(backend, port)
    print(f"serving on http://0.0.0.0:{server.server_address[1]}  "
          f"(GET /generate?class_id=N, GET /stats)", flush=True)
    server.serve_forever()


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gpt-model", default="GPT-B")
    p.add_argument("--gpt-ckpt", default=None)
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-embed-dim", type=int, default=8)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--downsample-size", type=int, default=16)
    p.add_argument("--cfg-scale", type=float, default=4.0)
    p.add_argument("--top-k", type=int, default=4000)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--quantize", default="none",
                   choices=["none", "int8", "w4", "w4-pc"],
                   help="weight quantization: int8 = W8A16 (the int8 "
                        "kernel), w4/w4-pc = W4A16 (the W4 kernel)")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-gradio", action="store_true",
                   help="serve the stdlib HTTP endpoints (GET /generate, "
                        "GET /stats) even where gradio is installed: "
                        "chip_smoke.py drives them by HTTP")
    args = p.parse_args(argv)

    backend = DemoBackend.from_args(args)
    try:
        if args.no_gradio:
            raise ImportError
        import gradio as gr
    except ImportError:
        serve_http(backend, args.port)
        return

    def infer(class_id, cfg_scale):
        from PIL import Image
        png = backend.generate_png(int(class_id), cfg_scale=cfg_scale)
        return Image.open(io.BytesIO(png))

    gr.Interface(
        fn=infer,
        inputs=[gr.Number(label="ImageNet class id"),
                gr.Slider(1.0, 10.0, value=4.0, label="cfg scale")],
        outputs=gr.Image(),
        title="LlamaGen c2i demo").launch(server_port=args.port)


if __name__ == "__main__":
    main()
