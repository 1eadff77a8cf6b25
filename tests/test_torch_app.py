"""The port's HTTP front end (llamagen_tpu_torch.cli.app) on the CPU: the
stdlib server on an ephemeral port in a thread, over a GPT-nano engine
and a narrow VQ decoder; `/generate` answers PNG bytes of the image size,
`/stats` the engine's gauges."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from llamagen_tpu_torch.cli import app
from llamagen_tpu_torch.config import VQConfig, gpt_config
from llamagen_tpu_torch.models import gpt, vq
from llamagen_tpu_torch.serve.engine import SamplingParams
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)


def _backend():
    """GPT-nano over an 8 x 8 grid (128 px) with a random head, and a VQ
    decoder of the VQ-16 depth at 32 channels."""
    model = gpt.init_weights(gpt.Transformer(
        gpt_config("GPT-nano", block_size=64, cls_token_num=1)), seed=0)
    with torch.no_grad():
        model.output.weight.normal_(0, 0.5, generator=torch.Generator()
                                    .manual_seed(1))
    vq_model = vq.init_weights(vq.VQModel(VQConfig(ch=32, z_channels=32,
                                                   num_res_blocks=1)))
    return app.DemoBackend(app.quantize(model.eval(), "int8"), vq_model,
                           SamplingParams(cfg_scale=4.0, top_k=4000),
                           num_slots=2, chunk=16,
                           compute_dtype=torch.float32)


def test_http_generate_and_stats():
    backend = _backend()
    server = app.make_server(backend, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(
                f"{url}/generate?class_id=3&cfg_scale=2.0&temperature=0"
                f"&top_k=10&top_p=0.9", timeout=120) as r:
            assert r.headers["Content-Type"] == "image/png"
            png = r.read()
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            st = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nothing", timeout=30)
    finally:
        server.shutdown()
        server.server_close()
    img = Image.open(io.BytesIO(png))
    assert img.size == (128, 128) and img.mode == "RGB"
    assert st["completed"] == 1 and st["running"] == 0 and st["slots"] == 2
    # greedy at temperature 0: the same request gives the same image
    again = Image.open(io.BytesIO(backend.generate_png(
        3, cfg_scale=2.0, temperature=0.0, top_k=10, top_p=0.9)))
    np.testing.assert_array_equal(np.asarray(img), np.asarray(again))


def test_main_flags(monkeypatch):
    """`main` builds the backend from the JAX app's flags plus --device
    (the W8A16 model on the engine, four slots) and serves it; a CUDA
    device that is not there raises (no CPU fallback)."""
    served = {}
    monkeypatch.setattr(app, "serve_http",
                        lambda backend, port: served.update(b=backend, p=port))
    app.main(["--gpt-model", "GPT-nano", "--device", "cpu", "--quantize",
              "int8", "--port", "0", "--no-gradio"])
    backend = served["b"]
    assert served["p"] == 0 and backend.engine.num_pairs == 4
    assert backend.engine.max_new_tokens == 256 and backend.latent == 16
    assert backend.gpt.layers[0].attention.wqkv.weight_q is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main(["--gpt-model", "GPT-nano", "--device", "cuda"])
