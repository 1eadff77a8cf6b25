"""The port's CLIs end to end on the CPU: sampling (GPT-nano, 2 images),
speculative sampling, and `tools quantize-ckpt` round trips."""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.cli import sample_c2i, tools
from llamagen_tpu_torch.cli.common import load_gpt
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.quant_matmul import quantize_gpt_params
from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)


def test_sample_c2i_writes_png(tmp_path):
    from PIL import Image

    out = tmp_path / "grid.png"
    res = sample_c2i.main(["--gpt-model", "GPT-nano", "--device", "cpu",
                           "--classes", "1", "2", "--precision", "f32",
                           "--cfg-scale", "2.0", "--out", str(out)])
    assert res.tokens.shape == (2, 256)
    assert res.tokens.min() >= 0 and res.tokens.max() < 16384
    assert res.images.shape == (2, 256, 256, 3)
    assert np.isfinite(res.images).all()
    with Image.open(out) as img:  # 2 images in a 4-wide grid, 2 px padding
        assert img.size == (4 * 258 - 2, 256) and img.mode == "RGB"
        grid = np.asarray(img)
    expect = np.clip((res.images[0] + 1) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[:, :256], expect)


def test_sample_c2i_refuses_what_is_not_ported(tmp_path):
    """cfg_interval under speculative decoding (JAX refuses it too), GPTQ
    and AWQ, and a CUDA device that is not there (no silent CPU
    fallback)."""
    with pytest.raises(ValueError, match="cfg-interval"):
        sample_c2i.main(["--gpt-model", "GPT-nano", "--draft-gpt-model",
                         "GPT-nano", "--cfg-interval", "5", "--device", "cpu",
                         "--out", str(tmp_path / "x.png")])
    for extra in (["--method", "gptq"], ["--awq"]):
        with pytest.raises(NotImplementedError, match="slice 7"):
            tools.main(["quantize-ckpt", "--in", "none.pt", "--out",
                        "none_q.pt", "--mode", "w4", "--device", "cpu"]
                       + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sample_c2i.main(["--gpt-model", "GPT-nano", "--device", "cuda",
                             "--out", str(tmp_path / "x.png")])


def _random_ckpt(path):
    """A GPT-nano (256 px) state dict with random weights and head."""
    model = load_gpt(None, "GPT-nano", 256, 16, torch.float32, "cpu")
    with torch.no_grad():
        model.output.weight.normal_(0, 0.5, generator=torch.Generator()
                                    .manual_seed(1))
    torch.save(model.state_dict(), path)


def _logits(model):
    """Prefill and two decode steps on fixed tokens, f32 logits."""
    labels = torch.tensor([3, 7])
    cache = gpt.init_cache(model.cfg, 2, 16, torch.bfloat16, "cpu")
    out = [gpt.prefill(model, labels, cache)]
    for i, tok in enumerate(([5, 9], [100, 2])):
        out.append(gpt.decode_step(model, torch.tensor(tok), 1 + i, cache))
    return torch.stack(out)


@pytest.mark.parametrize("mode", ["int8", "w4", "w4-pc"])
def test_quantize_ckpt_round_trip(tmp_path, mode):
    """quantize-ckpt output -> load_gpt gives the model that quantising in
    memory gives: equal logits, int8 storage kept."""
    src, dst = tmp_path / "gpt.pt", tmp_path / f"gpt_{mode}.pt"
    _random_ckpt(src)
    tools.main(["quantize-ckpt", "--in", str(src), "--out", str(dst),
                "--mode", mode, "--gpt-model", "GPT-nano", "--device", "cpu"])
    loaded = load_gpt(str(dst), "GPT-nano", 256, 16, torch.bfloat16, "cpu")
    ref = load_gpt(str(src), "GPT-nano", 256, 16, torch.bfloat16, "cpu")
    if mode == "int8":
        quantize_gpt_params(ref)
    else:
        quantize_gpt_params_w4k(ref, per_channel=mode == "w4-pc")
    sd, ref_sd = loaded.state_dict(), ref.state_dict()
    assert sd.keys() == ref_sd.keys()
    key = "layers.0.attention.wqkv." + (
        "weight_q" if mode == "int8" else "weight_w4b")
    assert sd[key].dtype == torch.int8 and torch.equal(sd[key], ref_sd[key])
    assert torch.equal(_logits(loaded), _logits(ref))


def test_sample_c2i_speculative_on_cpu(tmp_path):
    """--draft-gpt-model with a W4 copy of the target from quantize-ckpt:
    the speculative path through the CLI, on the plain versions of the
    kernels."""
    src, draft = tmp_path / "gpt.pt", tmp_path / "gpt_w4.pt"
    _random_ckpt(src)
    tools.main(["quantize-ckpt", "--in", str(src), "--out", str(draft),
                "--mode", "w4", "--gpt-model", "GPT-nano", "--device", "cpu"])
    res = sample_c2i.main([
        "--gpt-model", "GPT-nano", "--gpt-ckpt", str(src),
        "--draft-gpt-model", "GPT-nano", "--draft-gpt-ckpt", str(draft),
        "--spec-k", "3", "--device", "cpu", "--classes", "1", "2",
        "--precision", "f32", "--cfg-scale", "2.0",
        "--out", str(tmp_path / "spec.png")])
    assert res.tokens.shape == (2, 256) and res.images.shape[0] == 2
    assert res.tokens.min() >= 0 and res.tokens.max() < 16384
    assert np.isfinite(res.images).all()
    # at least one token per round, at most k + 1
    assert -(-255 // 4) <= res.rounds <= 255
