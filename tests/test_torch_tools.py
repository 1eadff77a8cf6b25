"""The port's tools CLI (llamagen_tpu_torch.cli.tools) and hub layout
(llamagen_tpu_torch.utils.hub) on the CPU, on tiny files: quantize-ckpt
with GPTQ and AWQ (their W4 keys load through `load_gpt` and sample; a
t2i model calibrates on caption features),
convert-ckpt on the four upstream dict layouts (the state dict comes back
exactly), check-codes, class-name (the JSON table equals the JAX
package's), index-images (and its alias), plot-metrics (skipped without
matplotlib), export-hub -> load_pretrained (exact round trip of the state
dict and the config, an int8 checkpoint too), validate-release
--skip-oracle (a sample grid, the oracle and FID steps reported as
SKIP)."""

import json
import os

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.cli import tools
from llamagen_tpu_torch.cli.common import load_gpt
from llamagen_tpu_torch.models import gpt
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.utils import hub
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NANO = ["--gpt-model", "GPT-nano", "--image-size", "64"]  # 16 tokens
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nano_ckpt(tmp_path_factory):
    """A GPT-nano 64 px c2i checkpoint (seeded weights, a random head)."""
    model = load_gpt(None, "GPT-nano", 64, 16, torch.float32, CPU)
    with torch.no_grad():
        model.output.weight.normal_(0.0, 0.02, generator=torch.Generator()
                                    .manual_seed(1))
    path = str(tmp_path_factory.mktemp("ckpt") / "nano.pt")
    torch.save(model.state_dict(), path)
    return path, model


@pytest.mark.parametrize("method,awq", [("gptq", False), ("rtn", True),
                                        ("gptq", True)],
                         ids=["gptq", "awq-rtn", "awq-gptq"])
def test_quantize_ckpt_gptq_and_awq(nano_ckpt, tmp_path, method, awq):
    path, _ = nano_ckpt
    out = str(tmp_path / "w4.pt")
    tools.main(["quantize-ckpt", "--in", path, "--out", out, "--mode", "w4",
                "--method", method, "--group", "64", "--calib-samples", "4",
                "--device", "cpu", "--quantize-head", *NANO]
               + (["--awq"] if awq else []))
    sd = torch.load(out)
    assert sd["layers.0.attention.wqkv.weight_w4b"].dtype == torch.int8
    assert "layers.0.attention.wqkv.weight" not in sd
    assert sd["output.weight_q"].dtype == torch.int8
    model = load_gpt(out, "GPT-nano", 64, 16, torch.float32, CPU)
    tok = generate(model, torch.tensor([1, 2]), max_new_tokens=16,
                   cfg_scale=2.0, sample_logits=False,
                   compute_dtype=torch.float32, cache_dtype=torch.float32)
    assert tok.shape == (2, 16)


def test_quantize_ckpt_t2i_calibrates_on_captions(tmp_path):
    """A t2i model calibrates on random caption features (JAX's CLI hands
    it class labels and fails: ROADMAP.md, Queue 3, F9)."""
    model = load_gpt(None, "GPT-nano", 64, 16, torch.float32, CPU,
                     model_type="t2i")
    src, out = str(tmp_path / "t2i.pt"), str(tmp_path / "t2i_w4.pt")
    torch.save(model.state_dict(), src)
    tools.main(["quantize-ckpt", "--in", src, "--out", out, "--mode", "w4",
                "--method", "gptq", "--awq", "--group", "64",
                "--calib-samples", "2", "--model-type", "t2i",
                "--device", "cpu", *NANO])
    w4 = load_gpt(out, "GPT-nano", 64, 16, torch.float32, CPU,
                  model_type="t2i")
    assert w4.layers[1].feed_forward.w2.weight_w4b.dtype == torch.int8


@pytest.mark.parametrize("layout", ["plain", "model", "module",
                                    "state_dict"])
def test_convert_ckpt_dict_layouts(nano_ckpt, tmp_path, layout):
    """A plain state dict, {"model"}, {"module"} (with `module.` key
    prefixes, as a DDP checkpoint has) and {"state_dict"} -> the port's
    plain f32 state dict."""
    _, model = nano_ckpt
    sd = model.state_dict()
    wrapped = {"plain": sd, "model": {"model": sd, "steps": 3},
               "module": {"module": {f"module.{k}": v for k, v in sd.items()}},
               "state_dict": {"state_dict": sd}}[layout]
    src, out = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save(wrapped, src)
    tools.main(["convert-ckpt", "--kind", "gpt", "--in", src, "--out", out,
                *NANO])
    got = torch.load(out)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_check_codes_and_class_name(tmp_path, capsys):
    codes = str(tmp_path / "codes.npy")
    np.save(codes, np.random.RandomState(0).randint(0, 64, (3, 16)))
    out = str(tmp_path / "grid.png")
    tools.main(["check-codes", "--codes", codes, "--vq-model", "VQ-8",
                "--codebook-size", "64", "--codebook-embed-dim", "4",
                "--num", "2", "--out", out, "--device", "cpu"])
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    tools.main(["class-name", "207", "0"])
    text = capsys.readouterr().out
    assert "207: golden retriever" in text and "0: tench" in text
    with open(os.path.join(ROOT, "llamagen_tpu", "data",
                           "imagenet_classes.json"), encoding="utf-8") as f:
        assert tools.class_names() == json.load(f)


@pytest.mark.parametrize("alias", ["index-images", "openimage-json"])
def test_index_images(tmp_path, alias):
    from PIL import Image
    (tmp_path / "sub").mkdir()
    Image.new("RGB", (4, 4)).save(tmp_path / "a.png")
    Image.new("RGB", (4, 4)).save(tmp_path / "sub" / "b.jpg")
    (tmp_path / "broken.png").write_bytes(b"not an image")
    (tmp_path / "notes.txt").write_text("skipped: not an image suffix")
    tools.main([alias, "--data-path", str(tmp_path), "--workers", "1"])
    with open(tmp_path / "image_paths.json") as f:
        assert json.load(f) == ["a.png", os.path.join("sub", "b.jpg")]


def test_plot_metrics(tmp_path):
    pytest.importorskip("matplotlib")
    exp = tmp_path / "exp"
    exp.mkdir()
    with open(exp / "metrics.jsonl", "w") as f:
        for step in range(1, 4):
            f.write(json.dumps({"step": step, "loss": 9.0 / step,
                                "samples_per_sec": 10.0 * step}) + "\n")
            f.write(json.dumps({"step": step, "lr": 1e-4}) + "\n")
    out = str(tmp_path / "m.png")
    tools.main(["plot-metrics", str(exp), "--out", out, "--dpi", "40"])
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_export_hub_and_load_pretrained_round_trip(nano_ckpt, tmp_path,
                                                   quantized):
    path, model = nano_ckpt
    if quantized:
        q = str(tmp_path / "int8.pt")
        tools.main(["quantize-ckpt", "--in", path, "--out", q,
                    "--mode", "int8", "--quantize-head", "--device", "cpu",
                    *NANO])
        path = q
    out = str(tmp_path / "hub")
    tools.main(["export-hub", "--kind", "gpt", "--model", "GPT-nano",
                "--ckpt", path, "--image-size", "64", "--out", out])
    with open(os.path.join(out, hub.CONFIG_NAME)) as f:
        raw = json.load(f)
    assert raw["model_kind"] == "gpt" and raw["dim"] == 128
    sd, cfg = hub.load_pretrained(out)
    assert cfg == model.cfg
    ref = load_gpt(path, "GPT-nano", 64, 16, torch.float32, CPU).state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    bf16, _ = hub.load_pretrained(out, dtype=torch.bfloat16)
    assert bf16["norm.weight"].dtype == torch.bfloat16
    if quantized:
        assert bf16["output.weight_q"].dtype == torch.int8
    else:
        m = gpt.Transformer(cfg)
        m.load_state_dict(sd)


@pytest.mark.parametrize("oracle", ["--skip-oracle", "no-reference"])
def test_validate_release_skip_oracle(nano_ckpt, tmp_path, capsys, oracle):
    """Convert, sample and the FID protocol's commands; the oracle SKIPs on
    --skip-oracle and without --reference, and then puts nothing on
    sys.path."""
    import sys
    from llamagen_tpu_torch.cli.common import load_vq
    vq_pt = str(tmp_path / "vq.pt")
    vq = load_vq(None, "VQ-8", 16384, 8, torch.float32, CPU, encoder=True)
    torch.save({"model": vq.state_dict()}, vq_pt)
    out = str(tmp_path / "release")
    path_before = list(sys.path)
    tools.main(["validate-release", "--gpt-pt", nano_ckpt[0], "--vq-pt",
                vq_pt, "--out", out, "--gpt-model", "GPT-nano",
                "--image-size", "32", "--vq-model", "VQ-8",
                "--downsample-size", "8", "--classes", "1,2", "--device",
                "cpu"] + ([oracle] if oracle == "--skip-oracle" else []))
    text = capsys.readouterr().out
    assert "[1/4 convert] PASS" in text and "[3/4 sample ] PASS" in text
    assert "[4/4 FID protocol] run:" in text
    assert "python -m llamagen_tpu_torch.cli.sample_c2i_fid" in text
    assert f"--gpt-ckpt {os.path.join(out, 'gpt.pt')}" in text
    assert f"{out}/GPT-nano-32-size-256-cfg-2.0-seed-0.npz" in text
    assert ("[2/4 oracle ] SKIP  (--skip-oracle)" if oracle == "--skip-oracle"
            else "[2/4 oracle ] SKIP  (no --reference)") in text
    assert sys.path == path_before
    assert open(os.path.join(out, "sample_grid.png"), "rb").read(4) \
        == b"\x89PNG"
    assert torch.load(os.path.join(out, "gpt.pt")).keys() \
        == nano_ckpt[1].state_dict().keys()
