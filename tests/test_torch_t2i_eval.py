"""The port's t2i evaluation CLIs (`cli/sample_t2i_fid.py`,
`cli/evaluate_t2i.py`) against the JAX package's on the CPU.

`--random-t5`'s caption embeddings (the crc32-seeded stub, left-padded,
cast to bf16) equal JAX's bit for bit: both CLIs run with `generate`
replaced by a recorder. The port's sampler then runs for real (GPT-nano
t2i, 64 px) and writes PNGs and `result.jsonl`; `evaluate_t2i` on them
prints the FID line of JAX's CLI within 1e-3 relative (the same random
pytorch-fid `.pth`; they differ only through the features).
"""

import json
import os
import re

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from llamagen_tpu.cli import evaluate_t2i as jevaluate_t2i
from llamagen_tpu.cli import sample_t2i_fid as jsample
from llamagen_tpu_torch.cli import evaluate_t2i, sample_t2i_fid
from test_torch_eval import random_inception
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

# three prompts in batches of two: the second batch is padded with ""
PROMPTS = ["a red bus", "two dogs on a sofa next to a lamp, oil painting",
           "an owl"]
CLI = ["--gpt-model", "GPT-nano", "--image-size", "64",
       "--per-proc-batch-size", "2", "--random-t5"]


@pytest.fixture(scope="module")
def prompt_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prompts") / "prompts.jsonl")
    with open(path, "w") as f:
        for p in PROMPTS:
            f.write(json.dumps({"caption": p}) + "\n")
    return path


def test_random_t5_embeddings_equal_jax(prompt_file, tmp_path, monkeypatch):
    seen = {"jax": [], "port": []}

    def jrecord(params, key, cond, *, cfg, max_new_tokens, emb_masks, **kw):
        seen["jax"].append((np.asarray(cond.astype(jnp.float32)),
                            np.asarray(emb_masks)))
        return jnp.zeros((cond.shape[0], max_new_tokens), jnp.int32)

    def record(model, cond, *, max_new_tokens, emb_masks, **kw):
        seen["port"].append((cond.float().numpy(), emb_masks.numpy()))
        return torch.zeros(cond.shape[0], max_new_tokens, dtype=torch.long)

    monkeypatch.setattr(jsample, "generate", jrecord)
    monkeypatch.setattr(sample_t2i_fid, "generate", record)
    argv = CLI[:4] + ["--image-size", "32", "--per-proc-batch-size", "2",
                      "--random-t5", "--prompt-file", prompt_file]
    jsample.main(argv + ["--sample-dir", str(tmp_path / "jax")])
    sample_t2i_fid.main(argv + ["--sample-dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for (je, jm), (pe, pm) in zip(seen["jax"], seen["port"]):
        assert pe.shape == je.shape == (2, 120, 2048)
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pm, jm)
    # left-padded: the valid rows end each caption
    assert seen["port"][0][1][:, -1].all() and not seen["port"][0][1][:, 0].any()
    stub = sample_t2i_fid.RandomT5(120, 2048)
    emb, mask = stub.get_text_embeddings(PROMPTS)
    assert emb.dtype == np.float32
    assert mask.sum(1).tolist() == [len(p.split()) + 2 for p in PROMPTS]


@pytest.fixture(scope="module")
def samples(prompt_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("samples"))
    res = sample_t2i_fid.main(CLI + ["--prompt-file", prompt_file,
                                     "--sample-dir", out, "--device", "cpu"])
    return out, res


def test_sampler_writes_pngs_and_result_jsonl(samples):
    from PIL import Image

    out, res = samples
    with open(os.path.join(out, "result.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows == res.results
    assert [r["id"] for r in rows] == [0, 1, 2]
    assert [r["prompt"] for r in rows] == PROMPTS
    for r in rows:
        img = np.array(Image.open(r["image"]))
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    images, prompts = evaluate_t2i.load_result_jsonl(
        os.path.join(out, "result.jsonl"))
    jimages, jprompts = jevaluate_t2i.load_result_jsonl(
        os.path.join(out, "result.jsonl"))
    np.testing.assert_array_equal(images, jimages)
    assert prompts == jprompts == PROMPTS
    assert images.std() > 0


def _lines(path):
    with open(path) as f:
        return {m.group(1): float(m.group(2))
                for m in re.finditer(r"^(.+): ([-\d.e+]+)$", f.read(), re.M)}


def test_evaluate_t2i_fid_matches_jax(samples, tmp_path):
    out, _ = samples
    _, sd = random_inception(seed=1)
    weights = str(tmp_path / "pt_inception.pth")
    torch.save(sd, weights)
    ref = np.random.RandomState(0).randint(0, 256, (6, 64, 64, 3), np.uint8)
    ref_path = str(tmp_path / "ref.npz")
    np.savez(ref_path, arr_0=ref)
    result = os.path.join(out, "result.jsonl")
    txt = os.path.join(out, "result_eval.txt")
    argv = ["--result", result, "--ref-batch", ref_path,
            "--inception-weights", weights, "--batch-size", "4"]
    jevaluate_t2i.main(argv)
    want = _lines(txt)
    os.remove(txt)
    got = evaluate_t2i.main(argv + ["--device", "cpu"])
    assert list(_lines(txt)) == list(want) == ["FID"]
    assert abs(_lines(txt)["FID"] - want["FID"]) <= 1e-3 * abs(want["FID"])
    assert abs(got["FID"] - want["FID"]) <= 1e-3 * abs(want["FID"])


def test_clis_refuse_a_missing_card(prompt_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_t2i_fid.main(["--prompt-file", prompt_file, "--random-t5",
                             "--sample-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_t2i.main(["--result", str(tmp_path / "r.jsonl")])
