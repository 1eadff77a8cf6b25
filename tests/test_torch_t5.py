"""The port's T5 text encoder (llamagen_tpu_torch.text.t5) against what the
JAX package's `text/t5.py` runs, HF's `FlaxT5EncoderModel`, on the CPU:
the relative-position buckets exactly; the encoder on weights carried by
`t5_state_dict_from_flax`, right-padded masks of 1, 7 and 120 tokens,
within 1e-4 in f32 and within 2^-4 of the largest |output| in bf16 (bf16
rounds every matmul input and the residual stream; the two frameworks
round at other points); the two `T5TextEncoder`s end to end on one local
directory, within 5e-4 at d_model 2048 (Flax and torch weights of one
random flan-t5-like model and a tiny `tokenizers` Unigram tokenizer,
nothing downloaded); the `extract_t5_features` CLI."""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from transformers import FlaxT5EncoderModel, PreTrainedTokenizerFast, T5Config
from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

from llamagen_tpu.text.t5 import T5TextEncoder as JT5TextEncoder
from llamagen_tpu.text.t5 import left_pad_embeddings as jleft_pad
from llamagen_tpu_torch.cli import extract_t5_features
from llamagen_tpu_torch.text import t5
from llamagen_tpu_torch.utils.convert import t5_state_dict_from_flax
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(vocab_size=100, d_model=64, d_kv=16, d_ff=128, num_layers=2,
             num_heads=4, feed_forward_proj="gated-gelu",
             relative_attention_num_buckets=32,
             relative_attention_max_distance=128, dropout_rate=0.0)
T = 120
CAPTIONS = ["A blue Porsche 356 parked in front of a yellow brick wall.",
            "dog",
            "a photo of an astronaut riding a horse in the forest " * 12]


def _flax(seed=0, dtype=jnp.float32, **kw):
    return FlaxT5EncoderModel(T5Config(**dict(SMALL, **kw)), seed=seed,
                              dtype=dtype)


def _port(flax_model, dtype=torch.float32):
    cfg = t5.T5EncoderConfig.from_dict(flax_model.config.to_dict())
    enc = t5.T5Encoder(cfg, dtype=dtype)
    enc.load_state_dict(t5_state_dict_from_flax(
        jax.tree.map(np.asarray, flax_model.params)))
    return enc.eval()


def _ids_and_masks(lengths=(1, 7, T)):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (len(lengths), T))
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]) \
        .astype(np.int32)
    return ids, mask


def test_relative_position_buckets_match_flax():
    rel = np.arange(-300, 301)[None, :]
    ref = FlaxT5Attention._relative_position_bucket(jnp.asarray(rel), True,
                                                    32, 128)
    out = t5.relative_position_bucket(torch.tensor(rel), 32, 128)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_matches_flax(dtype):
    """Right-padded masks of 1, 7 and 120 valid tokens (every position
    compared, pad positions too: they attend to the valid keys)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref_model = _flax(dtype=jdt)  # f32 weights, jdt compute
    enc = _port(ref_model, tdt)
    ids, mask = _ids_and_masks()
    ref = np.asarray(ref_model(input_ids=jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask))
                     .last_hidden_state, np.float32)
    out = enc(torch.tensor(ids), torch.tensor(mask))
    assert out.dtype == tdt and out.shape == (3, T, SMALL["d_model"])
    out = out.float().numpy()
    tol = 1e-4 if dtype == "f32" else 2 ** -4 * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=0)


def test_init_weights_scales():
    enc = t5.init_weights(t5.T5Encoder(t5.T5EncoderConfig(**{
        k: v for k, v in SMALL.items() if k != "dropout_rate"})), seed=1)
    attn = enc.encoder.block[0].layer[0].SelfAttention
    assert abs(attn.k.weight.std().item() - 64 ** -0.5) < 0.02
    assert abs(enc.shared.weight.std().item() - 1.0) < 0.05
    assert torch.all(enc.encoder.final_layer_norm.weight == 1)
    assert not hasattr(enc.encoder.block[1].layer[0].SelfAttention,
                       "relative_attention_bias")
    with pytest.raises(ValueError, match="gated-gelu"):
        t5.T5Encoder(t5.T5EncoderConfig(feed_forward_proj="relu"))


def _tokenizer():
    """A tiny Unigram tokenizer: the characters, a few words, `</s>` after
    every text (what T5's post-processor appends), `<pad>` id 0."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    specials = ["<pad>", "</s>", "<unk>"]
    pieces = ["▁" + w for w in ("a", "the", "of", "in", "photo",
                                     "dog", "horse", "blue", "wall")]
    pieces += ["▁"] + list("abcdefghijklmnopqrstuvwxyz0123456789.,!'")
    vocab = [(p, 0.0) for p in specials] + [(p, -1.0 - 0.01 * i)
                                            for i, p in enumerate(pieces)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                                   eos_token="</s>", unk_token="<unk>"), \
        len(vocab)


def make_tiny_t5_dir(path, d_model=2048):
    """A local flan-t5-like checkpoint directory: `config.json`,
    `flax_model.msgpack` (what JAX's T5TextEncoder loads), the same
    weights as the port's `pytorch_model.bin`, and the tiny tokenizer.
    d_model 2048 is the t2i GPT's caption_dim; the rest is small."""
    tok, vocab = _tokenizer()
    model = _flax(seed=3, vocab_size=vocab, d_model=d_model)
    model.save_pretrained(path)
    torch.save(t5_state_dict_from_flax(jax.tree.map(np.asarray,
                                                    model.params)),
               os.path.join(path, "pytorch_model.bin"))
    tok.save_pretrained(path)
    return str(path)


@pytest.fixture(scope="module")
def tiny_t5_dir(tmp_path_factory):
    return make_tiny_t5_dir(tmp_path_factory.mktemp("tiny_t5"))


def test_text_encoders_match_end_to_end(tiny_t5_dir):
    """Cleaning, tokenizing (max length 120, truncation), encoding and the
    left padding: the port's T5TextEncoder against JAX's on one
    directory, f32, within 5e-4 (d_model 2048: f32 sums 32 times as long
    as the 64-wide encoder's, through each layer norm)."""
    ref = JT5TextEncoder(tiny_t5_dir, dtype=jnp.float32)
    enc = t5.T5TextEncoder(tiny_t5_dir, device=torch.device("cpu"),
                           dtype=torch.float32)
    jemb, jmask = ref.get_text_embeddings(CAPTIONS)
    emb, mask = enc.get_text_embeddings(CAPTIONS)
    lengths = mask.sum(dim=1).tolist()
    assert emb.shape == (3, T, 2048) and lengths[2] == T \
        and 1 < lengths[1] < lengths[0] < T
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=5e-4,
                               rtol=0)
    left, lmask = t5.left_pad_embeddings(emb.numpy(), mask.numpy())
    jleft, jlmask = jleft_pad(np.asarray(jemb), np.asarray(jmask))
    np.testing.assert_array_equal(lmask, jlmask)
    np.testing.assert_allclose(left, jleft, atol=5e-4, rtol=0)
    assert not left[1, :T - lengths[1]].any()


def test_load_refuses_a_directory_without_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="pytorch_model"):
        t5.load_t5_state_dict(str(tmp_path))


def test_extract_t5_features_cli(tiny_t5_dir, tmp_path):
    caps = tmp_path / "caps.jsonl"
    caps.write_text("".join(json.dumps({"caption": c}) + "\n"
                            for c in CAPTIONS))
    out = tmp_path / "feat"
    extract_t5_features.main(["--caption-file", str(caps), "--t5-path",
                              tiny_t5_dir, "--out-dir", str(out),
                              "--batch-size", "2", "--device", "cpu"])
    enc = t5.T5TextEncoder(tiny_t5_dir, device=torch.device("cpu"))
    # the CLI's batches of 2: equal outputs, bit for bit
    parts = [enc.get_text_embeddings(CAPTIONS[i:i + 2]) for i in (0, 2)]
    emb, mask = (torch.cat(x) for x in zip(*parts))
    for i in range(3):
        with np.load(out / f"{i}.npz") as z:
            assert z["feature"].dtype == np.float16 \
                and z["feature"].shape == (T, 2048)
            assert z["mask"].dtype == np.int8
            np.testing.assert_array_equal(z["mask"], mask[i].numpy())
            np.testing.assert_array_equal(
                z["feature"], emb[i].float().numpy().astype(np.float16))
