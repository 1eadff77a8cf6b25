"""The port's CLIP (`eval/clip.py`) against HF `FlaxCLIPModel`, the model
the JAX package's `eval/clip.py` runs, on the CPU.

One random HF torch `CLIPModel` at the tiny config of
`tests/test_clip_score.py` is saved as a local directory; Flax reads it
(`from_pt`) and the port loads it with `load_clip`. A stub tokenizer
stands in for `CLIPTokenizerFast` (it needs tokenizer files that are not
in the repository). Tolerances, f32: image and text features within 1e-5
of their largest |value|, pair scores (100 * cos) within 1e-4;
`preprocess` (a numpy / PIL copy) bit-identical.
"""

import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.eval import clip as jclip
from llamagen_tpu_torch.eval import clip
from llamagen_tpu_torch.utils.convert import clip_state_dict_from_flax
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

transformers = pytest.importorskip("transformers")

FEATURE_TOL = 1e-5  # of each output's largest |value|
SCORE_TOL = 1e-4


def tiny_clip_config(eos_token_id):
    from transformers import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    return CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2,
                       max_position_embeddings=77, vocab_size=99,
                       eos_token_id=eos_token_id),
        CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         image_size=32, patch_size=8),
        projection_dim=16)


class StubTokenizer:
    """Deterministic token ids from each caption's crc32: varied lengths,
    the highest id (98) ending each caption as the end-of-text token does,
    padding 1."""

    def __call__(self, texts, **kw):
        ids = np.ones((len(texts), 77), np.int64)
        for i, t in enumerate(texts):
            h = zlib.crc32(t.encode())
            n = min(5 + h % 30, 76)
            ids[i, :n - 1] = np.random.RandomState(h).randint(2, 98,
                                                              size=(n - 1,))
            ids[i, n - 1] = 98
        mask = (ids != 1).astype(np.int64)
        mask[:, 0] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module", params=[2, 98], ids=["eos2", "eos98"])
def models(request, tmp_path_factory):
    """eos_token_id 2 (the published ViT-B/32 config's) pools at the
    highest id; any other at the first end-of-text id."""
    from transformers import CLIPModel, FlaxCLIPModel

    torch.manual_seed(0)
    pt = CLIPModel(tiny_clip_config(request.param)).eval()
    d = str(tmp_path_factory.mktemp("clip"))
    pt.save_pretrained(d, safe_serialization=False)
    fx = FlaxCLIPModel.from_pretrained(d, from_pt=True)
    return pt, fx, clip.load_clip(d, device="cpu")


def _close(got, want, tol):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_config_and_weights_load_from_an_hf_directory(models):
    pt, _, port = models
    assert port.cfg.text.hidden_size == 32 and port.cfg.patch_size == 8
    assert port.cfg.image_size == 32 and port.cfg.projection_dim == 16
    want = {k: v for k, v in pt.state_dict().items()
            if not k.endswith("position_ids")}
    assert sorted(port.state_dict()) == sorted(want)
    for k, v in want.items():
        assert torch.equal(port.state_dict()[k], v), k


def test_clip_state_dict_from_flax_equals_the_torch_weights(models):
    pt, fx, port = models
    sd = clip_state_dict_from_flax(jax.tree.map(np.asarray, fx.params))
    assert sorted(sd) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)


def test_features_match_flax(models):
    _, fx, port = models
    rng = np.random.RandomState(0)
    pixels = rng.randn(3, 3, 32, 32).astype(np.float32)
    tok = StubTokenizer()(["a cat", "two dogs on a sofa, oil painting",
                           "x"])
    with torch.no_grad():
        img = port.get_image_features(torch.from_numpy(pixels))
        txt = port.get_text_features(torch.from_numpy(tok["input_ids"]),
                                     torch.from_numpy(tok["attention_mask"]))
    _close(img, fx.get_image_features(pixel_values=jnp.asarray(pixels)),
           FEATURE_TOL)
    _close(txt, fx.get_text_features(
        input_ids=jnp.asarray(tok["input_ids"]),
        attention_mask=jnp.asarray(tok["attention_mask"])), FEATURE_TOL)


def _jax_scorer(fx):
    """JAX's ClipScorer on the Flax model and the stub tokenizer (its
    constructor reads a directory with tokenizer files)."""
    s = jclip.ClipScorer.__new__(jclip.ClipScorer)
    s.model, s.tokenizer, s.batch_size, s.image_size = \
        fx, StubTokenizer(), 3, 32

    def embed(params, pixel_values, input_ids, attention_mask):
        img = fx.get_image_features(pixel_values=pixel_values, params=params)
        txt = fx.get_text_features(input_ids=input_ids,
                                   attention_mask=attention_mask,
                                   params=params)
        img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
        return jnp.sum(img * txt, axis=-1)

    s._embed = jax.jit(embed)
    return s


def test_pair_scores_match_jax(models):
    _, fx, port = models
    images = np.random.RandomState(1).randint(0, 256, (5, 48, 40, 3),
                                              np.uint8)
    captions = ["a red bus", "the sea at night", "a bowl of fruit",
                "an owl", "mountains under snow, wide shot"]
    scorer = clip.ClipScorer(model=port, tokenizer=StubTokenizer(),
                             batch_size=2, device="cpu")
    got = scorer.pair_scores(images, captions)
    want = _jax_scorer(fx).pair_scores(images, captions)
    assert got.shape == (5,) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    assert abs(scorer.score(images, captions)
               - float(np.mean(want))) <= SCORE_TOL
    # the cosines themselves, before the clip at 0: JAX's shifted by 2
    cos = scorer.cosines(images, captions)
    assert np.allclose(100 * np.maximum(cos, 0), got)
    jscorer = _jax_scorer(fx)
    embed = jscorer._embed
    jscorer._embed = lambda *a: embed(*a) + 2.0
    jcos = jscorer.pair_scores(images, captions) / 100.0 - 2.0
    np.testing.assert_allclose(cos, jcos, rtol=0, atol=SCORE_TOL / 100)


@pytest.mark.parametrize("shape,size", [((2, 256, 256, 3), 224),
                                        ((3, 40, 60, 3), 32),
                                        ((1, 300, 200, 3), 224)])
def test_preprocess_bit_identical(shape, size):
    images = np.random.RandomState(sum(shape)).randint(0, 256, shape,
                                                       np.uint8)
    got = clip.preprocess(images, size)
    want = jclip.preprocess(images, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_the_default_config_is_vit_b32():
    cfg = clip.ClipConfig()
    assert (cfg.vision.hidden_size, cfg.vision.num_hidden_layers,
            cfg.patch_size, cfg.image_size) == (768, 12, 32, 224)
    assert (cfg.text.hidden_size, cfg.text.num_attention_heads,
            cfg.projection_dim, cfg.vocab_size) == (512, 8, 512, 49408)
    with pytest.raises(ValueError, match="quick_gelu"):
        clip.ClipConfig.from_hf({"text_config": {"hidden_act": "gelu"},
                                 "vision_config": {}})
