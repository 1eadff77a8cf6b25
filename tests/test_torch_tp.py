"""The port's tensor-parallel serving (`parallel/tp_decode.py`,
`parallel/collectives.py`, `ServeEngine(tp=)`) against the JAX package on
the CPU.

Layouts are held bit for bit: `_head_major` / `_head_major_inv` (GQA
too) and the per-shard W4 packing with its W8A16 fallback by JAX's rule.
The rest runs in two gloo ranks (`tests/torch_ranks.py::tp_cases`, one
launch for every case): TP decode steps against JAX's
`make_tp_decode_step` on a two-device mesh (its Pallas kernel in
interpret mode), f32 logits within 2e-4, bf16 within 1/64 of the largest
logit; greedy f32 TP-engine tokens equal to JAX's one-device `generate`
(the oracle JAX's own TP engine test uses) for c2i, W8A16, GQA, t2i
with left pads 0 / some / most, slot reuse with more requests than
slots and per-request cfg; per-shard W4 against the port's `generate`
on `unshard_w4_tp_for_reference`'s model (as JAX's test builds its
reference); an int8 cache agrees with the f32 one on >= 85 % of the
tokens, as JAX's test asks; both ranks' tokens equal in every case (bf16
too). bf16 tokens are not held to JAX's: the bf16 sums of the ranks'
partial outputs round otherwise than one device's product (3 of 32
tokens differed), so bf16 is held by the decode logits. The pure launch
geometries of K1, K2 and K3 hold at every per-rank shape of GPT-L,
GPT-XL and GPT-XXL at tp 2 and 4. Widths: head dim 64, 2 to 4 heads a
rank (3 in the W4 fallback config), 2 layers.
"""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from llamagen_tpu.ops.generate import generate as jgenerate
from llamagen_tpu.ops.quant_matmul import quantize_gpt_params as jquantize
from llamagen_tpu.parallel import tp_decode as jtp
from llamagen_tpu.parallel.mesh import make_mesh as jmake_mesh
from llamagen_tpu_torch.config import GPTConfig, gpt_config
from llamagen_tpu_torch.ops.chunk_attention import chunk_geometry
from llamagen_tpu_torch.ops.generate import generate
from llamagen_tpu_torch.ops.quant_matmul import int8_geometry
from llamagen_tpu_torch.ops.w4_matmul import _pick_bn, w4_geometry
from llamagen_tpu_torch.parallel import tp_decode
from test_torch_gpt import jax_config, make_pair
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from torch_ranks import launch

TP = 2
SMALL = dict(n_layer=2, block_size=16, vocab_size=512, num_classes=10,
             cls_token_num=1)
C2I = GPTConfig(dim=256, n_head=4, **SMALL)                 # 2 heads a rank
GQA = GPTConfig(dim=512, n_head=8, n_kv_head=4, **SMALL)    # 4 q, 2 kv a rank
# 3 heads a rank: wqkv's shard is 576 wide, no multiple of 128, so JAX's
# rule makes it W8A16; w1 / w3 (512 a rank) and wo / w2 stay W4
W4MIX = GPTConfig(dim=384, n_head=6, **SMALL)
T2I = GPTConfig(dim=256, n_head=4, n_layer=2, block_size=16, vocab_size=512,
                cls_token_num=8, model_type="t2i", caption_dim=32)
MAX_NEW = 16
GROUP = 64  # the per-shard W4 group size
F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
GREEDY = dict(cfg_scale=2.0, temperature=0.0)
LABELS = [3, 7]
PADS = (0, 3, 7)  # t2i left pads: none, some, all but one of 8
DECODE_TOKENS = np.random.RandomState(1).randint(0, 512, (3, 2))
# bf16 decode logits against JAX's: a share of the largest |logit| (the
# ranks' bf16 partial sums and bf16 cache rows; measured 0.0072-0.0077)
BF16_LOGITS = 1 / 64


def _jgen(params, cfg, cond, cfg_scale=2.0, emb_masks=None,
          dtype=jnp.float32):
    return np.asarray(jgenerate(
        params, jax.random.PRNGKey(0), jnp.asarray(cond),
        cfg=jax_config(cfg), max_new_tokens=MAX_NEW, cfg_scale=cfg_scale,
        sample_logits=False, compute_dtype=dtype, cache_dtype=dtype,
        emb_masks=None if emb_masks is None else jnp.asarray(emb_masks)))


def _engine(cfg, sd, requests, sp=GREEDY, pairs=2, quant=None, **kw):
    return dict(kind="engine", cfg=cfg, sd=sd, quant=quant,
                group_size=GROUP, sp=sp, requests=requests,
                engine=dict(num_pairs=pairs, max_new_tokens=MAX_NEW,
                            **{**F32, **kw}))


def _captions(seed=5):
    rng = np.random.RandomState(seed)
    caps = rng.randn(len(PADS), T2I.cls_token_num, T2I.caption_dim) \
        .astype(np.float32)
    masks = np.arange(T2I.cls_token_num)[None] >= np.array(PADS)[:, None]
    caps[~masks] = 0
    return caps, masks


@pytest.fixture(scope="module")
def pairs():
    return {"c2i": make_pair(C2I), "gqa": make_pair(GQA, seed=2),
            "w4": make_pair(W4MIX, seed=3), "t2i": make_pair(T2I, seed=4)}


@pytest.fixture(scope="module")
def tp_runs(pairs):
    """Every rank's results of every case, from one two-rank launch."""
    sd = {k: v[1].state_dict() for k, v in pairs.items()}
    caps, masks = _captions()
    mixed = [(3, None), (7, dict(cfg_scale=4.0, temperature=0.0)),
             (1, dict(cfg_scale=1.5, temperature=0.0))]
    cases = {
        "decode_f32": dict(kind="decode", cfg=C2I, sd=sd["c2i"],
                           tokens=DECODE_TOKENS),
        "decode_bf16": dict(kind="decode", cfg=C2I, sd=sd["c2i"],
                            tokens=DECODE_TOKENS, dtype=torch.bfloat16),
        "f32": _engine(C2I, sd["c2i"], [(l, None) for l in LABELS]),
        "bf16": _engine(C2I, sd["c2i"], [(l, None) for l in LABELS],
                        compute_dtype=torch.bfloat16,
                        cache_dtype=torch.bfloat16),
        "int8_cache": _engine(C2I, sd["c2i"], [(l, None) for l in LABELS],
                              cache_dtype=torch.int8),
        "w8a16": _engine(C2I, sd["c2i"], [(l, None) for l in LABELS],
                         quant="int8"),
        "gqa": _engine(GQA, sd["gqa"], [(l, None) for l in LABELS]),
        "w4": _engine(W4MIX, sd["w4"], [(l, None) for l in LABELS],
                      quant="w4"),
        # 5 requests through 2 slots: three reuse a slot
        "reuse": _engine(C2I, sd["c2i"], [(l, None) for l in
                                          (5, 1, 2, 5, 8)]),
        "per_request_cfg": _engine(C2I, sd["c2i"], mixed),
        "t2i": _engine(T2I, sd["t2i"], [((c, m), None) for c, m in
                                        zip(caps, masks)], pairs=2),
    }
    return launch("tp_cases", TP, cases)


# --- layouts, bit for bit -----------------------------------------------------


@pytest.mark.parametrize("cfg,tp", [(C2I, 2), (C2I, 4), (GQA, 2), (GQA, 4),
                                    (W4MIX, 2)],
                         ids=["mha-tp2", "mha-tp4", "gqa-tp2", "gqa-tp4",
                              "w4mix-tp2"])
def test_head_major_is_jax_bit_for_bit(cfg, tp):
    width = (cfg.n_head + 2 * cfg.kv_heads) * cfg.head_dim
    x = np.random.RandomState(0).randn(3, width).astype(np.float32)
    got = tp_decode._head_major(torch.from_numpy(x), cfg, tp)
    want = jtp._head_major(jnp.asarray(x), jax_config(cfg), tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tp_decode._head_major_inv(got, cfg, tp)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jtp._head_major_inv(want, jax_config(cfg),
                                                     tp)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("name,per_channel", [("c2i", False), ("gqa", True),
                                              ("w4", False)])
def test_per_shard_w4_packing_is_jax_bit_for_bit(pairs, name, per_channel):
    """Per-shard packs (and the W8A16 fallback keys, head-major wqkv) equal
    JAX's `quantize_gpt_params_w4k_tp`; W4MIX's wqkv falls back, as JAX's
    rule has it, and its other keys stay W4."""
    params, model = pairs[name]
    cfg = model.cfg
    jq = jtp.quantize_gpt_params_w4k_tp(params, jax_config(cfg), TP,
                                        per_channel=per_channel,
                                        group_size=GROUP)["layers"]
    model = tp_decode.quantize_gpt_params_w4k_tp(
        copy.deepcopy(model), TP, per_channel=per_channel, group_size=GROUP)
    for key, name_, lin in tp_decode._linears(model):
        layer = int(name_.split(".")[1])
        if lin.weight_w4b is not None:
            for mine, theirs in ((lin.weight_w4b, f"{key}_w4b"),
                                 (lin.weight_w4s, f"{key}_w4s")):
                np.testing.assert_array_equal(
                    mine.numpy(), np.asarray(jq[theirs][layer]),
                    err_msg=f"{key} {theirs}")
        else:
            np.testing.assert_array_equal(lin.weight_q.numpy(),
                                          np.asarray(jq[f"{key}_q"][layer]))
            np.testing.assert_array_equal(
                lin.weight_scale.numpy(),
                np.asarray(jq[f"{key}_scale"][layer]))
    fell_back = {k for k, _, lin in tp_decode._linears(model)
                 if lin.weight_q is not None}
    assert fell_back == ({"wqkv"} if name == "w4" else set())


def test_unshard_w4_equals_jax_reference(pairs):
    params, model = pairs["w4"]
    ref = tp_decode.unshard_w4_tp_for_reference(
        tp_decode.quantize_gpt_params_w4k_tp(copy.deepcopy(model), TP,
                                             group_size=GROUP), TP)
    jref = jtp.unshard_w4_tp_for_reference(
        jtp.quantize_gpt_params_w4k_tp(params, jax_config(W4MIX), TP,
                                       group_size=GROUP),
        jax_config(W4MIX), TP)["layers"]
    for key, name, lin in tp_decode._linears(ref):
        layer = int(name.split(".")[1])
        np.testing.assert_array_equal(lin.weight.detach().t().numpy(),
                                      np.asarray(jref[key][layer]))


def test_shard_refuses_what_tp_cannot_hold(pairs):
    model = copy.deepcopy(pairs["c2i"][1])
    with pytest.raises(ValueError, match="heads"):
        tp_decode.shard_tp_params(copy.deepcopy(model), 0, 3)
    with pytest.raises(ValueError, match="kv_heads"):
        tp_decode.shard_tp_params(copy.deepcopy(pairs["gqa"][1]), 0, 8)
    from llamagen_tpu_torch.ops.w4_matmul import quantize_gpt_params_w4k
    with pytest.raises(ValueError, match="one-card W4"):
        tp_decode.shard_tp_params(quantize_gpt_params_w4k(
            copy.deepcopy(model)), 0, 2)
    shard = tp_decode.shard_tp_params(model, 1, 2)  # a layout, no group
    assert shard.layers[0].attention.wqkv.weight.shape == (384, 256)
    assert shard.output.weight.shape == (C2I.vocab_size // 2, 256)
    from llamagen_tpu_torch.models import gpt
    cache = gpt.init_cache(C2I, 2, 128, torch.float32, "cpu", torch.float32,
                           kv_heads=shard.n_local_kv_heads)
    assert cache.kv[0].shape == (2, 128, 256)  # 2 of 4 heads' k | v
    with pytest.raises(ValueError, match="process group"):
        gpt.decode_step(shard, torch.zeros(2, dtype=torch.long), 0, cache,
                        torch.float32)
    from llamagen_tpu_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="process group"):
        ServeEngine(shard, tp=2, max_new_tokens=8)
    with pytest.raises(ValueError, match="shard_tp_params"):
        ServeEngine(pairs["c2i"][1], tp=2, max_new_tokens=8)


# --- two gloo ranks against JAX -------------------------------------------------


@pytest.mark.parametrize("case", ["f32", "w8a16", "gqa"])
def test_tp_engine_greedy_equals_jax_generate(pairs, tp_runs, case):
    params, model = pairs["gqa" if case == "gqa" else "c2i"]
    if case == "w8a16":
        params = jquantize(params)
    want = _jgen(params, model.cfg, LABELS)
    for r, got in enumerate(tp_runs):
        np.testing.assert_array_equal(got[case], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tp_decode_step_matches_jax_tp_decode(pairs, tp_runs, dtype):
    """3 steps from an empty cache: each rank's gathered logits against
    JAX's shard_map'd step on a (1, 1, 2) mesh: f32 within 2e-4; bf16
    (compute and cache) within BF16_LOGITS of the largest |logit|."""
    params, _ = pairs["c2i"]
    jcfg = jax_config(C2I)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    mesh = jmake_mesh(1, 1, TP, devices=jax.devices()[:TP])
    tpp = jtp.shard_tp_params(params, jcfg, mesh)
    kv = NamedSharding(mesh, P(None, None, "tp"))
    f2 = 2 * C2I.dim
    mk = lambda s: tuple(jax.device_put(jnp.zeros((2, s, f2), jdt), kv)
                         for _ in range(C2I.n_layer))
    cache, recent = mk(128), mk(8)
    step = jax.jit(jtp.make_tp_decode_step(jcfg, mesh, TP,
                                           compute_dtype=jdt))
    for i, t in enumerate(DECODE_TOKENS):
        want, cache, recent = step(tpp, jnp.asarray(t), jnp.int32(i), cache,
                                   recent)
        want = np.asarray(want)
        atol = 2e-4 if dtype == "f32" else \
            BF16_LOGITS * np.abs(want).max()
        for r, got in enumerate(tp_runs):
            np.testing.assert_allclose(got[f"decode_{dtype}"][i], want,
                                       atol=atol, rtol=0,
                                       err_msg=f"rank {r} step {i}")


def test_tp_engine_per_shard_w4_equals_its_reference(pairs, tp_runs):
    """The per-shard W4 engine (W4 kernel's plain version on w1 / w3 / wo /
    w2, W8A16 on the fallen-back wqkv) against `generate` on the model of
    its dequantised shards."""
    _, model = pairs["w4"]
    ref = tp_decode.unshard_w4_tp_for_reference(
        tp_decode.quantize_gpt_params_w4k_tp(copy.deepcopy(model), TP,
                                             group_size=GROUP), TP)
    want = generate(ref, torch.tensor(LABELS), max_new_tokens=MAX_NEW,
                    cfg_scale=2.0, sample_logits=False, **F32).numpy()
    for r, got in enumerate(tp_runs):
        np.testing.assert_array_equal(got["w4"], want, err_msg=f"rank {r}")


def test_tp_engine_slot_reuse_more_requests_than_slots(pairs, tp_runs):
    params, _ = pairs["c2i"]
    want = _jgen(params, C2I, [5, 1, 2, 5, 8])
    for r, got in enumerate(tp_runs):
        np.testing.assert_array_equal(got["reuse"], want, err_msg=f"rank {r}")


def test_tp_engine_per_request_cfg(pairs, tp_runs):
    params, _ = pairs["c2i"]
    for i, (label, scale) in enumerate(((3, 2.0), (7, 4.0), (1, 1.5))):
        want = _jgen(params, C2I, [label], cfg_scale=scale)
        for r, got in enumerate(tp_runs):
            np.testing.assert_array_equal(got["per_request_cfg"][i:i + 1],
                                          want, err_msg=f"rank {r} req {i}")


def test_tp_t2i_engine_equals_jax_generate_with_pads(pairs, tp_runs):
    """Batched caption admission on each rank's local heads, then decode
    with `prefix_pad`; pads 0, 3 and 7 of 8, through two slots."""
    params, _ = pairs["t2i"]
    caps, masks = _captions()
    want = _jgen(params, T2I, caps, emb_masks=masks)
    for r, got in enumerate(tp_runs):
        np.testing.assert_array_equal(got["t2i"], want, err_msg=f"rank {r}")


def test_tp_engine_int8_cache_close_to_f32(tp_runs):
    for got in tp_runs:
        agree = (got["int8_cache"] == got["f32"]).mean()
        assert agree >= 0.85, f"greedy agreement {agree:.3f}"


@pytest.mark.parametrize("case", ["f32", "bf16", "int8_cache", "w8a16", "gqa",
                                  "w4", "reuse", "per_request_cfg", "t2i"])
def test_tokens_equal_on_every_rank(tp_runs, case):
    np.testing.assert_array_equal(tp_runs[0][case], tp_runs[1][case])


# --- the kernels' launch geometry at every per-rank shape ----------------------

SMS = 132  # an H100 SXM's SMs
ZOO = [(name, tp) for name in ("GPT-L", "GPT-XL", "GPT-XXL") for tp in (2, 4)]


def _rank_shapes(name, tp):
    """(key, K, N) of a rank's five layer matmuls and its head."""
    cfg = gpt_config(name, block_size=576, cls_token_num=1)
    d, h = cfg.dim, cfg.ffn_hidden_dim
    qkv = (cfg.n_head + 2 * cfg.kv_heads) * cfg.head_dim
    return cfg, [("wqkv", d, qkv // tp), ("wo", d // tp, d),
                 ("w1", d, h // tp), ("w3", d, h // tp), ("w2", h // tp, d),
                 ("output", d, cfg.vocab_size // tp)]


@pytest.mark.parametrize("name,tp", ZOO, ids=[f"{n}-tp{t}" for n, t in ZOO])
def test_k1_k2_k3_geometry_at_per_rank_shapes(name, tp):
    """K2 at the engine's rows (2P = 16 and 128) and a t2i admission's of
    1, 4 and 8 pairs (240, 960 and 1,920 rows), bf16 and f32 x; K3 on every shard JAX's rule
    keeps W4 (grouped g128 and per channel; the others are W8A16, whose
    K2 geometry is checked); K1 (int8 and bf16 caches) and K5 at the
    rank's heads."""
    cfg, shapes = _rank_shapes(name, tp)
    for key, k, n in shapes:
        for b in (16, 128, 240, 960, 1920):
            for f32 in (False, True):
                geo = int8_geometry(b, k, n, SMS, f32)
                assert geo.ks * geo.kb >= k and geo.bc <= 96, (key, b)
        if key == "output":
            continue
        if tp_decode._n_alignable(n) and k % 2 == 0:
            for seg in (None, 64 if (k // 2) % 128 else 128):
                geo = w4_geometry(16, k // 2, n, _pick_bn(n), seg, SMS)
                assert geo.ks * geo.kb >= k // 2, (key, seg)
    heads, kv = cfg.n_head // tp, cfg.kv_heads // tp
    for b, s in ((16, 640), (128, 640), (16, 1152)):
        for int8 in (False, True):
            geo = chunk_geometry(b, heads, kv, s, cfg.head_dim, SMS, int8)
            assert heads % geo.nq == 0 and 1 <= geo.nsplit <= 8


def test_per_shard_w4_rule_at_the_zoo():
    """Which keys JAX's rule keeps W4 at tp 2 and 4: every key at GPT-L /
    XL / XXL tp 2 and GPT-XXL tp 4; at tp 4 the shards 704 (GPT-L w1 / w3)
    and 960 (GPT-XL wqkv) wide have no block width and fall back."""
    fallback = {}
    for name, tp in ZOO:
        _, shapes = _rank_shapes(name, tp)
        fallback[name, tp] = sorted(
            key for key, k, n in shapes[:5]
            if not tp_decode._n_alignable(n) or k % 2)
    assert fallback == {
        ("GPT-L", 2): [], ("GPT-L", 4): ["w1", "w3"],
        ("GPT-XL", 2): [], ("GPT-XL", 4): ["wqkv"],
        ("GPT-XXL", 2): [], ("GPT-XXL", 4): []}
