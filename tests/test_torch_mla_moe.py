"""DeepSeek-V2's block (MLA + routed experts) as a c2i generator
(`llamagen_tpu_torch/models/mla_moe.py`), its kernels K6
(`ops/mla_attention.py`) and K7 (`ops/moe.py`), and its path through the
serving engine, against the benchmark's plain reference
(`perfbench/reference/mla_moe.py`, the one reference).

CPU: a seeded tiny configuration (dim 64, 4 heads, latent 32 + rope 16, 8
experts top-2, 1 shared, 3 layers with layer 0 dense), all in float32, so
that what is left between the program and the reference is the order of
floating-point sums: decode through the latent cache equals the
reference's full forward, the absorbed attention equals the un-absorbed
one, the dispatch and combine equal the expert loop (an expert with no
rows, every row on one expert), the engine's greedy tokens are the
reference's argmax; the published configuration's size and widths; K2's
geometry at the model's dense shapes.

Card (`-m cuda`; no JAX here: `python -m pytest --noconftest -m cuda
tests/test_torch_mla_moe.py`): K6 and K7 against their plain versions at
the serving cell's shapes, graphed and eager engines bit for bit, the
routed step under sync debug "error", GPT-L's launches unchanged.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.config import MLA_MOE_CONFIGS, MLAMoEConfig
from llamagen_tpu_torch.models import mla_moe
from llamagen_tpu_torch.ops import moe
from llamagen_tpu_torch.ops.mla_attention import (mla_decode_attention,
                                                  mla_decode_attention_ref)
from llamagen_tpu_torch.ops.quant_matmul import (int8_geometry,
                                                 int8_matmul_ref,
                                                 quantize_weight)
from llamagen_tpu_torch.serve.engine import SamplingParams, ServeEngine
from perfbench.drivers import serve_mla_moe as driver
from perfbench.reference import mla_moe as ref

ROOT = Path(__file__).resolve().parent.parent
PUBLISHED = json.loads((ROOT / "perfbench" / "configs"
                        / "dsv2-lite-c2i-384.json").read_text())
TINY = dict(PUBLISHED, hidden_size=64, num_attention_heads=4,
            kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=16,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            num_hidden_layers=3, vocab_size=64, num_classes=10,
            block_size=16)
SEED = 2 ** 33 + 11


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several pytest workers share the CPU: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the K6 / K7 kernels")
    return torch.device("cuda")


def tiny_model(c=TINY, dev="cpu", dtype=torch.float32):
    return driver.build_model(c, SEED, torch.device(dev), dtype)


def teacher_forced(model, labels, tokens, cfg_scale):
    """The program's CFG-mixed logits [N, T, V] for the served tokens, one
    decode step a position through a latent cache of its own."""
    cfg = model.cfg
    n, t = tokens.shape
    dtype = model.tok_embeddings.weight.dtype
    cache = mla_moe.init_cache(cfg, 2 * n, cfg.max_seq_len, dtype,
                               tokens.device)
    table = model.cls_embedding.embedding_table.weight
    emb = torch.cat([table[labels],
                     table[torch.full_like(labels, cfg.num_classes)]])
    out = []
    for i in range(t):
        if i:
            emb = model.tok_embeddings.weight[tokens[:, i - 1]].repeat(2, 1)
        pos = torch.full((2 * n,), i, dtype=torch.int32,
                         device=tokens.device)
        lg = mla_moe.decode_step_slots(model, emb, pos, cache, dtype)
        cl, un = lg.chunk(2)
        out.append(un + (cl - un) * cfg_scale)
    return torch.stack(out, dim=1)


def reference(labels, tokens, cfg_scale, c=TINY, **kw):
    return ref.serve_logits(c, SEED, tokens.device, labels, tokens,
                            cfg_scale, latent_dtype=torch.float32,
                            weight_dtype=torch.float32, **kw)


# --- CPU ---------------------------------------------------------------------


def test_decode_through_the_latent_cache_equals_the_reference_forward():
    """Class-token admission at position 0, then one decode step a
    position through the latent cache, equals the reference's one full
    forward (un-absorbed, the experts as a loop). f32 on both sides:
    logits of size ~1 agree to 2e-5, the order of the sums; the routing is
    the same on every row (no near tie at f32)."""
    model = tiny_model()
    g = torch.Generator().manual_seed(3)
    labels = torch.tensor([1, 7, 0])
    tokens = torch.randint(0, TINY["vocab_size"], (3, TINY["block_size"]),
                           generator=g)
    got = teacher_forced(model, labels, tokens, 2.0)
    want = reference(labels, tokens, 2.0)
    assert got.shape == want.shape == (3, 16, 64)
    assert want.abs().max() > 0.3
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_absorbed_decode_equals_the_unabsorbed_attention():
    """One layer's attention: the program's absorbed form (q mapped into
    the latent, K6's plain version over the latent rows, the latent mapped
    to v-space) position by position through the cache equals the
    reference's un-absorbed form (k_nope and v expanded per head from the
    latent) over the whole sequence, to f32 rounding."""
    model = tiny_model()
    cfg = model.cfg
    layer = model.layers[1]
    s = cfg.max_seq_len
    x = torch.randn(2, s, cfg.dim, generator=torch.Generator().manual_seed(5))
    cache = mla_moe.init_cache(cfg, 2, s, torch.float32, "cpu").kv[1]
    got = torch.stack([
        mla_moe._attention(layer.self_attn, x[:, i],
                           model.freqs_cis[[i, i]], cache,
                           torch.tensor([i, i], dtype=torch.int32), cfg)
        for i in range(s)], dim=1)
    raw = ref.wts.layer_weights(TINY, SEED, 1, "cpu", torch.float32)
    w = {"raw": raw, "f": lambda k: raw[k].float(),
         "q": lambda k: ref.quant_weight(raw[k], 8)}
    rows = torch.arange(s)
    want = ref._attention(TINY, w, "layers.1.", x,
                          ref.rope_table(TINY)[:s],
                          rows[None] <= rows[:, None], torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # the cache holds the normed latent and the roped shared key
    assert cache.shape == (2, s, 48) and cache.abs().sum(-1).gt(0).all()


def test_plain_k6_writes_the_row_and_masks_later_rows():
    g = torch.Generator().manual_seed(1)
    q, new = torch.randn(3, 16, 48, generator=g), torch.randn(3, 48,
                                                               generator=g)
    cache = torch.randn(3, 20, 48, generator=g)
    pos = torch.tensor([0, 7, 19], dtype=torch.int32)
    out = mla_decode_attention(q, new, cache, pos, 32, 0.2)
    for b, p in enumerate(pos.tolist()):
        assert torch.equal(cache[b, p], new[b])
        s = (q[b] @ cache[b, :p + 1].t()) * 0.2
        want = torch.softmax(s, -1) @ cache[b, :p + 1, :32]
        torch.testing.assert_close(out[b], want, rtol=0, atol=1e-5)


def _routed_loop(x, ids, weights, experts):
    """The routed output as a loop over (row, choice), each product the
    plain int8 matmul."""
    out = torch.zeros_like(x)
    f = experts.w13_q.shape[2] // 2
    for t in range(x.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            gu = int8_matmul_ref(x[t:t + 1], experts.w13_q[e],
                                 experts.w13_scale[e])
            a = torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]
            out[t] += weights[t, j] * int8_matmul_ref(
                a, experts.w2_q[e], experts.w2_scale[e])[0]
    return out


@pytest.mark.parametrize("case", ["random", "two_experts", "one_expert"])
def test_dispatch_and_combine_equal_the_expert_loop(case, monkeypatch):
    """The sort by expert, the offsets, K7's plain version and the
    combine give the loop over each row's choices; with every row on
    experts 0 and 1 the other six get no rows, and with every pair on
    expert 3 the other seven get none."""
    g = torch.Generator().manual_seed(7)
    e, d, f, t, k = 8, 32, 16, 9, 2
    gate, up = torch.randn(e, f, d, generator=g), torch.randn(e, f, d,
                                                              generator=g)
    experts = moe.quantize_experts(gate, up, torch.randn(e, d, f,
                                                         generator=g))
    x = torch.randn(t, d, generator=g)
    gate_w = torch.randn(e, d, generator=g)
    if case != "random":
        ids = torch.stack([torch.zeros(t), torch.ones(t)], 1).long()
        if case == "one_expert":
            ids.fill_(3)
        weights = torch.rand(t, k, generator=g)
        monkeypatch.setattr(moe, "route", lambda *a: (weights, ids))
    weights, ids = moe.route(x, gate_w, k)
    disp = moe.dispatch(ids, e)
    assert disp.offsets[-1] == t * k and disp.counts.sum() == t * k
    if case != "random":
        assert (disp.counts == 0).sum() == (6 if case == "two_experts" else 7)
    rows = torch.zeros(e, dtype=torch.int32)
    got = moe.moe_forward(x, gate_w, experts, k, 1.0, rows)
    # f32 sums of terms up to ~300 taken in another order: a few ulps of
    # the largest (3e-5 each)
    want = _routed_loop(x, ids, weights, experts)
    assert want.abs().max() < 1e3
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    assert torch.equal(rows, disp.counts)


def test_router_is_greedy_softmax_not_renormalised():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(5, 8, generator=g), torch.randn(6, 8, generator=g)
    weights, ids = moe.route(x, w, 3)
    p = torch.softmax(x @ w.t(), -1)
    assert torch.equal(ids, p.argsort(-1, descending=True)[:, :3])
    torch.testing.assert_close(weights, p.gather(1, ids))
    assert (weights.sum(-1) < 1).all()


def test_engine_greedy_tokens_are_the_reference_argmax():
    """The slot engine (staggered admissions, slots reused) on the tiny
    model at temperature 0: every served token is the reference's best at
    its position, to f32 rounding of logits of size ~1; the engine counts
    the rows it routed and names them on its decode span."""
    model = tiny_model()
    eng = ServeEngine(model, num_pairs=3, max_new_tokens=16,
                      sampling_params=SamplingParams(cfg_scale=2.0,
                                                     temperature=0.0),
                      chunk=5, compute_dtype=torch.float32,
                      cache_dtype=torch.float32)
    labels = [3, 7, 0, 9, 3]
    tokens = torch.as_tensor(eng.generate(labels))
    logits = reference(torch.tensor(labels), tokens, 2.0)
    best = logits.max(-1).values
    assert (best - logits.gather(-1, tokens[..., None])[..., 0]).max() < 1e-5
    rows = np.asarray(eng.stats()["moe_expert_rows"])
    assert rows.shape == (2, 8)
    assert (rows.sum(1) == eng.steps_run * 6 * 2).all()  # 2P rows x top 2
    eng.reset_stats()
    assert eng.stats()["moe_expert_rows"] == [[0] * 8] * 2


def test_teacher_forced_routes_are_the_reference_routes():
    """`decode_step_slots` hands back each routed layer's choices through
    `route_ids` (what the cell's calibration compares): on the tiny f32
    model, teacher-forced on served tokens, every top-2 set is the
    reference's."""
    from types import SimpleNamespace
    model = tiny_model()
    g = torch.Generator().manual_seed(5)
    labels = [4, 8]
    tokens = torch.randint(0, 64, (2, 16), generator=g)
    sample = [(SimpleNamespace(result=tokens[i].numpy()), {"label": lab})
              for i, lab in enumerate(labels)]
    got = driver.program_routes(model, sample, torch.device("cpu"))
    want = []
    reference(torch.tensor(labels), tokens, 2.0, route_ids=want)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == b.shape == (4, 16, 2)
        assert torch.equal(a.sort(-1).values, b.sort(-1).values)


def test_engine_decode_span_counts_routed_pairs():
    from llamagen_tpu_torch.utils import profiling
    model = tiny_model()
    eng = ServeEngine(model, num_pairs=2, max_new_tokens=16, chunk=4,
                      compute_dtype=torch.float32, cache_dtype=torch.float32)
    eng.submit(1)
    with profiling.tracing():
        eng._admit_and_step()
    decode = [s for s in profiling.spans() if s.name == "engine.decode"]
    assert len(decode) == 4
    assert all(s.counts["routed"] == 4 * 2 and s.counts["rows"] == 4
               for s in decode)


def test_engine_refuses_what_the_model_does_not_run():
    from llamagen_tpu_torch.serve.spec_engine import SpecEngine
    model = tiny_model()
    with pytest.raises(NotImplementedError, match="one device"):
        ServeEngine(model, tp=2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ServeEngine(model, num_pairs=2, max_new_tokens=16,
                    cache_dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="GPT models"):
        SpecEngine(model, model, num_pairs=2, max_new_tokens=16)
    with pytest.raises(ValueError, match="c2i"):
        mla_moe.MLAMoETransformer(MLAMoEConfig(model_type="t2i"),
                                  device="meta")


def test_published_configuration_size_and_widths():
    """DeepSeek-V2-Lite at vocab 16,384: 15.36 B parameters, and every
    width the configuration file copies from the published config.json."""
    cfg = MLA_MOE_CONFIGS["DeepSeek-V2-Lite"]()
    model = mla_moe.MLAMoETransformer(cfg, device="meta",
                                      dtype=torch.bfloat16)
    n = sum(p.numel() for p in model.parameters())
    assert n == 15_356_212_736 == ref.wts.n_params(PUBLISHED)
    assert driver.program_config(PUBLISHED) == cfg
    p = PUBLISHED
    assert (cfg.dim, cfg.n_layer, cfg.n_head, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
            cfg.dense_ffn_dim, cfg.moe_ffn_dim, cfg.n_routed_experts,
            cfg.n_shared_experts, cfg.top_k, cfg.first_k_dense) == (
        2048, 27, 16, 512, 128, 64, 128, 10944, 1408, 64, 2, 6, 1) == (
        p["hidden_size"], p["num_hidden_layers"], p["num_attention_heads"],
        p["kv_lora_rank"], p["qk_nope_head_dim"], p["qk_rope_head_dim"],
        p["v_head_dim"], p["intermediate_size"], p["moe_intermediate_size"],
        p["n_routed_experts"], p["n_shared_experts"],
        p["num_experts_per_tok"], p["first_k_dense_replace"])
    assert cfg.latent_dim == 576 and cfg.qk_head_dim == 192
    # 192 ** -0.5 * (0.1 * 0.707 * ln 40 + 1) ** 2
    assert cfg.softmax_scale == pytest.approx(0.1147214, abs=1e-7)
    assert cfg.softmax_scale == pytest.approx(ref.softmax_scale(p), rel=1e-12)


@pytest.mark.parametrize("k,n", [(2048, 3072), (2048, 576), (2048, 2048),
                                 (2048, 2816), (2816, 2048), (2048, 10944),
                                 (10944, 2048), (2048, 16384)])
def test_k2_geometry_takes_the_dense_shapes(k, n):
    """K2 at 1,024 rows on every dense shape of DeepSeek-V2-Lite: within
    a block's shared memory, the K rows covered by one cluster."""
    geo = int8_geometry(1024, k, n, 132)
    assert geo.smem <= 232448 and (geo.ks - 1) * geo.kb < k <= geo.ks * geo.kb
    assert geo.bc % 8 == 0 and 8 <= geo.bc <= 96


def test_stacked_expert_quantisation_is_per_output_channel():
    g = torch.Generator().manual_seed(4)
    gate, up, down = (torch.randn(3, 8, 16, generator=g),
                      torch.randn(3, 8, 16, generator=g),
                      torch.randn(3, 16, 8, generator=g))
    ex = moe.quantize_experts(gate, up, down)
    q, s = quantize_weight(gate[1].t())
    assert torch.equal(ex.w13_q[1, :, :8], q)
    assert torch.equal(ex.w13_scale[1, :8], s)
    q, s = quantize_weight(down[2].t())
    assert torch.equal(ex.w2_q[2], q) and torch.equal(ex.w2_scale[2], s)


# --- card --------------------------------------------------------------------


@pytest.mark.cuda
def test_k6_equals_its_plain_version_at_the_cell_shapes(cuda):
    """B 1,024 rows (the cell's 512 CFG pairs) at positions spread over
    0-575 of a 640-row cache, 16 heads x 576 (latent 512 + rope 64), bf16:
    outputs within 2 % of the largest (the kernel's probabilities round to
    bf16 before the product, its softmax runs online), the written row
    exact."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b = 1024
    q = torch.randn(b, 16, 576, device=cuda, generator=g).bfloat16()
    new = torch.randn(b, 576, device=cuda, generator=g).bfloat16()
    cache = torch.randn(b, 640, 576, device=cuda, generator=g).bfloat16()
    pos = torch.linspace(0, 575, b, device=cuda).int()
    c_ref = cache.clone()
    want = mla_decode_attention_ref(q, new, c_ref, pos, 512, 0.1147)
    n = mla_decode_attention.launches
    got = mla_decode_attention(q, new, cache, pos, 512, 0.1147)
    torch.cuda.synchronize()
    assert mla_decode_attention.launches == n + 1
    assert torch.equal(cache, c_ref)
    err = (got.float() - want.float()).abs().max()
    assert err <= 0.02 * want.float().abs().max(), err


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2816), (1408, 2048)])
@pytest.mark.parametrize("case", ["routed", "one_expert"])
def test_k7_equals_its_plain_version_at_the_cell_shapes(cuda, k, n, case):
    """64 experts, 6,144 pairs (1,024 rows x top 6) or every pair on one
    expert (63 with none), bf16 x: within a bf16 rounding of the plain
    product (both sum in f32, in another order)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    e, r = 64, 6144
    w_q = torch.randint(-127, 128, (e, k, n), device=cuda, generator=g,
                        dtype=torch.int8)
    w_s = torch.rand(e, n, device=cuda, generator=g) * 1e-3
    x = torch.randn(r, k, device=cuda, generator=g).bfloat16()
    ids = torch.randint(0, e, (r,), device=cuda, generator=g)
    if case == "one_expert":
        ids.fill_(17)
    disp = moe.dispatch(ids[:, None], e)
    want = moe.moe_int8_matmul_ref(x, w_q, w_s, disp.offsets)
    got = moe.moe_int8_matmul(x, w_q, w_s, disp.offsets)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    # a bf16 ulp either side of a rounding boundary, and the f32 sums'
    # order against the cancellation in outputs near zero
    tol = 2 ** -7 * want.abs() + 1e-3 * want.abs().max()
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max()


def _card_config():
    """A small model at K6's widths: 16 heads, latent 512 + rope 64, 8
    experts top 2."""
    return dict(TINY, hidden_size=256, num_attention_heads=16,
                kv_lora_rank=512, qk_rope_head_dim=64, qk_nope_head_dim=32,
                v_head_dim=32, intermediate_size=512,
                moe_intermediate_size=128, vocab_size=512, block_size=36)


def _card_engine(model, graphed, pairs=4):
    eng = ServeEngine(model, num_pairs=pairs, max_new_tokens=36,
                      sampling_params=SamplingParams(cfg_scale=2.0,
                                                     temperature=0.0),
                      chunk=8, compute_dtype=torch.bfloat16,
                      cache_dtype=torch.bfloat16)
    eng._graphs.enabled = graphed
    return eng


@pytest.mark.cuda
def test_graphed_routed_engine_equals_eager_on_the_card(cuda):
    """Greedy tokens, launch counters and expert counts bit for bit
    between the graphed and the eager engine (staggered admissions, slots
    reused); every step but the first is a replay."""
    from llamagen_tpu_torch.ops.quant_matmul import int8_matmul
    model = tiny_model(_card_config(), "cuda", torch.bfloat16)
    out = []
    for graphed in (False, True):
        eng = _card_engine(model, graphed)
        counters = (mla_decode_attention.launches,
                    moe.moe_int8_matmul.launches, int8_matmul.launches)
        tokens = eng.generate([1, 5, 9, 2, 7, 3])
        made = tuple(f.launches - n for f, n in zip(
            (mla_decode_attention, moe.moe_int8_matmul, int8_matmul),
            counters))
        out.append((tokens, made, eng.stats()["moe_expert_rows"],
                    eng.steps_run, eng._graphs.replays))
    (e_tok, e_n, e_rows, steps, _), (g_tok, g_n, g_rows, _, replays) = out
    np.testing.assert_array_equal(g_tok, e_tok)
    # K6 a layer; K7 twice a routed layer; K2: q, kv_a and o a layer, the
    # dense and the two shared SwiGLUs, the head
    assert g_n == e_n == (3 * steps, 2 * 2 * steps, 19 * steps)
    assert g_rows == e_rows
    assert replays == steps - 1


@pytest.mark.cuda
def test_routed_step_reads_nothing_back_to_the_host(cuda):
    """A chunk of routed steps (eager, then captured and replayed) under
    sync debug "error": the router, the dispatch and K7 synchronise
    nothing."""
    model = tiny_model(_card_config(), "cuda", torch.bfloat16)
    eng = _card_engine(model, True)
    for label in (1, 2, 3):
        eng.submit(label)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._admit_and_step()
        eng._admit_and_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng._graphs.replays > 0


@pytest.mark.cuda
def test_gpt_l_engine_launches_are_unchanged(cuda):
    """GPT-L's W8A16 + int8-cache engine still launches 24 K1 and 121 K2 a
    step, and no K6 or K7."""
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.attention import decode_attention
    from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul,
                                                     quantize_gpt_params)
    model = gpt.Transformer(gpt_config("GPT-L", block_size=576), device=cuda,
                            dtype=torch.bfloat16)
    gpt.init_weights(model, 0)
    quantize_gpt_params(model, quantize_head=True)
    eng = ServeEngine(model, num_pairs=4, max_new_tokens=576, chunk=16,
                      cache_dtype=torch.int8)
    fns = (decode_attention, int8_matmul, mla_decode_attention,
           moe.moe_int8_matmul)
    before = [f.launches for f in fns]
    for label in (1, 2):
        eng.submit(label)
    for _ in range(3):
        eng._admit_and_step()
    steps = eng.steps_run
    assert [f.launches - n for f, n in zip(fns, before)] == \
        [24 * steps, 121 * steps, 0, 0]
