"""Port W4A16 (llamagen_tpu_torch.ops.w4_matmul) against the JAX package:
`pack_w4` bit for bit, `w4_dequant`, the plain product against the Pallas
`w4_matmul` (interpret mode on the CPU), and a W4 GPT-nano's decode logits
and greedy tokens; then the CUDA kernel against its plain version on the
card (`-m cuda`; that machine has no JAX, so run this file there with
`python -m pytest --noconftest -m cuda`).

Tolerances: f32 outputs 1e-5 of the largest output (the same f32 products
summed in another order); bf16 outputs one bf16 ulp (2^-7) of the largest
output; decode logits 2e-4 (the PARITY.md GPT logits tolerance); greedy
tokens exactly.
"""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops import w4_matmul as w4
from llamagen_tpu_torch.ops.quant_matmul import matmul_any

try:
    import jax
    import jax.numpy as jnp
    from llamagen_tpu.models import gpt as jgpt
    from llamagen_tpu.ops import w4_matmul as jw4
    from llamagen_tpu.ops.generate import generate as jgenerate
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.ops.generate import generate
    from test_torch_gpt import jax_config, make_pair
    from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jax = None

# (K, N, per_channel, group_size): ragged last segment at K/2 = 160
PACKINGS = [(256, 384, True, 128), (256, 384, False, 64),
            (512, 256, False, 128), (320, 256, False, 128)]
PACK_IDS = ["per-channel", "g64", "g128", "g128-ragged"]


def _weights(k, n, seed):
    w = (np.random.RandomState(seed).randn(k, n) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel keeps scale 1e-12
    return w


def _torch_pack(w, per_channel, group_size):
    return w4.pack_w4(torch.tensor(w), per_channel=per_channel,
                      group_size=group_size)


@pytest.mark.parametrize("k,n,per_channel,group", PACKINGS, ids=PACK_IDS)
def test_pack_w4_bit_identical_to_jax(k, n, per_channel, group):
    w = _weights(k, n, k + n)
    blocks, scales = _torch_pack(w, per_channel, group)
    jb, js = jw4.pack_w4(jnp.asarray(w), per_channel=per_channel,
                         group_size=group)
    assert blocks.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per-channel", "grouped"])
def test_pack_w4_levels_and_dequant_match_jax(per_channel):
    rng = np.random.RandomState(5)
    k, n = 384, 256  # K/2 = 192: one full and one ragged 128-row group
    q = rng.randint(-8, 8, size=(k, n))
    rows = 1 if per_channel else 4
    sc = (rng.rand(rows, n) * 0.01 + 1e-3).astype(np.float32)
    blocks, scales = w4.pack_w4_levels(torch.tensor(q), torch.tensor(sc))
    jb, js = jw4.pack_w4_levels(jnp.asarray(q), jnp.asarray(sc))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        w4.w4_dequant(blocks, scales).numpy(),
        np.asarray(jw4.w4_dequant(jb, js)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,per_channel,group", PACKINGS, ids=PACK_IDS)
def test_w4_matmul_ref_matches_pallas(k, n, per_channel, group, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    w = _weights(k, n, k * n)
    x = np.random.RandomState(k).randn(16, k).astype(np.float32)
    blocks, scales = _torch_pack(w, per_channel, group)
    ref = np.asarray(jax.jit(lambda a, b, c: jw4.w4_matmul(
        a, b, c, interpret=True))(jnp.asarray(x, jdt), jnp.asarray(
            blocks.numpy()), jnp.asarray(scales.numpy())).astype(jnp.float32))
    out = w4.w4_matmul_ref(torch.tensor(x).to(tdt), blocks, scales)
    assert out.dtype == tdt
    rel = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = w4.w4_matmul.launches
    same = w4.w4_matmul(torch.tensor(x).to(tdt), blocks, scales)
    assert torch.equal(same, out) and w4.w4_matmul.launches == before


def emulate_kernel(x, blocks, scales, sms=132):
    """The CUDA kernel's order of sums, in f32 torch: x rounded to bf16; for
    each rank of the cluster (`w4_geometry`), its packed rows in 16-row
    steps, each step's 16 products summed and added to the accumulator of
    its group and half (per channel: to the rank's total), each group's two
    accumulators times their scales added to the rank's total; the ranks'
    partials summed in rank order; per channel the scale once; one
    rounding to x's dtype."""
    nb, k2, bn = blocks.shape
    n = nb * bn
    seg = w4._seg_rows(k2, scales.shape[1])
    geo = w4.w4_geometry(x.shape[0], k2, n, bn, seg, sms)
    xb = x.to(torch.bfloat16).float()
    lv = w4._levels(blocks).permute(1, 0, 2).reshape(2 * k2, n)
    sc = scales.permute(1, 0, 2).reshape(scales.shape[1], n)
    step_rows = seg or geo.kb
    total = torch.zeros(x.shape[0], n)
    for rank in range(geo.ks):
        k0, k1 = rank * geo.kb, min(k2, (rank + 1) * geo.kb)
        part = torch.zeros(x.shape[0], n)
        for g0 in range(k0, k1, step_rows):
            acc = [torch.zeros(x.shape[0], n) for _ in range(2)]
            for s0 in range(g0, min(k1, g0 + step_rows), 16):
                for h in range(2):
                    rows = slice(h * k2 + s0, h * k2 + min(k1, s0 + 16))
                    if seg:
                        acc[h] = acc[h] + xb[:, rows] @ lv[rows]
                    else:
                        part = part + xb[:, rows] @ lv[rows]
            if seg:
                nseg = scales.shape[1] // 2
                part = part + (acc[0] * sc[g0 // seg]
                               + acc[1] * sc[nseg + g0 // seg])
        total = total + part
    if not seg:
        total = total * sc[0]
    return total.to(x.dtype)


@pytest.mark.parametrize("b", [1, 16, 17, 80])
@pytest.mark.parametrize("k,n,per_channel,group", PACKINGS, ids=PACK_IDS)
def test_kernel_order_of_sums_matches_pallas(k, n, per_channel, group, b):
    """The kernel's order of sums (emulated on the CPU) against the Pallas
    kernel in interpret mode, f32 x: 1e-5 of the largest output, the f32
    tolerance the card holds the kernel to."""
    w = _weights(k, n, k + n + b)
    x = np.random.RandomState(b).randn(b, k).astype(np.float32)
    blocks, scales = _torch_pack(w, per_channel, group)
    ref = np.asarray(jax.jit(lambda a, bl, sc: jw4.w4_matmul(
        a, bl, sc, interpret=True))(jnp.asarray(x), jnp.asarray(
            blocks.numpy()), jnp.asarray(scales.numpy())))
    # a cluster of several ranks at these small N: few SMs to fill
    out = emulate_kernel(torch.tensor(x), blocks, scales, sms=16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


GPT_L = {"wqkv": (1024, 3072), "wo": (1024, 1024), "w1": (1024, 2816),
         "w2": (2816, 1024)}


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["g128", "per-channel"])
@pytest.mark.parametrize("name", list(GPT_L) + ["ragged"])
def test_kernel_geometry(name, per_channel):
    """The launch geometry at B 1..320 for every GPT-L shape (w3 is w1's)
    and the ragged K = 320: the column tiles and the cluster's packed-row
    ranges cover N and K/2 exactly, every 16-row step lies inside one
    group, at most 8 blocks a cluster, batch passes of a multiple of 8
    rows (<= 96) that cover B, shared memory <= 227 KB."""
    k, n = GPT_L.get(name, (320, 256))
    k2, bn = k // 2, w4._pick_bn(n)
    seg = None if per_channel else 128
    for b in range(1, 321):
        geo = w4.w4_geometry(b, k2, n, bn, seg, 132)
        assert n % 64 == 0  # the grid's n // 64 column tiles cover N
        assert 1 <= geo.ks <= 8 and geo.kb % 16 == 0
        assert (geo.ks - 1) * geo.kb < k2 <= geo.ks * geo.kb
        if seg:
            assert geo.kb % seg == 0
            for s0 in range(0, k2, 16):  # a step's rows share one group
                assert s0 // seg == (min(k2, s0 + 16) - 1) // seg
        assert geo.bc % 8 == 0 and 8 <= geo.bc <= 96
        assert -(-b // geo.bc) * geo.bc >= b
        assert geo.smem <= 232448


def test_matmul_any_w4_branches_match_jax():
    """Rank-2 x takes the W4 product (x rounded to bf16), rank-3 x the
    plain dequantised product (x not rounded), as in JAX."""
    w = _weights(256, 384, 7)
    blocks, scales = _torch_pack(w, False, 128)
    p = {"w_w4b": jnp.asarray(blocks.numpy()),
         "w_w4s": jnp.asarray(scales.numpy())}
    rng = np.random.RandomState(8)
    for shape in ((6, 256), (2, 3, 256)):
        x = rng.randn(*shape).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a: jw4_matmul_any(p, a))(
            jnp.asarray(x)))
        out = matmul_any(torch.tensor(x), w4_blocks=blocks, w4_scales=scales)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def jw4_matmul_any(p, x):
    from llamagen_tpu.ops.quant_matmul import matmul_any as jmatmul_any
    return jmatmul_any(p, "w", x)


W4NANO = None if jax is None else gpt_config("GPT-nano", block_size=64,
                                             vocab_size=512)


def _w4_pair(per_channel):
    params, model = make_pair(W4NANO)
    return (jw4.quantize_gpt_params_w4k(params, per_channel=per_channel),
            w4.quantize_gpt_params_w4k(model, per_channel=per_channel))


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["g128", "per-channel"])
def test_w4_decode_logits_match_jax(per_channel):
    """Prefill (rank 3: the dequantised fallback) and teacher-forced decode
    steps (rank 2: the W4 product) at f32 against JAX."""
    params, model = _w4_pair(per_channel)
    cfg, jcfg = W4NANO, jax_config(W4NANO)
    labels = np.array([3, 7])
    jcache = jgpt.init_cache(jcfg, 2, 64, dtype=jnp.float32)
    jl, jcache = jgpt.prefill(params, jcfg, jnp.asarray(labels), jcache,
                              compute_dtype=jnp.float32)
    cache = gpt.init_cache(cfg, 2, 64, torch.float32, "cpu")
    logits = gpt.prefill(model, torch.tensor(labels), cache, torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)
    step = jax.jit(lambda tok, pos, c: jgpt.decode_step(
        params, jcfg, tok, pos, c, compute_dtype=jnp.float32))
    rng = np.random.RandomState(1)
    for pos in range(1, 6):
        tok = rng.randint(0, cfg.vocab_size, size=(2,))
        jl, jcache = step(jnp.asarray(tok), jnp.int32(pos), jcache)
        logits = gpt.decode_step(model, torch.tensor(tok), pos, cache,
                                 compute_dtype=torch.float32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=0, err_msg=f"pos {pos}")


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["g128", "per-channel"])
def test_greedy_w4_generate_matches_jax(per_channel):
    params, model = _w4_pair(per_channel)
    labels = np.array([3, 7])
    kw = dict(max_new_tokens=32, cfg_scale=2.0, sample_logits=False)
    jtok = jgenerate(params, jax.random.PRNGKey(0), jnp.asarray(labels),
                     cfg=jax_config(W4NANO), compute_dtype=jnp.float32,
                     cache_dtype=jnp.float32, **kw)
    tok = generate(model, torch.tensor(labels), compute_dtype=torch.float32,
                   cache_dtype=torch.float32, **kw)
    assert len(np.unique(np.asarray(jtok))) > 4  # a real comparison
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16, 17, 80, 81, 320])
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["g128", "per-channel"])
@pytest.mark.parametrize("k,n", [(1024, 3072), (1024, 1024), (2816, 1024),
                                 (1024, 2816), (320, 256)],
                         ids=["wqkv", "wo", "w2", "w1", "ragged"])
def test_cuda_kernel_matches_plain(cuda, b, k, n, per_channel):
    """The CUDA kernel against w4_matmul_ref on the card, at every GPT-L
    layer shape and the ragged K = 320, batch rows across the kernel's
    8-row tiles and 96-row passes: bf16 to one output ulp, f32 to 1e-5 of
    the largest output (sums in another order); one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(k + n + b)
    blocks, scales = w4.pack_w4(
        torch.randn(k, n, generator=g, device=cuda) * 0.02,
        per_channel=per_channel)
    x = torch.randn(b, k, generator=g, device=cuda)
    for dtype, rel in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
        before = w4.w4_matmul.launches
        out = w4.w4_matmul(x.to(dtype), blocks, scales)
        ref = w4.w4_matmul_ref(x.to(dtype), blocks, scales)
        torch.cuda.synchronize()
        assert out.dtype == dtype and w4.w4_matmul.launches == before + 1
        tol = rel * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda):
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    blocks, scales = w4.pack_w4(torch.randn(256, 256, device=cuda))
    with pytest.raises(TypeError, match="bf16 or f32"):
        w4.w4_matmul(torch.zeros(4, 256, device=cuda, dtype=torch.float16),
                     blocks, scales)
    with pytest.raises(ValueError, match="one CUDA device"):
        w4.w4_matmul(torch.zeros(4, 256, device=cuda), blocks.cpu(), scales)
