"""Port decode attention (llamagen_tpu_torch.ops.attention) against the JAX
Pallas kernel (interpret mode on the CPU), and the CUDA kernel against its
plain version on the card (`-m cuda`; that machine has no JAX, so run
these files there with `python -m pytest --noconftest -m cuda`).

The JAX kernel keeps the newest rows in a recent window (8 rows for
bf16/f32 caches, 32 for int8); the port writes bf16/f32 rows straight into
the cache and keeps a 32-row exact tail for int8. Each case builds both
states from one numpy history and compares the output (2e-5 at f32) and the
caches, scales and tail/window exactly.
"""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops.attention import (decode_attention,
                                              decode_attention_ref)

try:
    import jax.numpy as jnp
    from llamagen_tpu.ops.attention import RECENT, RECENT_INT8
    from llamagen_tpu.ops.attention import decode_attention as jax_attention
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jnp = jax_attention = RECENT = RECENT_INT8 = None

B, S, D = 2, 256, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernel")
    return torch.device("cuda")


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _float_case(pos, n_head=2, kv_heads=2, prefix_pad=None, dtype="f32",
                seed=0):
    """bf16/f32 cache: JAX cache+window vs the port's cache."""
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.asarray(pos), (B,))
    f, f_kv = n_head * D, kv_heads * D
    q = rng.randn(B, f).astype(np.float32)
    kv_new = rng.randn(B, 2 * f_kv).astype(np.float32)
    hist = rng.randn(B, S, 2 * f_kv).astype(np.float32)
    junk = rng.randn(B, S, 2 * f_kv).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    if dtype == "bf16":  # round the inputs once so both sides see the same
        q, kv_new, hist, junk = (np.asarray(jnp.asarray(a, jnp.bfloat16),
                                            np.float32)
                                 for a in (q, kv_new, hist, junk))

    jcache, port_cache = junk.copy(), junk.copy()
    window = rng.randn(B, RECENT, 2 * f_kv).astype(np.float32)
    window = np.array(jnp.asarray(window, jdt), np.float32)
    for b in range(B):
        bnd = pos[b] // RECENT * RECENT
        jcache[b, :bnd] = hist[b, :bnd]
        window[b, :pos[b] - bnd] = hist[b, bnd:pos[b]]
        port_cache[b, :pos[b]] = hist[b, :pos[b]]

    jpad = None if prefix_pad is None else jnp.asarray(prefix_pad, jnp.int32)
    jout, jc, jw = jax_attention(
        jnp.asarray(q, jdt), jnp.asarray(kv_new, jdt), jnp.asarray(window, jdt),
        jnp.asarray(jcache, jdt), jnp.asarray(pos, jnp.int32), n_head,
        prefix_pad=jpad, block_s=64, interpret=True)

    tc = _t(port_cache, tdt)
    tpos = torch.tensor(pos, dtype=torch.int32) if pos.ndim and \
        len(set(pos.tolist())) > 1 else int(pos[0])
    tpad = None if prefix_pad is None else torch.tensor(prefix_pad,
                                                        dtype=torch.int32)
    out = decode_attention(_t(q, tdt), _t(kv_new, tdt), tc, tpos, n_head,
                           prefix_pad=tpad)

    jc, jw = _np(jc), _np(jw)
    for b in range(B):
        bnd = pos[b] // RECENT * RECENT
        np.testing.assert_array_equal(_np(tc)[b, :bnd], jc[b, :bnd])
        np.testing.assert_array_equal(_np(tc)[b, bnd:pos[b] + 1],
                                      jw[b, :pos[b] - bnd + 1])
        np.testing.assert_array_equal(_np(tc)[b, pos[b] + 1:],
                                      port_cache[b, pos[b] + 1:])
    return _np(out), _np(jout)


@pytest.mark.parametrize("pos", [0, 1, 7, 100, 127, 128, 200, 255])
def test_f32_cache_matches_pallas(pos):
    out, ref = _float_case(pos)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_bf16_cache_matches_pallas():
    # bf16 output: both round the same f32 result once; 1e-2 is ~2 bf16
    # ulps at |out| ~ 1 (the f32 sums run in different orders)
    out, ref = _float_case(130, dtype="bf16", seed=2)
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)


def test_per_slot_positions_and_prefix_pad():
    out, ref = _float_case([5, 140], prefix_pad=[3, 70], seed=3)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pos", [7, 129])
def test_gqa_matches_pallas(pos):
    out, ref = _float_case(pos, n_head=4, kv_heads=2, seed=4)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def _int8_state(rng, f_kv):
    kv = rng.randint(-127, 128, size=(B, S, 2 * f_kv)).astype(np.int8)
    sc = np.abs(rng.randn(B, S, 2)).astype(np.float32) * 0.02 + 1e-3
    sc = np.asarray(jnp.asarray(sc, jnp.bfloat16), np.float32)
    tail = rng.randn(B, RECENT_INT8, 2 * f_kv).astype(np.float32)
    return kv, sc, tail


def _int8_case(pos, n_head=2, kv_heads=2, prefix_pad=None, seed=0):
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.asarray(pos), (B,))
    f, f_kv = n_head * D, kv_heads * D
    q = rng.randn(B, f).astype(np.float32)
    kv_new = rng.randn(B, 2 * f_kv).astype(np.float32)
    kv, sc, tail = _int8_state(rng, f_kv)
    jsc = np.concatenate([np.repeat(sc[..., :1], 64, -1),
                          np.repeat(sc[..., 1:], 64, -1)], -1)

    jpad = None if prefix_pad is None else jnp.asarray(prefix_pad, jnp.int32)
    jout, jc, jsc_out, jw = jax_attention(
        jnp.asarray(q), jnp.asarray(kv_new), jnp.asarray(tail),
        jnp.asarray(kv), jnp.asarray(pos, jnp.int32), n_head,
        prefix_pad=jpad, kv_scale=jnp.asarray(jsc, jnp.bfloat16),
        block_s=64, interpret=True)

    tkv, tsc, ttail = torch.tensor(kv), _t(sc, torch.bfloat16), _t(tail)
    tpos = torch.tensor(pos, dtype=torch.int32)
    tpad = None if prefix_pad is None else torch.tensor(prefix_pad,
                                                        dtype=torch.int32)
    out = decode_attention(_t(q), _t(kv_new), tkv, tpos, n_head,
                           prefix_pad=tpad, kv_scale=tsc, tail=ttail)

    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jc))
    jsc_out = _np(jsc_out)
    np.testing.assert_array_equal(_np(tsc)[..., 0], jsc_out[..., 0])
    np.testing.assert_array_equal(_np(tsc)[..., 1], jsc_out[..., 64])
    np.testing.assert_array_equal(ttail.numpy(), _np(jw))
    return _np(out), _np(jout)


@pytest.mark.parametrize("pos", [32, 62, 63, 126, 127, 128, 255])
def test_int8_cache_around_flush_matches_pallas(pos):
    """pos % 32 in {0, 30, 31}, across 128 and at the cache's end; the
    flush at pos % 32 == 31 must write the same int8 rows and bf16 scales."""
    out, ref = _int8_case(pos, seed=pos)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_int8_per_slot_gqa_prefix_pad():
    out, ref = _int8_case([95, 161], n_head=4, kv_heads=2,
                          prefix_pad=[40, 3], seed=7)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("bad", ["int8_rows", "no_tail", "kv_new", "pos"])
def test_rejects_malformed_arguments(bad):
    """The checks run before any write, on either device: an int8 flush
    writes 32 whole rows, so the cache length must be a multiple of 32."""
    s = 100 if bad == "int8_rows" else 128
    q, kv_new = torch.zeros(B, 2 * D), torch.zeros(B, 4 * D)
    kv = torch.zeros(B, s, 4 * D, dtype=torch.int8)
    extra = dict(kv_scale=torch.ones(B, s, 2, dtype=torch.bfloat16),
                 tail=torch.zeros(B, 32, 4 * D))
    pos = 5
    if bad == "no_tail":
        del extra["tail"]
    elif bad == "kv_new":
        kv_new = torch.zeros(B, 2 * D)
    elif bad == "pos":
        pos = s
    with pytest.raises(ValueError):
        decode_attention(q, kv_new, kv, pos, 2, **extra)
    assert not kv.any() and not extra.get("tail", kv).any()


def test_cpu_wrapper_does_not_count_launches():
    before = decode_attention.launches
    _float_case(9, seed=1)
    assert decode_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache", [
    ("bf16", "bf16"), ("bf16", "int8"), ("bf16", "f32"), ("f32", "f32"),
    ("f32", "bf16"), ("f32", "int8")])
@pytest.mark.parametrize("pos", [1, 31, 128, 575])
def test_cuda_kernel_matches_plain(cuda, q_dtype, cache, pos):
    """The CUDA kernel against decode_attention_ref on the card (GPT-L
    decode shapes, every dtype pair it is built for), with identical
    in-place cache updates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    qdt = dt[q_dtype]
    g = torch.Generator().manual_seed(pos)
    b, h, s = 16, 16, 640
    f = h * D
    q = torch.randn(b, f, generator=g).to(cuda, qdt)
    kv_new = torch.randn(b, 2 * f, generator=g).to(cuda, qdt)
    pad = torch.randint(0, min(pos, 3) + 1, (b,), generator=g,
                        dtype=torch.int32).to(cuda)  # pad <= pos
    if cache != "int8":
        kv = torch.randn(b, s, 2 * f, generator=g).to(cuda, dt[cache])
        extra = {}
    else:
        kv = torch.randint(-127, 128, (b, s, 2 * f), generator=g,
                           dtype=torch.int8).to(cuda)
        extra = dict(
            kv_scale=(torch.rand(b, s, 2, generator=g) * 0.02 + 1e-3)
            .to(cuda, torch.bfloat16),
            tail=torch.randn(b, 32, 2 * f, generator=g).to(cuda, qdt))
    ref_state = {k: v.clone() for k, v in extra.items()}
    kv_ref = kv.clone()
    out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad, **extra)
    ref = decode_attention_ref(q, kv_new, kv_ref, pos, h, prefix_pad=pad,
                               **ref_state)
    torch.cuda.synchronize()
    # f32 sums in another order: bf16 outputs within 4 bf16 ulps of the
    # largest output, f32 outputs within 1e-5 of it
    rel = 2 ** -6 if qdt == torch.bfloat16 else 1e-5
    tol = rel * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(kv, kv_ref)
    for k in extra:
        assert torch.equal(extra[k], ref_state[k])
