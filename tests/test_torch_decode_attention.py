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
                                              decode_attention_ref,
                                              quantize_rows)
from llamagen_tpu_torch.ops.chunk_attention import chunk_split_rows

try:
    import jax.numpy as jnp
    from llamagen_tpu.ops.attention import RECENT, RECENT_INT8
    from llamagen_tpu.ops.attention import decode_attention as jax_attention
    from test_torch_chunk_attention import emulate_bf16_kernel
    from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
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
                seed=0, d=D, s_len=S, emulate_nsplit=None):
    """bf16/f32 cache: JAX cache+window vs the port's cache. With
    `emulate_nsplit` (bf16), the port's output is the emulation of the
    tensor-core kernel (K5's at one query, which serves K1's bf16 entry)
    with that many splits, on the port's cache."""
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.asarray(pos), (B,))
    f, f_kv = n_head * d, kv_heads * d
    q = rng.randn(B, f).astype(np.float32)
    kv_new = rng.randn(B, 2 * f_kv).astype(np.float32)
    hist = rng.randn(B, s_len, 2 * f_kv).astype(np.float32)
    junk = rng.randn(B, s_len, 2 * f_kv).astype(np.float32)
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
    if emulate_nsplit is None:
        out = decode_attention(_t(q, tdt), _t(kv_new, tdt), tc, tpos, n_head,
                               prefix_pad=tpad)
    else:
        cache = port_cache.copy()
        out = emulate_bf16_kernel(
            q[:, None], kv_new[:, None], cache, pos,
            np.zeros(B, np.int32) if prefix_pad is None
            else np.asarray(prefix_pad), n_head, emulate_nsplit)[:, 0]
        tc = torch.tensor(cache)

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


def _int8_state(rng, f_kv, s_len=S):
    kv = rng.randint(-127, 128, size=(B, s_len, 2 * f_kv)).astype(np.int8)
    sc = np.abs(rng.randn(B, s_len, 2)).astype(np.float32) * 0.02 + 1e-3
    sc = np.asarray(jnp.asarray(sc, jnp.bfloat16), np.float32)
    tail = rng.randn(B, RECENT_INT8, 2 * f_kv).astype(np.float32)
    return kv, sc, tail


def _int8_case(pos, n_head=2, kv_heads=2, prefix_pad=None, seed=0, d=D,
               s_len=S):
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.asarray(pos), (B,))
    f, f_kv = n_head * d, kv_heads * d
    q = rng.randn(B, f).astype(np.float32)
    kv_new = rng.randn(B, 2 * f_kv).astype(np.float32)
    kv, sc, tail = _int8_state(rng, f_kv, s_len)
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


def _bf16(x):
    """f32 values rounded to bf16 (exact in both)."""
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16) \
        .float().numpy()


def emulate_int8_kernel(q, kv_new, kv, sc, tail, pos, pad, n_head, nsplit):
    """The order of work of the int8 tensor-core kernel (`attn_mma_kernel`
    on an int8 cache), in f32 numpy: per (batch row, head), the splits of
    `chunk_split_rows` over [pad, pos], 64-row tiles, 16 keys a warp; rows
    below bnd = pos - pos % 32 are int8 levels, their k scale multiplying
    q.k and their v scale p; rows [bnd, pos) come from the tail, row pos
    from kv_new; scores times scale * log2(e), an online softmax in base 2
    per warp, p (times the v scale) rounded to bf16 for the product with v
    (the row sum keeps the f32 p); the states merged at the end. Then the
    tail row and, at pos % 32 == 31, the flush of the 32 rows (row 31 from
    kv_new). Updates kv, sc and tail in place; returns out [B, F] f32."""
    b_n, f = q.shape
    f_kv = kv.shape[2] // 2
    s_len = kv.shape[1]
    d = f // n_head
    rep = n_head // (f_kv // d)
    scale = np.float32(d ** -0.5 * np.log2(np.e))
    out = np.zeros((b_n, f), np.float32)
    for b in range(b_n):
        p0, pd = int(pos[b]), int(pad[b])
        j = p0 % 32
        bnd = p0 - j
        rows = np.concatenate([kv[b, :bnd].astype(np.float32), tail[b, :j],
                               kv_new[b][None],
                               np.zeros((80, 2 * f_kv), np.float32)])
        ones = np.ones(j + 81, np.float32)
        ks = np.concatenate([sc[b, :bnd, 0], ones])
        vs = np.concatenate([sc[b, :bnd, 1], ones])
        for h in range(n_head):
            kvh = h // rep
            k = rows[:, kvh * d:(kvh + 1) * d]
            v = rows[:, f_kv + kvh * d:f_kv + (kvh + 1) * d]
            qh = q[b, h * d:(h + 1) * d]
            states = []
            for lo, hi in chunk_split_rows(p0, pd, 1, s_len, nsplit):
                n_tiles = -(-(hi - lo) // 64) if hi > lo else 0
                for w in range(4):
                    m, l_sum = np.float32(-np.inf), np.float32(0)
                    acc = np.zeros(d, np.float32)
                    for i in range(n_tiles):
                        k0 = lo + 64 * i + 16 * w
                        if k0 >= hi:
                            continue
                        keys = np.arange(k0, k0 + 16)
                        sco = (k[keys] @ qh).astype(np.float32) * ks[keys] \
                            * scale
                        sco = np.where(keys < hi, sco, -np.inf)
                        m_new = max(m, sco.max())
                        m_ref = 0.0 if m_new == -np.inf else m_new
                        alpha = np.exp2(m - m_ref)
                        pr = np.exp2(sco - m_ref).astype(np.float32)
                        l_sum = l_sum * alpha + pr.sum()
                        acc = acc * alpha + _bf16(pr * vs[keys]) @ v[keys]
                        m = m_new
                    states.append((m, l_sum, acc))
            m_all = max(st[0] for st in states)
            l_all, o = np.float32(0), np.zeros(d, np.float32)
            for m, l_sum, acc in states:
                fac = 0.0 if m == -np.inf else np.exp2(m - m_all)
                l_all += l_sum * fac
                o += acc * fac
            out[b, h * d:(h + 1) * d] = o / l_all
        tail[b, j] = kv_new[b]
        if j == 31:
            kq, ksc = quantize_rows(torch.tensor(tail[b, :, :f_kv]))
            vq, vsc = quantize_rows(torch.tensor(tail[b, :, f_kv:]))
            kv[b, bnd:bnd + 32] = torch.cat([kq, vq], -1).numpy()
            sc[b, bnd:bnd + 32] = _bf16(torch.stack([ksc, vsc], -1))
    return out


def _int8_emulation_case(pos, n_head=2, kv_heads=2, prefix_pad=None,
                         nsplit=1, d=D, s_len=S, seed=0):
    """bf16 inputs: the int8 kernel's emulation against the JAX kernel
    (interpret mode); outputs to 4 bf16 ulps of the largest output, the
    int8 cache, scales and tail exactly."""
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.asarray(pos, np.int32), (B,))
    pad = np.zeros(B, np.int32) if prefix_pad is None \
        else np.asarray(prefix_pad, np.int32)
    f, f_kv = n_head * d, kv_heads * d
    q = _bf16(rng.randn(B, f))
    kv_new = _bf16(rng.randn(B, 2 * f_kv))
    kv, sc, tail = _int8_state(rng, f_kv, s_len)
    tail = _bf16(tail)
    jsc = np.concatenate([np.repeat(sc[..., :1], 64, -1),
                          np.repeat(sc[..., 1:], 64, -1)], -1)
    bf = jnp.bfloat16
    jout, jc, jsc_out, jw = jax_attention(
        jnp.asarray(q, bf), jnp.asarray(kv_new, bf), jnp.asarray(tail, bf),
        jnp.asarray(kv), jnp.asarray(pos), n_head,
        prefix_pad=None if prefix_pad is None else jnp.asarray(pad),
        kv_scale=jnp.asarray(jsc, bf), block_s=64, interpret=True)
    ekv, esc, etail = kv.copy(), sc.copy(), tail.copy()
    out = emulate_int8_kernel(q, kv_new, ekv, esc, etail, pos, pad, n_head,
                              nsplit)
    jout = _np(jout)
    tol = 2 ** -6 * max(1.0, np.abs(jout).max())
    np.testing.assert_allclose(_bf16(out), jout, atol=tol, rtol=0)
    np.testing.assert_array_equal(ekv, np.asarray(jc))
    jsc_out = _np(jsc_out)
    np.testing.assert_array_equal(esc[..., 0], jsc_out[..., 0])
    np.testing.assert_array_equal(esc[..., 1], jsc_out[..., 64])
    np.testing.assert_array_equal(etail, _np(jw))


@pytest.mark.parametrize("pos,heads,pad,nsplit", [
    (30, (2, 2), None, 1), (31, (2, 2), None, 3), (63, (2, 2), None, 1),
    (127, (2, 2), None, 2), ([95, 161], (4, 2), [40, 3], 1),
    ([31, 200], (4, 2), [0, 150], 3)],
    ids=["pos30", "pos31-flush", "pos63-flush", "pos127-flush",
         "per-row-pad-gqa", "per-row-pad-gqa-splits"])
def test_int8_kernel_emulation_matches_pallas(pos, heads, pad, nsplit):
    """The int8 kernel's order of work (tiles, warps, splits, p * v scale
    rounded to bf16, the flush from kv_new) against the JAX kernel on the
    same bf16 inputs, within the card tolerance."""
    _int8_emulation_case(pos, *heads, prefix_pad=pad, nsplit=nsplit,
                         seed=sum(np.atleast_1d(pos)))


@pytest.mark.parametrize("pos,nsplit", [(0, 1), (130, 1), (130, 3),
                                        ([5, 200], 2)])
def test_bf16_kernel_emulation_at_one_query_matches_pallas(pos, nsplit):
    """K1's bf16 entry runs K5's tensor-core kernel at one query: its order
    of work against the JAX decode kernel (bf16 cache) within the card
    tolerance, the cache rows written exactly."""
    out, ref = _float_case(pos, dtype="bf16", seed=11,
                           emulate_nsplit=nsplit)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 ** -6 * max(1.0, np.abs(ref).max()))


# GPT-3B's head_dim (100) at its head count (32: F = 3200, the JAX kernel's
# 128-lane rule), B 2, S 64
@pytest.mark.parametrize("pos", [0, 31, 45])
def test_head_dim_100_plain_matches_pallas(pos):
    """The plain version at head_dim 100 against the JAX kernel, f32 and
    int8 caches (caches, scales and tails exactly)."""
    out, ref = _float_case(pos, n_head=32, kv_heads=32, seed=pos, d=100,
                           s_len=64)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    out, ref = _int8_case(pos, n_head=32, kv_heads=32, seed=pos, d=100,
                          s_len=64)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pos,nsplit", [(31, 1), (45, 2), ([12, 63], 1)])
def test_head_dim_100_kernel_emulations_match_pallas(pos, nsplit):
    """The tensor-core kernels' order of work at head_dim 100 against the
    JAX kernel: bf16 cache (K5's kernel at one query) and int8 cache."""
    out, ref = _float_case(pos, n_head=32, kv_heads=32, dtype="bf16",
                           seed=3, d=100, s_len=64, emulate_nsplit=nsplit)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 ** -6 * max(1.0, np.abs(ref).max()))
    _int8_emulation_case(pos, 32, 32, nsplit=nsplit, d=100, s_len=64,
                         seed=5)


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


DTYPE_PAIRS = [("bf16", "bf16"), ("bf16", "int8"), ("bf16", "f32"),
               ("f32", "f32"), ("f32", "bf16"), ("f32", "int8")]


def _card_state(dev, g, b, h, h_kv, d, s, q_dtype, cache):
    """q, kv_new, cache and (int8) scales + tail on the card, and a clone
    of the in-place state for the plain version."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    qdt = dt[q_dtype]
    f, f_kv = h * d, h_kv * d
    q = torch.randn(b, f, generator=g).to(dev, qdt)
    kv_new = torch.randn(b, 2 * f_kv, generator=g).to(dev, qdt)
    if cache != "int8":
        kv = torch.randn(b, s, 2 * f_kv, generator=g).to(dev, dt[cache])
        extra = {}
    else:
        kv = torch.randint(-127, 128, (b, s, 2 * f_kv), generator=g,
                           dtype=torch.int8).to(dev)
        extra = dict(
            kv_scale=(torch.rand(b, s, 2, generator=g) * 0.02 + 1e-3)
            .to(dev, torch.bfloat16),
            tail=torch.randn(b, 32, 2 * f_kv, generator=g).to(dev, qdt))
    return q, kv_new, kv, extra


def _card_compare(q, kv_new, kv, extra, pos, h, pad):
    """The kernel against decode_attention_ref on clones of the state: one
    launch; bf16 outputs within 4 bf16 ulps of the largest output, f32
    within 1e-5 of it (f32 sums in another order; the bf16 tensor-core
    kernels round p to bf16 once more); the cache, scales and tail equal."""
    ref_state = {k: v.clone() for k, v in extra.items()}
    kv_ref = kv.clone()
    before = decode_attention.launches
    out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad, **extra)
    ref = decode_attention_ref(q, kv_new, kv_ref, pos, h, prefix_pad=pad,
                               **ref_state)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    rel = 2 ** -6 if q.dtype == torch.bfloat16 else 1e-5
    tol = rel * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(kv, kv_ref)
    for k in extra:
        assert torch.equal(extra[k], ref_state[k])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache", DTYPE_PAIRS)
@pytest.mark.parametrize("head_dim", [64, 100, 128])
@pytest.mark.parametrize("pos", [0, 31, 32, 575, "per-row"])
def test_cuda_kernel_matches_plain(cuda, q_dtype, cache, head_dim, pos):
    """The CUDA kernels against decode_attention_ref on the card, every
    dtype pair at head_dim 64 (GPT-L: 16 heads), 100 (GPT-3B: 32 heads)
    and 128, at positions around the int8 flush and the cache's end, and
    per-row positions (31, 32, 63, 575 among them) with prefix padding;
    identical in-place cache updates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(head_dim + (pos if pos != "per-row"
                                                  else 7))
    b, s = 16, 640
    h = 32 if head_dim == 100 else 16
    q, kv_new, kv, extra = _card_state(cuda, g, b, h, h, head_dim, s,
                                       q_dtype, cache)
    if pos == "per-row":
        pos = torch.randint(0, 576, (b,), generator=g, dtype=torch.int32)
        pos[:5] = torch.tensor([0, 31, 32, 63, 575])
        pad = torch.minimum(torch.randint(0, 40, (b,), generator=g,
                                          dtype=torch.int32), pos)
        pos, pad = pos.to(cuda), pad.to(cuda)
    else:
        pad = torch.randint(0, min(pos, 3) + 1, (b,), generator=g,
                            dtype=torch.int32).to(cuda)  # pad <= pos
    _card_compare(q, kv_new, kv, extra, pos, h, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache", DTYPE_PAIRS)
@pytest.mark.parametrize("head_dim,h_kv", [(64, 8), (100, 16), (128, 4)],
                         ids=["d64-rep2", "d100-rep2", "d128-rep4"])
def test_cuda_kernel_steps_across_flushes(cuda, q_dtype, cache, head_dim,
                                          h_kv):
    """Consecutive decode steps on one state, GQA, per-row positions that
    cross a flush at different steps (and the prefix padding of each
    row): after every step the output and the whole state match the plain
    version run on its own copy of the state."""
    g = torch.Generator().manual_seed(3 * head_dim + h_kv)
    b, h, s = 8, 16, 128
    q, kv_new, kv, extra = _card_state(cuda, g, b, h, h_kv, head_dim, s,
                                       q_dtype, cache)
    ref_kv = kv.clone()
    ref_extra = {k: v.clone() for k, v in extra.items()}
    pos0 = torch.tensor([26, 27, 28, 29, 30, 31, 58, 90], dtype=torch.int32)
    pad = torch.tensor([0, 3, 0, 29, 0, 1, 40, 0], dtype=torch.int32)
    dt = q.dtype
    for step in range(8):
        pos = (pos0 + step).to(cuda)
        q = torch.randn(q.shape, generator=g).to(cuda, dt)
        kv_new = torch.randn(kv_new.shape, generator=g).to(cuda, dt)
        before = decode_attention.launches
        out = decode_attention(q, kv_new, kv, pos, h, prefix_pad=pad.to(cuda),
                               **extra)
        ref = decode_attention_ref(q, kv_new, ref_kv, pos, h,
                                   prefix_pad=pad.to(cuda), **ref_extra)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        rel = 2 ** -6 if dt == torch.bfloat16 else 1e-5
        tol = rel * max(1.0, ref.float().abs().max().item())
        assert (out.float() - ref.float()).abs().max().item() <= tol, step
        assert torch.equal(kv, ref_kv), step
        for k in extra:
            assert torch.equal(extra[k], ref_extra[k]), (step, k)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_cuda_kernel_serving_engine_steps(cuda, cache):
    """The serving engine's shape: B 128 (64 slot pairs, cond rows over
    uncond rows, both rows of a pair at one position), GPT-L heads (16 x
    64), S 640, bf16 q; slot positions spread as the engine spreads them
    (0, 31, 32, 63, 575 and a finished slot held at 576). Three consecutive
    steps: the active slots advance (31 and 63 flush at the first step, 575
    reaches 576), the finished one stays; each step's output matches the
    plain version run on its own copy of the state, every row to 4 bf16
    ulps of its own largest value, and the whole state matches exactly."""
    g = torch.Generator().manual_seed(32)
    b, h, s = 128, 16, 640
    q, kv_new, kv, extra = _card_state(cuda, g, b, h, h, 64, s, "bf16", cache)
    ref_kv = kv.clone()
    ref_extra = {k: v.clone() for k, v in extra.items()}
    slot_pos = torch.randint(1, 575, (b // 2,), generator=g,
                             dtype=torch.int32)
    slot_pos[:6] = torch.tensor([0, 31, 32, 63, 575, 576])
    for step in range(3):
        pos = torch.cat([slot_pos, slot_pos]).to(cuda)
        q = torch.randn(q.shape, generator=g).to(cuda, torch.bfloat16)
        kv_new = torch.randn(kv_new.shape, generator=g).to(cuda,
                                                           torch.bfloat16)
        before = decode_attention.launches
        out = decode_attention(q, kv_new, kv, pos, h, **extra)
        ref = decode_attention_ref(q, kv_new, ref_kv, pos, h, **ref_extra)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        tol = 2 ** -6 * ref.float().abs().amax(-1, keepdim=True) \
            .clamp_min(2 ** -14)
        ratio = ((out.float() - ref.float()).abs() / tol).max().item()
        assert ratio <= 1.0, (step, ratio)
        assert torch.equal(kv, ref_kv), step
        for k in extra:
            assert torch.equal(extra[k], ref_extra[k]), (step, k)
        slot_pos = torch.where(slot_pos < 576, slot_pos + 1, slot_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 96, 80])
def test_cuda_kernel_raises_on_other_head_dims(cuda, head_dim):
    """CUDA tensors at a head_dim the kernels do not take raise, in every
    entry; nothing falls back to the plain version."""
    for q_dtype, cache in DTYPE_PAIRS:
        q, kv_new, kv, extra = _card_state(
            cuda, torch.Generator().manual_seed(0), 2, 4, 4, head_dim, 64,
            q_dtype, cache)
        before = kv.clone()
        with pytest.raises(ValueError, match=f"head_dim {head_dim}"):
            decode_attention(q, kv_new, kv, 5, 4, **extra)
        assert torch.equal(kv, before)
