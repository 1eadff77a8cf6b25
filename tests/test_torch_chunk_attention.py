"""Port chunk decode attention (llamagen_tpu_torch.ops.chunk_attention)
against the JAX Pallas `chunk_decode_attention` (interpret mode on the CPU)
on the cases of tests/test_chunk_attention.py: chunk sizes and positions
(epoch-boundary crossings, C = 1 draft steps, a full 8-row chunk), prefix
padding, a backward position jump across calls, GQA rep 2 and 4, and early
positions. Then the CUDA kernel against its plain version on the card
(`-m cuda`; run there with `python -m pytest --noconftest -m cuda`).

Tolerances: outputs 2e-5 (the JAX test's own against its einsum oracle:
f32 sums in another order); cache rows below pos + C exactly (rows at and
above pos + C are scratch the JAX kernel may rewrite).
"""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops.chunk_attention import (
    _smem_bytes, chunk_decode_attention, chunk_decode_attention_ref,
    chunk_geometry, chunk_split_rows)

try:
    import jax.numpy as jnp
    from llamagen_tpu.ops.chunk_attention import \
        chunk_decode_attention as jchunk
    from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jnp = None


def _inputs(rng, b, c, smax, n_head, head_dim, kv_heads):
    f, f_kv = n_head * head_dim, kv_heads * head_dim
    return (rng.randn(b, c, f).astype(np.float32),
            rng.randn(b, c, 2 * f_kv).astype(np.float32),
            rng.randn(b, smax, 2 * f_kv).astype(np.float32))  # finite garbage


def _both(q, kv_new, cache, pos, n_head, pad=None):
    """(port out, port cache, JAX out, JAX cache); the port runs on a copy
    of `cache` in place."""
    jout, jcache = jchunk(jnp.asarray(q), jnp.asarray(kv_new),
                          jnp.asarray(cache), jnp.asarray(pos), n_head,
                          prefix_pad=None if pad is None
                          else jnp.asarray(pad), interpret=True)
    tcache = torch.tensor(cache)
    out = chunk_decode_attention(
        torch.tensor(q), torch.tensor(kv_new), tcache, torch.tensor(pos),
        n_head, prefix_pad=None if pad is None else torch.tensor(pad))
    return out.numpy(), tcache.numpy(), np.asarray(jout), np.asarray(jcache)


def _compare(out, cache, jout, jcache, pos, c):
    np.testing.assert_allclose(out, jout, atol=2e-5, rtol=2e-5)
    for b, p in enumerate(pos):
        np.testing.assert_array_equal(cache[b, :p + c], jcache[b, :p + c])


@pytest.mark.parametrize("c,pos_list", [
    (5, [37, 12]),   # mid-tile, no boundary crossing for row 0
    (5, [6, 30]),    # row 0 crosses the JAX kernel's 8-row tile boundary
    (1, [45, 3]),    # a draft step's single-token chunk
    (8, [16, 23]),   # a full 8-row chunk
])
def test_matches_jax(c, pos_list):
    rng = np.random.RandomState(0)
    pos = np.asarray(pos_list, np.int32)
    q, kv_new, cache = _inputs(rng, 2, c, 64, 4, 32, 4)
    _compare(*_both(q, kv_new, cache, pos, 4), pos, c)


def test_prefix_pad():
    rng = np.random.RandomState(1)
    pos, pad = np.asarray([20, 11], np.int32), np.asarray([5, 0], np.int32)
    q, kv_new, cache = _inputs(rng, 2, 4, 64, 4, 32, 4)
    _compare(*_both(q, kv_new, cache, pos, 4, pad), pos, 4)


def test_backward_position_jump_across_calls():
    """A rejection moves pos backward over rows an earlier chunk wrote:
    chunk of 5 at 14, then (one token committed) a chunk at 15."""
    rng = np.random.RandomState(2)
    q1, kv1, cache = _inputs(rng, 1, 5, 64, 4, 32, 4)
    pos1, pos2 = np.asarray([14], np.int32), np.asarray([15], np.int32)
    _, cache1, _, jcache1 = _both(q1, kv1, cache, pos1, 4)
    q2, kv2, _ = _inputs(rng, 1, 5, 64, 4, 32, 4)
    # both second calls start from the JAX cache, so they see the same rows
    # at and above pos1 + C (scratch the JAX kernel may have rewritten)
    np.testing.assert_array_equal(cache1[:, :19], jcache1[:, :19])
    _compare(*_both(q2, kv2, jcache1, pos2, 4), pos2, 5)


@pytest.mark.parametrize("rep", [2, 4])
def test_gqa_matches_jax(rep):
    rng = np.random.RandomState(4)
    pos = np.asarray([37, 14], np.int32)
    q, kv_new, cache = _inputs(rng, 2, 5, 64, 8, 64, 8 // rep)
    _compare(*_both(q, kv_new, cache, pos, 8), pos, 5)


def test_early_positions():
    """pos 0 and 5: nothing below the first tile, only the chunk's own and
    the first rows."""
    rng = np.random.RandomState(3)
    pos = np.asarray([0, 5], np.int32)
    q, kv_new, cache = _inputs(rng, 2, 3, 32, 4, 32, 4)
    _compare(*_both(q, kv_new, cache, pos, 4), pos, 3)


@pytest.mark.parametrize("c,pos_list", [(5, [37, 12]), (1, [63, 0])])
def test_head_dim_100_matches_jax(c, pos_list):
    """GPT-3B's head_dim (100) at its head count (F 3200, the JAX kernel's
    128-lane rule): the plain version against the JAX kernel."""
    rng = np.random.RandomState(6)
    pos = np.asarray(pos_list, np.int32)
    q, kv_new, cache = _inputs(rng, 2, c, 64, 32, 100, 32)
    _compare(*_both(q, kv_new, cache, pos, 32), pos, c)


def test_refuses_int8_caches_and_overflow():
    q = torch.zeros(1, 2, 128)
    with pytest.raises(TypeError, match="int8"):
        chunk_decode_attention(q, torch.zeros(1, 2, 256),
                               torch.zeros(1, 16, 256, dtype=torch.int8), 0,
                               4)
    with pytest.raises(ValueError, match="outside the cache"):
        chunk_decode_attention(q, torch.zeros(1, 2, 256),
                               torch.zeros(1, 16, 256), 15, 4)


def _bf16(x):
    """f32 values rounded to bf16 (exact in both)."""
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


def emulate_bf16_kernel(q, kv_new, cache, pos, pad, n_head, nsplit):
    """The order of work of the bf16 kernel (`chunk_mma_kernel`), in f32
    numpy: the insert, then per (batch row, head) the splits of
    `chunk_split_rows`, 64-row tiles, 16 keys a warp; rows >= pos taken
    from kv_new; scores times scale * log2(e), an online softmax in base 2
    per warp, p rounded to bf16 for the product with v (the row sum keeps
    the f32 p); the states merged at the end. Updates `cache` in place and
    returns out [B, C, F] (f32)."""
    b_n, c, f = q.shape
    s_len, f_kv = cache.shape[1], cache.shape[2] // 2
    d = f // n_head
    rep = n_head // (f_kv // d)
    scale = d ** -0.5 * np.log2(np.e)
    out = np.zeros((b_n, c, f), np.float32)
    for b in range(b_n):
        p0, pd = int(pos[b]), int(pad[b])
        cache[b, p0:p0 + c] = kv_new[b, :max(0, min(c, s_len - p0))]
        rows = np.concatenate([cache[b], np.zeros((80, 2 * f_kv),
                                                  np.float32)])
        for h in range(n_head):
            kvh = h // rep
            k = rows[:, kvh * d:(kvh + 1) * d]
            v = rows[:, f_kv + kvh * d:f_kv + (kvh + 1) * d]
            qh = q[b, :, h * d:(h + 1) * d]
            states = []
            for lo, hi in chunk_split_rows(p0, pd, c, s_len, nsplit):
                n_tiles = -(-(hi - lo) // 64) if hi > lo else 0
                for w in range(4):
                    m = np.full(c, -np.inf, np.float32)
                    l_sum = np.zeros(c, np.float32)
                    acc = np.zeros((c, d), np.float32)
                    for i in range(n_tiles):
                        k0 = lo + 64 * i + 16 * w
                        if k0 >= hi:
                            continue
                        keys = np.arange(k0, k0 + 16)
                        sc = (qh @ k[keys].T).astype(np.float32) * scale
                        ok = (keys[None, :] < hi) & \
                            (keys[None, :] <= p0 + np.arange(c)[:, None])
                        sc = np.where(ok, sc, -np.inf)
                        m_new = np.maximum(m, sc.max(axis=1))
                        m_ref = np.where(m_new == -np.inf, 0.0, m_new)
                        alpha = np.exp2(m - m_ref)
                        pr = np.exp2(sc - m_ref[:, None])
                        l_sum = l_sum * alpha + pr.sum(axis=1)
                        acc = acc * alpha[:, None] + _bf16(pr) @ v[keys]
                        m = m_new
                    states.append((m, l_sum, acc))
            m_all = np.max([st[0] for st in states], axis=0)
            l_all = np.zeros(c, np.float32)
            o = np.zeros((c, d), np.float32)
            for m, l_sum, acc in states:
                fac = np.where(m == -np.inf, 0.0, np.exp2(m - m_all))
                l_all += l_sum * fac
                o += acc * fac[:, None]
            out[b, :, h * d:(h + 1) * d] = o / l_all[:, None]
    return out


def _bf16_inputs(rng, b, c, smax, n_head, head_dim, kv_heads):
    return tuple(_bf16(a) for a in _inputs(rng, b, c, smax, n_head,
                                            head_dim, kv_heads))


def _jax_bf16(q, kv_new, cache, pos, pad, n_head):
    out, jcache = jchunk(*(jnp.asarray(a, jnp.bfloat16)
                           for a in (q, kv_new, cache)), jnp.asarray(pos),
                         n_head, prefix_pad=jnp.asarray(pad),
                         interpret=True)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(jcache.astype(jnp.float32)))


@pytest.mark.parametrize("c,pos_list,pad_list,nsplit,heads", [
    (5, [37, 12], [0, 0], 1, (4, 4, 32)),   # one split
    (5, [37, 12], [0, 0], 5, (4, 4, 32)),   # splits past pos + C see no row
    (5, [27, 43], [0, 0], 2, (4, 4, 32)),   # pos + C = 32 ends on a split edge
    (4, [40, 30], [20, 25], 3, (4, 4, 32)),  # pad past an even first split
    (1, [45, 3], [0, 0], 8, (4, 4, 32)),    # a draft step, mostly empty
    (8, [16, 23], [0, 5], 2, (4, 4, 32)),   # a full 8-row chunk
    (5, [37, 14], [0, 0], 3, (8, 4, 64)),   # GQA rep 2
    (5, [37, 14], [0, 0], 2, (8, 2, 64)),   # GQA rep 4
    (5, [37, 14], [0, 3], 1, (32, 32, 100)),  # GPT-3B heads (F 3200)
    (1, [45, 3], [0, 0], 2, (32, 32, 100)),   # its draft step
    (8, [16, 50], [0, 0], 1, (32, 32, 100)),  # head_dim 100, a full chunk
], ids=["one-split", "empty-splits", "pos+C-on-edge", "pad-past-split",
        "draft-step", "chunk-8", "gqa-rep2", "gqa-rep4", "d100",
        "d100-draft-step", "d100-chunk-8"])
def test_bf16_kernel_emulation_matches_jax(c, pos_list, pad_list, nsplit,
                                           heads):
    """The bf16 kernel's split-and-merge order with p rounded to bf16,
    against the JAX kernel on the same bf16 inputs: outputs to 4 bf16 ulps
    of the largest output (the card tolerance), cache rows below pos + C
    exactly."""
    n_head, kv_heads, head_dim = heads
    rng = np.random.RandomState(c + nsplit)
    pos = np.asarray(pos_list, np.int32)
    pad = np.asarray(pad_list, np.int32)
    q, kv_new, cache = _bf16_inputs(rng, 2, c, 64, n_head, head_dim,
                                    kv_heads)
    jout, jcache = _jax_bf16(q, kv_new, cache, pos, pad, n_head)
    ecache = cache.copy()
    out = emulate_bf16_kernel(q, kv_new, ecache, pos, pad, n_head, nsplit)
    tol = 2 ** -6 * max(1.0, np.abs(jout).max())
    np.testing.assert_allclose(_bf16(out), jout, atol=tol, rtol=0)
    for b, p in enumerate(pos):
        np.testing.assert_array_equal(ecache[b, :p + c], jcache[b, :p + c])


def test_bf16_kernel_emulation_backward_jump_over_garbage():
    """Two calls, the second one position back (a rejection), with large
    finite garbage in every cache row at and above the first call's
    position: the kernel takes rows >= pos from kv_new and never reads
    them, the JAX kernel masks them."""
    rng = np.random.RandomState(9)
    q1, kv1, cache = _bf16_inputs(rng, 2, 5, 64, 4, 32, 4)
    pos1 = np.asarray([30, 17], np.int32)
    pad = np.zeros(2, np.int32)
    for b, p in enumerate(pos1):
        cache[b, p:] = _bf16(rng.randn(64 - p, cache.shape[2]) * 1e3)
    _, jcache = _jax_bf16(q1, kv1, cache, pos1, pad, 4)
    ecache = cache.copy()
    emulate_bf16_kernel(q1, kv1, ecache, pos1, pad, 4, 2)
    q2, kv2, _ = _bf16_inputs(rng, 2, 5, 64, 4, 32, 4)
    pos2 = pos1 - 1
    jout, jcache2 = _jax_bf16(q2, kv2, jcache, pos2, pad, 4)
    out = emulate_bf16_kernel(q2, kv2, jcache.copy(), pos2, pad, 4, 2)
    tol = 2 ** -6 * max(1.0, np.abs(jout).max())
    np.testing.assert_allclose(_bf16(out), jout, atol=tol, rtol=0)
    for b, p in enumerate(pos1):
        np.testing.assert_array_equal(ecache[b, :p + 5], jcache[b, :p + 5])


@pytest.mark.parametrize("c", [1, 5, 8])
def test_bf16_kernel_geometry(c):
    """At every GPT-L shape the kernel meets (B 16 and a verify's / draft's
    heads, GQA and head_dim 128 variants): the heads of a block share a kv
    head, splits <= 8, shared memory <= 227 KB; and at every position
    0..576 with pad 0 and 40 the splits' rows cover [pad, pos + C) exactly,
    in order, each piece a multiple of 16 rows but the last."""
    s_len = 640
    for b, n_head, h_kv, d in [(16, 16, 16, 64), (2, 16, 16, 64),
                               (16, 16, 8, 64), (16, 16, 4, 64),
                               (16, 8, 8, 128), (16, 16, 4, 128)]:
        geo = chunk_geometry(b, n_head, h_kv, s_len, d, 132)
        rep = n_head // h_kv
        assert rep % geo.nq == 0 and geo.nq * d <= 256
        assert 1 <= geo.nsplit <= 8 and geo.smem <= 232448
        if (b, n_head, h_kv, d) == (16, 16, 16, 64):  # GPT-L
            assert geo.nsplit == 1  # B * H = 256 blocks fill 132 SMs
        for pad in (0, 40):
            for pos in range(pad, 577):
                spans = chunk_split_rows(pos, pad, c, s_len, geo.nsplit)
                rows = [r for lo, hi in spans for r in range(lo, hi)]
                assert rows == list(range(pad, min(pos + c, s_len)))
                full = [hi - lo for lo, hi in spans if hi > lo][:-1]
                assert all(n % 16 == 0 for n in full)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_kernel_geometry_head_dims(int8):
    """At head_dim 64, 100 and 128 (GPT-L, GPT-3B, GPT-7B heads; GQA too),
    bf16 or int8 cache: a block's query heads share a kv head, at most
    nq * padded head_dim = 256 lanes (100 pads to 112), splits only where
    B * H / nq blocks leave SMs idle, shared memory <= 227 KB and as the
    kernel lays it out; any other head_dim raises."""
    for b, n_head, h_kv, d in [(16, 16, 16, 64), (16, 32, 32, 100),
                               (16, 32, 16, 100), (2, 32, 32, 100),
                               (16, 32, 32, 128), (16, 32, 8, 128)]:
        geo = chunk_geometry(b, n_head, h_kv, 640, d, 132, int8)
        assert (n_head // h_kv) % geo.nq == 0
        assert geo.nq * -(-d // 16) * 16 <= 256
        assert geo.nsplit == 1 or b * n_head // geo.nq < 132
        assert geo.smem == _smem_bytes(d, geo.nq, int8) <= 232448
    assert _smem_bytes(100, 2, True) < 232448 // 3  # 3 blocks an SM
    for d in (32, 80, 96):
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            chunk_geometry(16, 16, 16, 640, d, 132, int8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernel")
    return torch.device("cuda")


def _split_edge(c, s, nsplit, pad=0):
    """The first position that starts a split of the bf16 kernel (its
    kv_new rows begin exactly at a split's first row); with one split, the
    first 64-row tile edge."""
    if nsplit == 1:
        return pad + 64
    return next(p for p in range(pad + 1, s - c + 1)
                if any(lo == p and lo < hi for lo, hi in
                       chunk_split_rows(p, pad, c, s, nsplit)[1:]))


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype,h_kv,head_dim", [
    (torch.bfloat16, 16, 64), (torch.float32, 16, 64),
    (torch.bfloat16, 8, 64), (torch.bfloat16, 4, 64),
    (torch.bfloat16, 16, 128), (torch.bfloat16, 4, 128),
    (torch.bfloat16, 16, 100), (torch.float32, 16, 100),
    (torch.bfloat16, 8, 100)],
    ids=["bf16", "f32", "bf16-rep2", "bf16-rep4", "bf16-d128",
         "bf16-rep4-d128", "bf16-d100", "f32-d100", "bf16-rep2-d100"])
def test_cuda_kernel_matches_plain(cuda, c, dtype, h_kv, head_dim):
    """The CUDA kernel against chunk_decode_attention_ref on the card, with
    per-row positions: 0, a split edge and its neighbours, pos + C = S,
    prefix padding (on some rows past the first split's rows), random
    rows; a second call at positions one back (a rejection) over the
    rows the first wrote. The output to 4 bf16 ulps of its largest value
    (f32: 1e-5), the whole cache exactly (rows >= pos + C untouched)."""
    g = torch.Generator(device=cuda).manual_seed(c + h_kv + head_dim)
    b, n_head, s = 16, 16, 640
    f, f_kv = n_head * head_dim, h_kv * head_dim
    nsplit = chunk_geometry(b, n_head, h_kv, s, head_dim, _sms(cuda)).nsplit
    edge = _split_edge(c, s, nsplit)
    pos = torch.randint(0, s - c + 1, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[:7] = torch.tensor([0, edge - 1, edge, edge + 1, s - c, 300, 301],
                           device=cuda)
    # pad <= pos - 1, so the second call (one position back) still sees a row
    pad = torch.minimum(torch.randint(0, 40, (b,), generator=g, device=cuda,
                                      dtype=torch.int32), (pos - 1).clamp(min=0))
    pad[:5] = 0
    pad[5:7] = 200  # past what the first of an even split would hold
    cache = torch.randn(b, s, 2 * f_kv, generator=g, device=cuda).to(dtype)
    ref_cache = cache.clone()
    rel = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    for step in (0, -1):
        q = torch.randn(b, c, f, generator=g, device=cuda).to(dtype)
        kv_new = torch.randn(b, c, 2 * f_kv, generator=g,
                             device=cuda).to(dtype)
        p = (pos + step).clamp(min=0)
        before = chunk_decode_attention.launches
        out = chunk_decode_attention(q, kv_new, cache, p, n_head, pad)
        ref = chunk_decode_attention_ref(q, kv_new, ref_cache, p, n_head,
                                         pad)
        torch.cuda.synchronize()
        assert chunk_decode_attention.launches == before + 1
        tol = rel * max(1.0, ref.float().abs().max().item())
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert torch.equal(cache, ref_cache)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 5, 8])
@pytest.mark.parametrize("h_kv,head_dim", [(16, 64), (4, 128), (16, 100)],
                         ids=["rep1", "rep4-d128", "rep1-d100"])
def test_cuda_kernel_split_edges(cuda, c, h_kv, head_dim):
    """Two batch rows, so the bf16 kernel splits the rows over a cluster of
    several blocks: positions at and next to every split edge, pos + C = S,
    positions whose rows fill fewer splits than there are (splits with no
    row), prefix padding past the first split's rows; output and the whole
    cache against the plain version as above."""
    g = torch.Generator(device=cuda).manual_seed(3 * c + h_kv)
    b, n_head, s = 2, 16, 640
    f, f_kv = n_head * head_dim, h_kv * head_dim
    nsplit = chunk_geometry(b, n_head, h_kv, s, head_dim, _sms(cuda)).nsplit
    assert nsplit > 1
    cases = [(0, 0), (3, 0), (s - c, 0), (s - c, 300), (301, 200)]
    for p in range(1, s - c + 1):  # every position that starts a split
        if any(lo == p for lo, hi in chunk_split_rows(p, 0, c, s,
                                                      nsplit)[1:] if lo < hi):
            cases += [(p - 1, 0), (p, 0), (p + 1, 0)]
    cache = torch.randn(b, s, 2 * f_kv, generator=g, device=cuda).to(
        torch.bfloat16)
    ref_cache = cache.clone()
    for i in range(0, len(cases), b):
        pp = cases[i:i + b] + cases[:max(0, i + b - len(cases))]
        pos = torch.tensor([p for p, _ in pp], dtype=torch.int32, device=cuda)
        pad = torch.tensor([d for _, d in pp], dtype=torch.int32, device=cuda)
        q = torch.randn(b, c, f, generator=g, device=cuda).to(torch.bfloat16)
        kv_new = torch.randn(b, c, 2 * f_kv, generator=g, device=cuda).to(
            torch.bfloat16)
        out = chunk_decode_attention(q, kv_new, cache, pos, n_head, pad)
        ref = chunk_decode_attention_ref(q, kv_new, ref_cache, pos, n_head,
                                         pad)
        torch.cuda.synchronize()
        tol = 2 ** -6 * max(1.0, ref.float().abs().max().item())
        assert (out.float() - ref.float()).abs().max().item() <= tol, pp
        assert torch.equal(cache, ref_cache), pp


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda):
    """CUDA tensors the kernels cannot take raise; nothing falls back."""
    q = torch.zeros(1, 2, 4 * 32, device=cuda, dtype=torch.bfloat16)
    cache = torch.zeros(1, 16, 2 * 4 * 32, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 2 * 4 * 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32"):
        chunk_decode_attention(q, kv, cache, 0, 4)
    for d in (80, 96):  # neither is a zoo head_dim
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            chunk_decode_attention(
                torch.zeros(1, 2, 4 * d, device=cuda),
                torch.zeros(1, 2, 8 * d, device=cuda),
                torch.zeros(1, 16, 8 * d, device=cuda), 0, 4)
    q = torch.zeros(1, 9, 4 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="chunk 9"):
        chunk_decode_attention(q, torch.zeros(1, 9, 512, device=cuda),
                               torch.zeros(1, 16, 512, device=cuda,
                                           dtype=torch.bfloat16), 0, 4)
