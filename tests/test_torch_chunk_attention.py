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
    chunk_decode_attention, chunk_decode_attention_ref)

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


def test_refuses_int8_caches_and_overflow():
    q = torch.zeros(1, 2, 128)
    with pytest.raises(TypeError, match="int8"):
        chunk_decode_attention(q, torch.zeros(1, 2, 256),
                               torch.zeros(1, 16, 256, dtype=torch.int8), 0,
                               4)
    with pytest.raises(ValueError, match="outside the cache"):
        chunk_decode_attention(q, torch.zeros(1, 2, 256),
                               torch.zeros(1, 16, 256), 15, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 5, 8])
@pytest.mark.parametrize("dtype,h_kv,head_dim", [
    (torch.bfloat16, 16, 64), (torch.float32, 16, 64),
    (torch.bfloat16, 8, 64), (torch.bfloat16, 4, 128)])
def test_cuda_kernel_matches_plain(cuda, c, dtype, h_kv, head_dim):
    """The CUDA kernel against chunk_decode_attention_ref on the card, with
    per-row positions (0, 7, 8, S - C among them) and prefix padding: the
    output to 4 bf16 ulps of its largest value (f32: 1e-5), the cache rows
    below pos + C exactly."""
    g = torch.Generator(device=cuda).manual_seed(c + h_kv)
    b, n_head, s = 16, 16, 640
    f, f_kv = n_head * head_dim, h_kv * head_dim
    q = torch.randn(b, c, f, generator=g, device=cuda).to(dtype)
    kv_new = torch.randn(b, c, 2 * f_kv, generator=g, device=cuda).to(dtype)
    cache = torch.randn(b, s, 2 * f_kv, generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, s - c + 1, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[:4] = torch.tensor([0, 7, 8, s - c], device=cuda)
    pad = torch.minimum(torch.randint(0, 40, (b,), generator=g, device=cuda,
                                      dtype=torch.int32), pos)
    ref_cache = cache.clone()
    before = chunk_decode_attention.launches
    out = chunk_decode_attention(q, kv_new, cache, pos, n_head, pad)
    ref = chunk_decode_attention_ref(q, kv_new, ref_cache, pos, n_head, pad)
    torch.cuda.synchronize()
    assert chunk_decode_attention.launches == before + 1
    rel = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    tol = rel * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(cache, ref_cache)  # rows >= pos + C untouched too
