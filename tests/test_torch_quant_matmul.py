"""Port W8A16 matmul (llamagen_tpu_torch.ops.quant_matmul) against the JAX
Pallas `int8_matmul` (interpret mode on the CPU), and the CUDA kernel
against its plain version on the card (`-m cuda`; that machine has no JAX,
so run this file there with `python -m pytest --noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops.quant_matmul import (int8_matmul, int8_matmul_ref,
                                                 matmul_any, quantize_weight)

try:
    import jax.numpy as jnp
    from llamagen_tpu.ops import quant_matmul as jqm
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jnp = jqm = None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 256, 384), (16, 128, 512),
                                   (1, 512, 128)])
def test_int8_matmul_ref_matches_pallas(shape):
    b, k, n = shape
    rng = np.random.RandomState(k + n)
    x = rng.randn(b, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.02).astype(np.float32)
    q, s = jqm.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jqm.int8_matmul(jnp.asarray(x), q, s, interpret=True))
    out = int8_matmul_ref(torch.tensor(x), torch.tensor(np.asarray(q)),
                          torch.tensor(np.asarray(s)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # the wrapper on CPU tensors is the plain version and counts nothing
    before = int8_matmul.launches
    same = int8_matmul(torch.tensor(x), torch.tensor(np.asarray(q)),
                       torch.tensor(np.asarray(s)))
    assert torch.equal(same, out) and int8_matmul.launches == before


@pytest.mark.parametrize("shape", [(256, 384), (3, 128, 256)])
def test_quantize_weight_bit_exact(shape):
    rng = np.random.RandomState(len(shape))
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[..., 0, :] = 0.0  # an all-zero row of one channel keeps scale 1e-12
    w[..., :, 1] = 0.0  # an all-zero channel
    jq, js = jqm.quantize_weight(jnp.asarray(w))
    q, s = quantize_weight(torch.tensor(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_matmul_any_branches_match_jax():
    """bf16/f32 weight (nn.Linear layout) and W8A16 branches against JAX
    matmul_any at f32."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 128).astype(np.float32)
    w = (rng.randn(128, 256) * 0.02).astype(np.float32)
    p = {"w": jnp.asarray(w)}
    np.testing.assert_allclose(
        matmul_any(torch.tensor(x), torch.tensor(w.T)).numpy(),
        np.asarray(jqm.matmul_any(p, "w", jnp.asarray(x))), atol=1e-5)
    q, s = jqm.quantize_weight(jnp.asarray(w))
    pq = {"w_q": q, "w_scale": s}
    np.testing.assert_allclose(
        matmul_any(torch.tensor(x), weight_q=torch.tensor(np.asarray(q)),
                   weight_scale=torch.tensor(np.asarray(s))).numpy(),
        np.asarray(jqm.matmul_any(pq, "w", jnp.asarray(x))), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 40])
@pytest.mark.parametrize("k,n", [(1024, 3072), (1024, 1024), (2816, 1024),
                                 (1000, 130)])
def test_cuda_kernel_matches_plain(cuda, b, k, n):
    """The CUDA kernel against int8_matmul_ref on the card: bf16 to one
    output ulp, f32 to 1e-5 relative (the f32 sums run in another order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(k + n + b)
    w_q, w_s = quantize_weight(torch.randn(k, n, generator=g, device=cuda)
                               * 0.02)
    x = torch.randn(b, k, generator=g, device=cuda)
    for dtype, rel in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
        before = int8_matmul.launches
        out = int8_matmul(x.to(dtype), w_q, w_s)
        ref = int8_matmul_ref(x.to(dtype), w_q, w_s)
        torch.cuda.synchronize()
        assert out.dtype == dtype and int8_matmul.launches == before + 1
        tol = rel * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= tol
