"""Port training attention (llamagen_tpu_torch.ops.train_attention, K4)
against the JAX Pallas kernel (interpret mode on the CPU), and the CUDA
kernels against their plain version on the card (`-m cuda`; that machine has
no JAX, so run this file there with `python -m pytest --noconftest -m cuda`).

Tolerances on the CPU are the JAX suite's own (`tests/test_train_attention.py`):
1e-5 forward and 1e-4 gradients at f32, 2e-2 at bf16.
"""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops import train_attention as ta

try:
    import jax
    import jax.numpy as jnp
    from llamagen_tpu.ops.train_attention import (causal_attention_bshd,
                                                  causal_attention_padded)
except ImportError:  # the GPU machine has no JAX: only `-m cuda` runs there
    jax = jnp = causal_attention_bshd = causal_attention_padded = None


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _torch_grads(fn, arrays, dtype=torch.float32, seed=9):
    xs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    out = fn(*xs, arrays[0].shape[-1] ** -0.5)
    w = torch.tensor(np.random.RandomState(seed).randn(*out.shape)
                     .astype(np.float32), dtype=dtype)
    (out.float() * w.float()).sum().backward()
    return out, [x.grad for x in xs]


def _jax_grads(fn, arrays, seed=9):
    xs = [jnp.asarray(a) for a in arrays]
    scale = arrays[0].shape[-1] ** -0.5
    w = jnp.asarray(np.random.RandomState(seed)
                    .randn(*arrays[0].shape).astype(np.float32))
    out = fn(*xs, scale)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, scale) * w),
                     argnums=(0, 1, 2))(*xs)
    return out, grads


@pytest.mark.parametrize("shape", [(2, 17, 2, 64), (2, 64, 2, 64),
                                   (1, 33, 2, 128)],
                         ids=["s17", "s64", "d128"])
def test_ref_matches_jax_kernel_f32(shape):
    arrays = _inputs(shape, 0)
    out, grads = _torch_grads(ta.causal_attention, arrays)
    jout, jgrads = _jax_grads(causal_attention_bshd, arrays)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


def test_ref_matches_jax_kernel_bf16():
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
              for a in _inputs((2, 24, 2, 64), 2)]
    out = ta.causal_attention(*(torch.tensor(a, dtype=torch.bfloat16)
                                for a in arrays), 64 ** -0.5)
    jout = causal_attention_bshd(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in arrays), 64 ** -0.5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_padded_head_dim_100_matches_jax():
    """GPT-3B's head_dim 100: the port pads to 128, JAX to 104; zero lanes
    are exact, so both equal the unpadded math."""
    arrays = _inputs((2, 33, 2, 100), 3)
    out, grads = _torch_grads(ta.causal_attention_padded, arrays)
    jout, jgrads = _jax_grads(causal_attention_padded, arrays)
    assert out.shape == (2, 33, 2, 100)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def _single_pass_emulation(q, k, v, scale, tile=64):
    """The bf16 forward kernel's order of operations, tile by tile, on the
    CPU: 64-key tiles, f32 scores, a running row max m, p = exp(s - m) in
    f32 summed unrounded into l, p rounded to bf16 before the product with
    v (f32 sums), the accumulator rescaled by exp(m_old - m_new) in f32,
    and o = acc / l rounded to bf16 at the end. q, k, v: bf16 [B, S, H, D].
    """
    b, s, h, d = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, s, 1), float("-inf"))
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s).view(s, 1)
    for k0 in range(0, s, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        sc = (qf @ kt.transpose(-1, -2)) * scale
        keys = torch.arange(k0, k0 + kt.shape[2]).view(1, -1)
        sc = sc.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l).to(torch.bfloat16).permute(0, 2, 1, 3)


@pytest.mark.parametrize("s", [1, 65, 129, 200])
@pytest.mark.parametrize("d", [64, 128])
def test_single_pass_rounding_matches_jax_bf16(s, d):
    """The kernel's single-pass numerics (p rounded to bf16 before it is
    normalised) stay within the bf16 tolerance of the JAX kernel, which
    rounds the normalised p, on shapes that cross 64-key tile edges."""
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
              for a in _inputs((2, s, 2, d), 10 + s + d)]
    out = _single_pass_emulation(*(torch.tensor(a, dtype=torch.bfloat16)
                                   for a in arrays), d ** -0.5)
    jout = causal_attention_bshd(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in arrays), d ** -0.5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_bf16_strides_must_be_16_byte_aligned():
    """The bf16 kernels move rows in 16-byte pieces (TMA, cp.async):
    `_strides` takes batch and row strides and base offsets that are
    multiples of 8 elements and raises on anything else; f32 is free."""
    x = torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)
    assert ta._strides(x) == (1024, 128)
    qkv = torch.zeros(2, 8, 3 * 128, dtype=torch.bfloat16)
    v = qkv[..., 256:].reshape(2, 8, 2, 64)  # the model's view, stride 3F
    assert ta._strides(v) == (8 * 384, 384)
    odd_row = torch.zeros(2, 8, 132, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16-byte"):
        ta._strides(odd_row.reshape(2, 8, 2, 64))
    flat = torch.zeros(2 * 8 * 128 + 64, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte"):
        ta._strides(flat[4:4 + 2 * 8 * 128].view(2, 8, 2, 64))
    assert ta._strides(flat[8:8 + 2 * 8 * 128].view(2, 8, 2, 64)) \
        == (1024, 128)
    odd_f32 = torch.zeros(2, 8, 129)[..., :128].reshape(2, 8, 2, 64)
    assert ta._strides(odd_f32) == (8 * 129, 129)
    with pytest.raises(ValueError, match="dense"):
        ta._strides(x.transpose(2, 3))
    # o and do (the backward reads them in 16-byte pieces)
    ta._check_dense(o=x, do=flat[8:8 + 2 * 8 * 128].view(2, 8, 2, 64))
    with pytest.raises(ValueError, match="do must be contiguous"):
        ta._check_dense(do=flat[4:4 + 2 * 8 * 128].view(2, 8, 2, 64))
    with pytest.raises(ValueError, match="o must be contiguous"):
        ta._check_dense(o=x.transpose(1, 2))


def test_cpu_takes_the_plain_version_and_validates():
    q, k, v = (torch.randn(1, 8, 2, 64) for _ in range(3))
    before = (ta.train_attention_fwd.launches, ta.train_attention_dq.launches,
              ta.train_attention_dkdv.launches)
    out = ta.causal_attention(q, k, v, 0.125)
    torch.testing.assert_close(out, ta.causal_attention_ref(q, k, v, 0.125),
                               rtol=0, atol=0)
    assert (ta.train_attention_fwd.launches, ta.train_attention_dq.launches,
            ta.train_attention_dkdv.launches) == before
    with pytest.raises(ValueError, match="B, S, H, D"):
        ta.causal_attention(q, k[:, :4], v, 0.125)
    with pytest.raises(TypeError, match="dtypes"):
        ta.causal_attention(q, k.double(), v, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        ta.train_attention_fwd(q, k, v, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        ta.causal_attention_padded(*(torch.randn(1, 4, 1, 160)
                                     for _ in range(3)), 0.1)


# ---------------------------------------------------------------------------
# The CUDA kernels against the plain version (on the card only)
# ---------------------------------------------------------------------------


def _kernel_vs_plain(dev, shape, dtype, strided_v=False, seed=0):
    """Forward and dq/dk/dv of the kernels and of the plain version (its
    autograd) on the same inputs; returns max errors relative to the
    largest reference magnitude of each tensor (at least 1: at S = 1 the
    exact dq and dk are 0, and the kernels give f32 rounding noise)."""
    b, s, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(shape, generator=g, device=dev).to(dtype)
            for _ in range(2))
    if strided_v:  # v as the model gives it: a view into [B, S, 3F]
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev).to(dtype)
        v = qkv[..., 2 * h * d:].reshape(b, s, h, d)
    else:
        v = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = torch.randn(shape, generator=g, device=dev).to(dtype)
    res = []
    for fn in (ta.causal_attention_padded, ta.causal_attention_ref):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, d ** -0.5)
        out.backward(w)
        res.append([out] + [x.grad for x in xs])
    torch.cuda.synchronize()
    return [((a.float() - r.float()).abs().max()
             / r.float().abs().max().clamp_min(1.0)).item()
            for a, r in zip(*res)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,strided_v", [
    ((4, 576, 16, 64), torch.bfloat16, True),
    ((2, 577, 8, 128), torch.bfloat16, False),
    ((2, 577, 8, 128), torch.float32, True),
    ((2, 257, 12, 64), torch.bfloat16, False),
    ((2, 257, 4, 100), torch.bfloat16, False),
    ((2, 100, 2, 64), torch.float32, False),
    ((3, 1, 2, 64), torch.float32, False),
    # tile edges of the bf16 kernels (64 keys, 64 or 128 query rows)
    ((3, 1, 2, 64), torch.bfloat16, True),
    ((2, 65, 4, 64), torch.bfloat16, True),
    ((2, 129, 4, 64), torch.bfloat16, True),
    ((2, 577, 4, 64), torch.bfloat16, True),
    ((3, 1, 2, 128), torch.bfloat16, True),
    ((2, 65, 4, 128), torch.bfloat16, True),
    ((2, 129, 4, 128), torch.bfloat16, True),
    ((2, 577, 4, 128), torch.bfloat16, True),
], ids=["gpt-l-bf16", "d128-bf16", "d128-f32", "ragged-257", "pad-100",
        "f32-100", "s1", "bf16-s1-d64", "bf16-s65-d64", "bf16-s129-d64",
        "bf16-s577-d64", "bf16-s1-d128", "bf16-s65-d128", "bf16-s129-d128",
        "bf16-s577-d128"])
def test_kernels_match_plain_version(cuda, shape, dtype, strided_v):
    """Errors relative to each tensor's largest magnitude: f32 1e-5 (sums
    in another order); bf16 1e-2 for o (1-2 ulps of the largest output) and
    2e-2 for the gradients (p and ds are rounded to bf16 at other points:
    the kernel rounds ds, the plain version's autograd rounds dp)."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    errs = _kernel_vs_plain(cuda, shape, dtype, strided_v)
    assert errs[0] <= tol, errs
    assert max(errs[1:]) <= 2 * tol, errs


@pytest.mark.cuda
def test_kernels_count_launches_and_give_lse(cuda):
    b, s, h, d = 2, 130, 2, 64
    q, k, v = (torch.randn(b, s, h, d, device=cuda) for _ in range(3))
    n = [f.launches for f in (ta.train_attention_fwd, ta.train_attention_dq,
                              ta.train_attention_dkdv)]
    o, lse = ta.train_attention_fwd(q, k, v, 0.125)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
    causal = torch.ones(s, s, dtype=torch.bool, device=cuda).tril()
    ref = torch.logsumexp(scores.masked_fill(~causal, ta.NEG), dim=-1)
    torch.testing.assert_close(lse, ref, rtol=1e-5, atol=1e-5)
    do = torch.randn_like(o)
    dq, delta = ta.train_attention_dq(q, k, v, o, do, lse, 0.125)
    torch.testing.assert_close(delta, (do * o).sum(-1).transpose(1, 2),
                               rtol=1e-5, atol=1e-5)
    ta.train_attention_dkdv(q, k, v, do, lse, delta, 0.125)
    assert [f.launches for f in (ta.train_attention_fwd,
                                 ta.train_attention_dq,
                                 ta.train_attention_dkdv)] == \
        [x + 1 for x in n]
    with pytest.raises(ValueError, match="head_dim"):
        ta.causal_attention(*(torch.randn(1, 4, 1, 96, device=cuda)
                              for _ in range(3)), 0.1)


@pytest.mark.cuda
def test_save_attn_skips_the_recomputed_forward(cuda):
    """remat "save_attn" keeps K4's output through the backward: one
    forward launch per layer instead of two under "full", and the same
    loss and gradients (the kernels are deterministic)."""
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.train import c2i

    cfg = gpt_config("GPT-nano", block_size=64)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = c2i.Batch(
        torch.randint(0, 1000, (4,), generator=g, device=cuda),
        torch.randint(0, 16384, (4, 64), generator=g, device=cuda))
    runs = []
    for remat in ("full", "save_attn"):
        model = gpt.init_weights(gpt.Transformer(cfg, device=cuda), seed=0)
        with torch.no_grad():
            model.output.weight.normal_(0, 0.02, generator=torch.Generator(
                device=cuda).manual_seed(1))
        kernels = (ta.train_attention_fwd, ta.train_attention_dq,
                   ta.train_attention_dkdv)
        before = [f.launches for f in kernels]
        loss = c2i.loss_fn(model, batch, c2i.step_generator(0, 1),
                           torch.bfloat16, remat)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.item(), [p.grad for p in model.parameters()],
                     [f.launches - n for f, n in zip(kernels, before)]))
    n = cfg.n_layer
    assert runs[0][2] == [2 * n, n, n] and runs[1][2] == [n, n, n]
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
