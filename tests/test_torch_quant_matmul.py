"""Port W8A16 matmul (llamagen_tpu_torch.ops.quant_matmul) against the JAX
Pallas `int8_matmul` (interpret mode on the CPU), and the CUDA kernel
against its plain version on the card (`-m cuda`; that machine has no JAX,
so run this file there with `python -m pytest --noconftest -m cuda`)."""

import numpy as np
import pytest
import torch

from llamagen_tpu_torch.ops import quant_matmul as qm
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


def emulate_kernel(x, w_q, w_scale, sms=132):
    """The CUDA kernel's order of work, in f32 torch: x as one bf16 piece
    (bf16 x) or three (f32 x: x1 = bf16(x), x2 = bf16(x - x1), x3 =
    bf16(x - x1 - x2)); for each rank of the cluster (`int8_geometry`),
    its K rows in 16-row steps, each step's products of every piece with
    the exact levels added to the rank's partial; the partials summed in
    rank order; the scale; one rounding to x's dtype."""
    b, k = x.shape
    n = w_q.shape[1]
    geo = qm.int8_geometry(b, k, n, sms, x.dtype == torch.float32)
    xf = x.float()
    if x.dtype == torch.float32:
        x1 = xf.to(torch.bfloat16).float()
        x2 = (xf - x1).to(torch.bfloat16).float()
        pieces = [x1, x2, (xf - x1 - x2).to(torch.bfloat16).float()]
    else:
        pieces = [xf]
    lv = w_q.float()
    total = torch.zeros(b, n)
    for rank in range(geo.ks):
        k0, k1 = rank * geo.kb, min(k, (rank + 1) * geo.kb)
        part = torch.zeros(b, n)
        for s0 in range(k0, k1, 16):
            rows = slice(s0, min(k1, s0 + 16))
            for piece in pieces:
                part = part + piece[:, rows] @ lv[rows]
        total = total + part
    return (total * w_scale).to(x.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,k,n", [(1, 512, 128), (16, 1000, 384),
                                   (17, 256, 256), (80, 768, 128)])
def test_kernel_order_of_work_matches_pallas(b, k, n, dtype):
    """The kernel's order of work (emulated on the CPU, a cluster of
    several ranks: few SMs to fill) against the Pallas kernel in interpret
    mode on the same inputs: bf16 x to one bf16 ulp of the largest output,
    f32 x (its three bf16 pieces) to 1e-5 of it, the card tolerances."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(b + k)
    x = torch.tensor(rng.randn(b, k).astype(np.float32)).to(tdt)
    w_q, w_s = quantize_weight(torch.tensor(
        (rng.randn(k, n) * 0.02).astype(np.float32)))
    ref = np.asarray(jqm.int8_matmul(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(w_q.numpy()),
        jnp.asarray(w_s.numpy()), interpret=True).astype(jnp.float32))
    out = emulate_kernel(x, w_q, w_s, sms=16)
    assert out.dtype == tdt
    rel = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


GEOMETRY_SHAPES = {"wqkv": (1024, 3072), "wo": (1024, 1024),
                   "w1": (1024, 2816), "w2": (2816, 1024),
                   "head": (1024, 16384), "3b-wqkv": (3200, 9600),
                   "3b-wo": (3200, 3200), "3b-w1": (3200, 8704),
                   "3b-w2": (8704, 3200), "ragged": (1000, 130)}


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(GEOMETRY_SHAPES))
def test_kernel_geometry(name, f32):
    """The launch geometry at B 1..320 for every GPT-L and GPT-3B layer
    shape, the int8 head and a ragged shape: the cluster's K-row ranges
    cover K exactly (a multiple of 16 rows a block), 64- or 128-column
    tiles, at most 8 blocks a
    cluster, batch passes of a multiple of 8 rows (<= 96) that cover B,
    shared memory <= 227 KB; at GPT-L every grid gives each of 132 SMs a
    block unless the cluster is already at its 8 blocks (wo, w2: 16
    column tiles)."""
    k, n = GEOMETRY_SHAPES[name]
    for b in range(1, 321):
        geo = qm.int8_geometry(b, k, n, 132, f32)
        assert 1 <= geo.ks <= 8 and geo.kb % 16 == 0
        assert (geo.ks - 1) * geo.kb < k <= geo.ks * geo.kb
        assert geo.bc % 8 == 0 and 8 <= geo.bc <= 96
        assert -(-b // geo.bc) * geo.bc >= b
        assert geo.smem == qm._smem_bytes(geo.kb, geo.bc, 3 if f32 else 1,
                                          geo.cols)
        assert geo.smem <= 232448 and geo.cols in (64, 128)
        if name in ("wqkv", "wo", "w1", "w2", "head"):
            assert geo.ks * -(-n // geo.cols) >= 132 or geo.ks == 8
    with pytest.raises(ValueError):
        qm.int8_geometry(4, k, 129, 132)


SHAPES = {"wqkv": (1024, 3072), "wo": (1024, 1024),
                   "w1": (1024, 2816), "w2": (2816, 1024),
                   "head": (1024, 16384), "3b-wqkv": (3200, 9600),
                   "3b-wo": (3200, 3200), "3b-w1": (3200, 8704),
                   "3b-w2": (8704, 3200), "ragged": (1000, 130)}


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(GEOMETRY_SHAPES))
def test_kernel_geometry(name, f32):
    """The launch geometry at B 1..320 for every GPT-L and GPT-3B layer
    shape, the int8 head and a ragged shape: the cluster's K-row ranges
    cover K exactly (a multiple of 16 rows a block), 64- or 128-column
    tiles, at most 8 blocks a
    cluster, batch passes of a multiple of 8 rows (<= 96) that cover B,
    shared memory <= 227 KB; at GPT-L every grid gives each of 132 SMs a
    block unless the cluster is already at its 8 blocks (wo, w2: 16
    column tiles)."""
    k, n = GEOMETRY_SHAPES[name]
    for b in range(1, 321):
        geo = qm.int8_geometry(b, k, n, 132, f32)
        assert 1 <= geo.ks <= 8 and geo.kb % 16 == 0
        assert (geo.ks - 1) * geo.kb < k <= geo.ks * geo.kb
        assert geo.bc % 8 == 0 and 8 <= geo.bc <= 96
        assert -(-b // geo.bc) * geo.bc >= b
        assert geo.smem == qm._smem_bytes(geo.kb, geo.bc, 3 if f32 else 1,
                                          geo.cols)
        assert geo.smem <= 232448 and geo.cols in (64, 128)
        if name in ("wqkv", "wo", "w1", "w2", "head"):
            assert geo.ks * -(-n // geo.cols) >= 132 or geo.ks == 8
    with pytest.raises(ValueError):
        qm.int8_geometry(4, k, 129, 132)


def test_kernel_geometry_is_cached_per_shape():
    """The wrapper asks the device nothing per call: the geometry comes
    from a cache keyed by shape, x's dtype and device index."""
    assert qm._launch_geometry.cache_info is not None
    assert not hasattr(qm, "_k_per_split")


SHAPES = {"wqkv": (1024, 3072), "wo": (1024, 1024), "w1": (1024, 2816),
          "w2": (2816, 1024), "head": (1024, 16384),
          "3b-wqkv": (3200, 9600), "3b-wo": (3200, 3200),
          "3b-w1": (3200, 8704), "3b-w2": (8704, 3200),
          "ragged": (1000, 130), "ragged-k": (1000, 3072),
          "ragged-n": (1024, 136)}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 17, 32, 80, 128, 320])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cuda_kernel_matches_plain(cuda, b, shape):
    """The CUDA kernel against int8_matmul_ref on the card, at the GPT-L
    and GPT-3B layer shapes, the int8 head and ragged K and N, B 1..320
    (8-row tiles, 96-row passes; 16 the batch-8 + CFG step, 32 and 128 the
    serving engine's 16 and 64 pairs): bf16 to one output ulp, f32 to 1e-5
    relative (the f32 sums run in another order); one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k, n = SHAPES[shape]
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


@pytest.mark.cuda
def test_cuda_kernel_raises_on_what_it_does_not_take(cuda):
    """An odd N and an int8 x raise on the card; nothing falls back."""
    x = torch.zeros(2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even"):
        int8_matmul(x, torch.zeros(64, 33, dtype=torch.int8, device=cuda),
                    torch.ones(33, device=cuda))
    with pytest.raises(TypeError):
        int8_matmul(x.to(torch.int8),
                    torch.zeros(64, 32, dtype=torch.int8, device=cuda),
                    torch.ones(32, device=cuda))


# --- int4 storage (bits=4): plain PyTorch against JAX's plain XLA ----------


@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "layers"])
@pytest.mark.parametrize("k,n,group", [(256, 64, 128), (96, 32, 128),
                                       (3200, 64, 128)],
                         ids=["k256", "k96_group96", "k3200_gpt3b"])
def test_quantize_weight_int4_bit_exact(k, n, group, lead):
    """Packed bytes and group scales equal JAX's `quantize_weight_int4` bit
    for bit (K 96: one group of 96; K 3200: GPT-3B's width, 25 groups),
    with and without a leading layer axis; `unpack_int4` gives JAX's
    levels."""
    rng = np.random.RandomState(k + len(lead))
    w = (rng.randn(*lead, k, n) * 0.05).astype(np.float32)
    jp, js = jqm.quantize_weight_int4(jnp.asarray(w), group_size=group)
    p, s = qm.quantize_weight_int4(torch.tensor(w), group_size=group)
    assert p.dtype == torch.int8 and s.shape == (*lead, k // qm._pick_group(
        k, group), n)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    levels = np.asarray(jqm.unpack_int4(jp).astype(jnp.int8))
    np.testing.assert_array_equal(qm.unpack_int4(p).numpy(), levels)


@pytest.mark.parametrize("x_shape", [(8, 256), (2, 5, 256)],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("group", [256, 64], ids=["one_group", "groups"])
def test_int4_matmul_matches_jax(x_shape, group):
    """`int4_matmul` (and `matmul_any`'s int4 branch) on 2-D and 3-D
    activations within 1e-6 of the largest |value| of JAX's: one group
    (the scale after the product) and 4 groups (f32 partials per group)."""
    rng = np.random.RandomState(group)
    x = rng.randn(*x_shape).astype(np.float32)
    w = (rng.randn(256, 128) * 0.02).astype(np.float32)
    jp, js = jqm.quantize_weight_int4(jnp.asarray(w), group_size=group)
    ref = np.asarray(jqm.int4_matmul(jnp.asarray(x), jp, js))
    p, s = torch.tensor(np.asarray(jp)), torch.tensor(np.asarray(js))
    for got in (qm.int4_matmul(torch.tensor(x), p, s),
                matmul_any(torch.tensor(x), weight_q4=p, weight_gs=s)):
        assert got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-6 * np.abs(ref).max(), err


def test_int4_model_refuses_a_tp_shard():
    """JAX's tp_decode has no rule for `_q4` keys: `shard_tp_params`
    refuses an int4 model before touching it."""
    from llamagen_tpu_torch.config import gpt_config
    from llamagen_tpu_torch.models import gpt
    from llamagen_tpu_torch.parallel.tp_decode import shard_tp_params
    model = qm.quantize_gpt_params(gpt.Transformer(gpt_config(
        "GPT-nano", block_size=16)), bits=4)
    with pytest.raises(ValueError, match="int4 storage"):
        shard_tp_params(model, 0, 2)
    assert model.tp_size == 1 and model.layers[0].attention.n_head == 2
