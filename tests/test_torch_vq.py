"""Port VQ decoder (llamagen_tpu_torch.models.vq) against JAX
`vq.decode_code`: images within 5e-4 at f32 (the PARITY.md VQ tolerance)."""

import numpy as np

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import vq as jvq
from llamagen_tpu_torch.config import VQConfig
from llamagen_tpu_torch.models import vq
from llamagen_tpu_torch.utils.convert import vq_state_dict_from_jax
from test_torch_gpt import jax_config
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)

SMALL = VQConfig(ch=32, encoder_ch_mult=(1, 2), decoder_ch_mult=(1, 2),
                 z_channels=64, codebook_size=256, codebook_embed_dim=8)


def test_decode_code_matches_jax():
    params = jvq.init_params(jax.random.PRNGKey(0), jax_config(SMALL))
    model = vq.VQModel(SMALL)
    model.load_state_dict(vq.decode_half(vq_state_dict_from_jax(
        jax.tree.map(np.asarray, params), SMALL)))
    idx = np.random.RandomState(0).randint(0, 256, size=(2, 8, 8))
    ref = np.asarray(jvq.decode_code(params, jnp.asarray(idx),
                                     jax_config(SMALL)))
    out = model.decode_code(torch.tensor(idx)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=0)


def test_codebook_lookup_is_l2_normalised():
    model = vq.init_weights(vq.VQModel(SMALL), seed=1)
    with torch.no_grad():
        emb = model.codebook_lookup(torch.tensor([[0, 5, 255]]))
    np.testing.assert_allclose(emb.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    params = {"codebook": jnp.asarray(
        model.quantize.embedding.weight.detach().numpy())}
    ref = jvq.codebook_lookup(params, jnp.asarray([[0, 5, 255]]),
                              jax_config(SMALL))
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref), atol=1e-6)
