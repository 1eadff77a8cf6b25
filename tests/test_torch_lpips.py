"""Port LPIPS (llamagen_tpu_torch.models.lpips) against the JAX package on
the CPU: a full-width VGG16 with JAX's seeded random weights (neither the
torchvision backbone nor the reference's `vgg.pth` heads are in this
repository), carried by `lpips_state_dict_from_jax`, on 32 px images.

Tolerances: f32 distances within 1e-5 relative (13 f32 convolutions in
another summation order); bf16 (both sides run the network in bf16 over
f32 weights) within 2e-2 relative, the JAX suite's bf16-vs-f32 bound
(tests/test_vq_training.py:142). Per-slice checkpointing changes nothing:
the distance and its gradient are bitwise the same.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from llamagen_tpu.models import lpips as jlpips
from llamagen_tpu_torch.models import lpips
from llamagen_tpu_torch.utils.convert import lpips_state_dict_from_jax
from test_torch_gpt import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vq_encode import images

lpips_ref = jax.jit(jlpips.lpips)  # one program, not one per op


@pytest.fixture(scope="module")
def pair():
    params = jax.jit(jlpips.init_params)(jax.random.PRNGKey(9))
    model = lpips.LPIPS()
    model.load_state_dict(lpips_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return params, model


def _inputs():
    return images(2, 32, seed=11), images(2, 32, seed=12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lpips_matches_jax(pair, dtype):
    params, model = pair
    x, y = _inputs()
    jd, td, rtol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                    else (jnp.bfloat16, torch.bfloat16, 2e-2))
    ref = np.asarray(lpips_ref(params, jnp.asarray(x).astype(jd),
                               jnp.asarray(y).astype(jd)), np.float32)
    with torch.no_grad():
        out = model(torch.tensor(x).to(td), torch.tensor(y).to(td))
        same = model(torch.tensor(x).to(td), torch.tensor(x).to(td))
    assert out.dtype == td and out.shape == ref.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=rtol)
    assert np.all(ref > 0) and torch.all(same == 0)
    mean = model.mean(torch.tensor(x).to(td), torch.tensor(y).to(td))
    assert mean.dtype == torch.float32
    np.testing.assert_allclose(mean.item(), ref.mean(), rtol=rtol)


def test_slice_checkpoint_changes_nothing(pair):
    """Per-slice checkpointing (JAX `vgg_features(remat=True)`): the same
    distance and gradient with respect to the reconstruction."""
    _, model = pair
    x, y = _inputs()
    out = []
    for remat in (False, True):
        yt = torch.tensor(y, requires_grad=True)
        value = model.mean(torch.tensor(x), yt, remat=remat)
        value.backward()
        out.append((value.detach(), yt.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and out[0][1].abs().max() > 0
    assert not any(p.requires_grad for p in model.parameters())


def test_loaders_match_jax_converters(pair):
    """A torchvision `vgg16` state dict (`features.{i}`, classifier keys
    ignored) and the reference's `vgg.pth` heads load into the port as
    JAX's `convert_vgg16_features` / `convert_lpips_lins` read them; the
    bare (`{i}`) and sliced upstream (`slice{n}.{i}`) keys load too."""
    _, model = pair
    sd = model.state_dict()
    tv = {k.replace(f"net.slice{lpips.slice_of(int(k.split('.')[2]))}.",
                    "features."): v
          for k, v in sd.items() if k.startswith("net.")}
    tv["classifier.0.weight"] = torch.zeros(4, 4)
    lins = {k: v for k, v in sd.items() if k.startswith("lin")}
    assert len(tv) == 27 and len(lins) == 5
    assert "features.28.bias" in tv and "lin4.model.1.weight" in lins
    loaded = lpips.load_lpips(tv, lins)
    sliced = lpips.load_lpips(
        {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")},
        lins)
    bare = lpips.load_lpips({k[len("features."):]: v for k, v in tv.items()
                             if k.startswith("features.")}, lins)
    jparams = jlpips.load_params({k: v.numpy() for k, v in tv.items()},
                                 {k: v.numpy() for k, v in lins.items()})
    x, y = _inputs()
    ref = np.asarray(lpips_ref(jparams, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        for m in (loaded, sliced, bare):
            np.testing.assert_allclose(
                m(torch.tensor(x), torch.tensor(y)).numpy(), ref, rtol=1e-5)
    with pytest.raises(KeyError, match="conv 28"):
        lpips.load_lpips({k: v for k, v in tv.items()
                          if not k.startswith("features.28")}, lins)


def test_seeded_init_scheme():
    model = lpips.init_weights(lpips.LPIPS(), seed=4)
    again = lpips.init_weights(lpips.LPIPS(), seed=4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    conv = model.net.slice5._modules["28"]
    bound = (3 / conv.weight[0].numel()) ** 0.5
    assert conv.weight.abs().max() <= bound and torch.all(conv.bias == 0)
    assert all(getattr(model, f"lin{k}").model[1].weight.min() >= 0
               for k in range(5))
