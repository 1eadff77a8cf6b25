"""The port's Gumbel draw (llamagen_tpu_torch.ops.sampling) never gives
-inf: u is drawn in [tiny, 1) as JAX does, so a uniform draw of exactly 0
cannot make a token unreachable."""

import numpy as np
import torch

from llamagen_tpu_torch.ops import sampling


def test_zero_uniform_draw_gives_the_argmax(monkeypatch):
    """With every uniform draw forced to 0 the Gumbel noise is one finite
    constant, so the sample is the argmax of the logits (the unrepaired
    draw gave -inf everywhere and returned index 0)."""
    logits = torch.tensor(np.random.RandomState(0).randn(4, 100)
                          .astype(np.float32))
    logits[:, 0] = -5.0  # index 0 is never the argmax
    real_rand = torch.rand
    monkeypatch.setattr(torch, "rand",
                        lambda *a, **k: torch.zeros_like(real_rand(*a, **k)))
    noise = sampling.gumbel((4, 100), None, "cpu")
    assert torch.isfinite(noise).all()
    assert torch.equal(noise, torch.full_like(noise, noise[0, 0].item()))
    tok = sampling.sample(logits, None, top_k=10)
    assert torch.equal(tok, logits.argmax(dim=-1))


def test_gumbel_noise_is_finite_and_standard():
    g = torch.Generator().manual_seed(0)
    noise = sampling.gumbel((200_000,), g, "cpu")
    assert torch.isfinite(noise).all()
    # standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6; 5 sigma
    # bounds for 200k draws
    assert abs(noise.mean().item() - 0.5772) < 5 * 1.283 / 200_000 ** 0.5
    assert abs(noise.var().item() - np.pi ** 2 / 6) < 0.05
