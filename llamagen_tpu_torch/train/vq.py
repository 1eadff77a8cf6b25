"""VQ-GAN tokenizer training on one device (PyTorch port of
`llamagen_tpu/train/vq.py` without the mesh).

One step, in JAX's order: the generator loss (reconstruction in f32,
LPIPS in the compute dtype with an f32 mean, the adversarial term on the
discriminator as it was before the step, gated by `disc_start`, the
codebook terms), the generator update, the discriminator update on the
real images and this step's detached reconstructions, the EMA, the rolling
65,536-entry codebook-usage window. Both optimizers are Adam without
weight decay after a global-norm clip (`make_vq_optimizer`).

The models keep f32 master weights and run the forward in the compute
dtype (their convolutions cast their weights per call). The generator's
backward reaches the VQ parameters only: the discriminator's are frozen
while it runs. The adaptive GAN weight is upstream's recipe, the gradients
of the two loss terms with respect to the decoder's `conv_out` weight on
the step's own graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llamagen_tpu_torch.config import VQConfig
from llamagen_tpu_torch.models import discriminator as disc_lib
from llamagen_tpu_torch.models import vq
from llamagen_tpu_torch.models.lpips import LPIPS
from llamagen_tpu_torch.train.c2i import step_generator
from llamagen_tpu_torch.train.train_state import Optimizer, ema_update

USAGE_WINDOW = 65536  # upstream's rolling `codebook_used` buffer
DROPOUT_SEED = 23  # JAX: fold_in(PRNGKey(23), step)
Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class VQLossConfig:
    """Upstream `VQLoss` defaults (JAX `VQLossConfig`)."""
    disc_start: int = 20000
    disc_weight: float = 0.5
    disc_type: str = "patchgan"        # or 'stylegan'
    disc_loss: str = "hinge"           # or 'vanilla', 'non-saturating'
    gen_adv_loss: str = "hinge"        # or 'non-saturating'
    reconstruction_loss: str = "l2"    # or 'l1'
    reconstruction_weight: float = 1.0
    codebook_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_adaptive_weight: bool = False
    image_size: int = 256


def hinge_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean())


def vanilla_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-real).mean() + F.softplus(fake).mean())


def hinge_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return -fake.mean()


def non_saturating_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake).mean()


# 'non-saturating' is the BCE-with-logits of real vs 1 and fake vs 0: the
# vanilla formula
D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss,
            "non-saturating": vanilla_d_loss}
G_LOSSES = {"hinge": hinge_gen_loss, "non-saturating": non_saturating_gen_loss}


def rec_loss_fn(kind: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if kind == "l1":
        return (x - y).abs().mean()
    return ((x - y) ** 2).mean()


def codebook_usage(indices: torch.Tensor, codebook_size: int
                   ) -> torch.Tensor:
    """The fraction of the codebook's entries among `indices` (f32)."""
    hit = torch.zeros(codebook_size, dtype=torch.bool, device=indices.device)
    hit.index_fill_(0, indices.reshape(-1).long(), True)
    return hit.sum() / codebook_size


def rolling_codebook_usage(window: torch.Tensor, indices: torch.Tensor,
                           codebook_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upstream's usage metric: shift the window left by this batch's id
    count, append the ids (only the last `len(window)` when the batch
    holds as many), and report the share of the codebook in it. Returns
    (new window, usage); no host synchronisation."""
    idx = indices.reshape(-1).to(window.dtype)
    w = window.shape[0]
    if idx.shape[0] >= w:
        window = idx[-w:].clone()
    else:
        window = torch.cat([window[idx.shape[0]:], idx])
    return window, codebook_usage(window, codebook_size)


def make_vq_optimizer(module: nn.Module, lr: float = 1e-4,
                      beta1: float = 0.9, beta2: float = 0.95,
                      max_grad_norm: float = 1.0) -> Optimizer:
    """Global-norm clip (no 1e-6 term) then Adam: `train_state.Optimizer`
    without weight decay or warmup (JAX `make_vq_optimizer`)."""
    return Optimizer(module, lr, weight_decay=0.0, beta1=beta1, beta2=beta2,
                     max_grad_norm=max_grad_norm)


@dataclass
class VQTrainState:
    """The VQ model and discriminator (f32 master weights), their
    optimizers, the EMA of the VQ parameters (by name), the number of steps
    taken and the usage window (int64 ids on the device, starting at
    zeros as JAX's: code 0 counts as used until the window fills)."""
    step: int
    model: vq.VQModel
    optimizer: Optimizer
    disc: nn.Module
    disc_optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]]
    usage_window: torch.Tensor


StepFn = Callable[[VQTrainState, torch.Tensor],
                  Tuple[VQTrainState, Metrics]]


def init_vq_train_state(model: vq.VQModel, disc: nn.Module,
                        optimizer: Optimizer, disc_optimizer: Optimizer,
                        use_ema: bool = False) -> VQTrainState:
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if use_ema else None)
    window = torch.zeros(USAGE_WINDOW, dtype=torch.long,
                         device=model.post_quant_conv.weight.device)
    return VQTrainState(step=0, model=model, optimizer=optimizer, disc=disc,
                        disc_optimizer=disc_optimizer, ema=ema,
                        usage_window=window)


def make_train_step(cfg: VQConfig, loss_cfg: VQLossConfig, *,
                    lpips: Optional[LPIPS] = None, use_disc: bool = True,
                    ema_decay: Optional[float] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False) -> StepFn:
    """train_step(state, imgs) -> (state, metrics): one generator and one
    discriminator update in place (JAX `make_train_step_fn`). imgs: NHWC
    [B, H, W, 3] in [-1, 1] on the models' device. `lpips` None (or a
    perceptual weight of 0) drops the perceptual term; `use_disc` False
    drops the discriminator's forward and update. The metrics stay on the
    device: JAX's (gen_loss, rec_loss, perceptual_loss, gen_adv_loss,
    vq_loss, commit_loss, entropy_loss, disc_adaptive_weight, disc_loss,
    logits_real, logits_fake, codebook_usage) and the two gradient norms
    before their clips (grad_norm, disc_grad_norm)."""
    d_loss_fn = D_LOSSES[loss_cfg.disc_loss]
    g_adv_fn = G_LOSSES[loss_cfg.gen_adv_loss]
    use_lpips = lpips is not None and loss_cfg.perceptual_weight > 0
    rw, pw = loss_cfg.reconstruction_weight, loss_cfg.perceptual_weight

    def train_step(state: VQTrainState, imgs: torch.Tensor):
        model, disc = state.model, state.disc
        gate = loss_cfg.disc_weight if state.step >= loss_cfg.disc_start \
            else 0.0
        gen = (step_generator(DROPOUT_SEED, state.step)
               if cfg.dropout_p > 0 else None)
        zero = torch.zeros((), device=imgs.device)

        # the generator loss; the discriminator is frozen while it runs
        state.optimizer.zero_grad()
        disc.requires_grad_(False)
        recons, cb, indices = model(imgs.to(compute_dtype), train=True,
                                    generator=gen, remat=remat)
        imgs_f = imgs.float()
        rec = rec_loss_fn(loss_cfg.reconstruction_loss, imgs_f,
                          recons.float())
        p = lpips.mean(imgs_f.to(compute_dtype), recons, remat) \
            if use_lpips else zero
        adv = g_adv_fn(disc(recons).float()) if use_disc else zero
        if loss_cfg.disc_adaptive_weight:
            last = model.decoder.conv_out.weight
            nll = rw * rec + pw * p
            g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
            g_adv = torch.autograd.grad(adv, last, retain_graph=True)[0] \
                if use_disc else torch.zeros_like(last)
            d_adapt = (torch.linalg.vector_norm(g_nll)
                       / (torch.linalg.vector_norm(g_adv) + 1e-4)) \
                .clamp(0.0, 1e4).detach()
        else:
            d_adapt = torch.ones((), device=imgs.device)
        codebook = cb["vq"] + cb["commit"] + cb["entropy"]
        gen_loss = (rw * rec + pw * p + d_adapt * gate * adv
                    + loss_cfg.codebook_weight * codebook)
        gen_loss.backward()
        disc.requires_grad_(True)
        grad_norm = state.optimizer.step(state.step)

        # the discriminator on the real images and the detached recons
        if use_disc:
            state.disc_optimizer.zero_grad()
            logits_real = disc(imgs.to(compute_dtype))
            logits_fake = disc(recons.detach())
            disc_loss = gate * d_loss_fn(logits_real.float(),
                                         logits_fake.float())
            disc_loss.backward()
            disc_grad_norm = state.disc_optimizer.step(state.step)
            d_metrics = {"disc_loss": disc_loss.detach(),
                         "logits_real": logits_real.detach().float().mean(),
                         "logits_fake": logits_fake.detach().float().mean(),
                         "disc_grad_norm": disc_grad_norm}
        else:
            d_metrics = {k: zero for k in ("disc_loss", "logits_real",
                                           "logits_fake", "disc_grad_norm")}

        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, model, ema_decay)
        state.usage_window, usage = rolling_codebook_usage(
            state.usage_window, indices, cfg.codebook_size)
        state.step += 1
        metrics = {"gen_loss": gen_loss.detach(), "rec_loss": rec.detach(),
                   "perceptual_loss": p.detach(),
                   "gen_adv_loss": adv.detach(),
                   "vq_loss": cb["vq"].detach(),
                   "commit_loss": cb["commit"].detach(),
                   "entropy_loss": cb["entropy"].detach(),
                   "disc_adaptive_weight": d_adapt, **d_metrics,
                   "codebook_usage": usage, "grad_norm": grad_norm}
        return state, metrics

    return train_step


def build_trainer(cfg: VQConfig, loss_cfg: VQLossConfig,
                  device: torch.device, *, lr: float = 1e-4,
                  beta1: float = 0.9, beta2: float = 0.95,
                  max_grad_norm: float = 1.0, use_ema: bool = False,
                  ema_decay: float = 0.999, seed: int = 0,
                  lpips: Optional[LPIPS] = None, use_disc: bool = True,
                  compute_dtype: torch.dtype = torch.float32,
                  remat: bool = False) -> Tuple[VQTrainState, StepFn]:
    """A seeded VQ model (`vq.init_weights(seed)`) and discriminator
    (`discriminator.make_discriminator(seed=seed + 1)`) in f32 on
    `device`, their optimizers, the EMA and the step function (JAX
    `build_trainer`'s arguments without the mesh; LPIPS as a module)."""
    model = vq.init_weights(vq.VQModel(cfg, device=device, encoder=True),
                            seed=seed).train()
    disc = disc_lib.make_discriminator(loss_cfg.disc_type,
                                       loss_cfg.image_size, device=device,
                                       seed=seed + 1).train()
    state = init_vq_train_state(
        model, disc, make_vq_optimizer(model, lr, beta1, beta2,
                                       max_grad_norm),
        make_vq_optimizer(disc, lr, beta1, beta2, max_grad_norm), use_ema)
    step_fn = make_train_step(cfg, loss_cfg, lpips=lpips, use_disc=use_disc,
                              ema_decay=ema_decay if use_ema else None,
                              compute_dtype=compute_dtype, remat=remat)
    return state, step_fn
