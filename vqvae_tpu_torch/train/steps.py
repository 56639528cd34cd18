"""The train and eval steps (counterpart of ``vqvae_tpu/train/steps.py:198-377,
459-525``).

- Train: preprocess (with the augmentations when asked), ``forward(train=True)``
  (which advances the EMA quantizer's buffers; the gumbel quantizer draws its
  noise from ``state.noise_generator``), the loss, one AdamW step at the LR
  set before it, and the usage histogram accumulated over the epoch (the
  reference keeps only the last batch, SURVEY §2.4). Without a ``loss:``
  block the loss is ``q_loss + l2``; with one, ``nll + q_loss`` where
  ``nll = l1 w1 + l2 w2 + lpips wp``.
- GAN (``gan=True``): one D forward on the reconstructions is shared by the
  generator loss, whose gradient reaches the autoencoder only, and the fake
  half of the D loss, whose gradient reaches D only (``make_paired_logits``):
  two backward passes over one graph, restricted by ``inputs=``. The real
  half of the D loss, with R1, is taken first, before the autoencoder's
  forward, so that its graph is freed before the larger one is built (the
  D loss is a sum of the two halves; D's gradients add up in ``.grad``).
  The first-order D calls run the module's fused backward when it has one;
  on an R1 step the real images go through the plain D (``fused=False``),
  and the penalty is ``r1_weight`` times the batch mean of
  ``|d sum(D(x)) / dx|^2`` taken with ``create_graph``, so its D gradient is
  a second-order one. Both optimizers step after every backward pass, so D
  sees pre-update reconstructions.
- Eval: no augmentations, no optimizer, no EMA update; masked per-sample
  means, so zero-padded rows of a partial final batch count for nothing;
  with the GAN active, the per-sample G and D losses of the plain D.

Single device; the JAX package's cross-replica means and sums are
multi-GPU work (ROADMAP.md queue A, item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vqvae_tpu_torch.config import AdversarialConf
from vqvae_tpu_torch.losses.losses import (discriminator_loss_half,
                                           discriminator_loss_per_sample, generator_loss,
                                           generator_loss_per_sample, l1_loss, l2_loss)
from vqvae_tpu_torch.models.preprocess import denormalize, preprocess_batch
from vqvae_tpu_torch.models.quantizers import count_code_usage
from vqvae_tpu_torch.train.optim import set_lr
from vqvae_tpu_torch.train.state import TrainState


@dataclass
class LossStack:
    """What a ``loss:`` block adds: the reconstruction weights, LPIPS
    (``lpips(x, y, reduce)``, or None where ``perc_weight == 0`` elides it)
    and the adversarial settings (None without a GAN)."""
    l1_weight: float
    l2_weight: float
    perc_weight: float
    lpips: Optional[Callable]
    adv: Optional[AdversarialConf]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float().mean(1)


def _perc(losses: LossStack, images, recon, reduce: bool) -> torch.Tensor:
    if losses.lpips is None:
        z = torch.zeros(images.shape[0], device=images.device)
        return z.mean() if reduce else z
    return losses.lpips(images, recon, reduce=reduce)


def train_step(state: TrainState, raw_images: torch.Tensor, lr: float, augment: bool,
               image_size: int, losses: Optional[LossStack] = None, gan: bool = False,
               r1: bool = False, d_lr: Optional[float] = None, temp: Optional[float] = None,
               kl_cost: Optional[float] = None) -> dict:
    """One optimizer step (two with the GAN) on a [0,1] NHWC batch; updates
    ``state`` in place and returns its metrics as 0-d tensors (no host sync)
    and the LR it used. ``temp`` / ``kl_cost``: the gumbel schedules' values."""
    set_lr(state.optimizer, lr)
    images = preprocess_batch(raw_images, state.generator, training=augment,
                              image_size=image_size)
    if gan:
        adv = losses.adv
        set_lr(state.disc_optimizer, d_lr)
        state.disc_optimizer.zero_grad(set_to_none=True)
        d_params = list(state.disc.parameters())
        real = _nchw(images).detach().requires_grad_(r1)
        logits_real = state.disc(real, fused=not r1)
        d_real = discriminator_loss_half(logits_real, True, adv.loss_type).mean()
        r1_penalty = torch.zeros((), device=images.device)
        if r1:
            (grad,) = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
            per_sample = grad.square().reshape(grad.shape[0], -1).sum(1)
            r1_penalty = adv.r1_reg_weight * per_sample.mean()
        (d_real + r1_penalty).backward(inputs=d_params)
        del logits_real, real
    recon, q_loss, codes = state.model(images, train=True, temp=temp, kl_cost=kl_cost,
                                       generator=state.noise_generator)
    l1 = l1_loss(recon, images)
    l2 = l2_loss(recon, images)
    state.optimizer.zero_grad(set_to_none=True)
    if losses is None:
        loss = q_loss + l2
        loss.backward()
        extra = {}
    else:
        perc = _perc(losses, images, recon, reduce=True)
        nll = l1 * losses.l1_weight + l2 * losses.l2_weight + perc * losses.perc_weight
        zero = torch.zeros((), device=images.device)
        g_loss = d_loss = g_weight = zero
        if gan:
            logits_fake = state.disc(_nchw(recon))   # shared by the G and D losses
            g_loss = generator_loss(logits_fake, adv.loss_type)
            g_weight = torch.tensor(adv.g_weight, device=images.device)
            loss = nll + g_loss * adv.g_weight + q_loss
            d_fake = discriminator_loss_half(logits_fake, False, adv.loss_type).mean()
            d_loss = d_real + d_fake
            d_fake.backward(inputs=d_params, retain_graph=True)
            loss.backward(inputs=[p for p in state.model.parameters() if p.requires_grad])
            state.disc_optimizer.step()
            state.disc_step += 1
        else:
            loss = nll + q_loss
            loss.backward()
        extra = {"perc_loss": perc.detach(), "gen_loss": g_loss.detach(),
                 "disc_loss": d_loss.detach(),
                 "r1_penalty": (r1_penalty if gan else zero).detach(), "g_weight": g_weight}
    state.optimizer.step()
    state.usage_count += count_code_usage(codes, state.usage_count.shape[0])
    state.step += 1
    metrics = {"loss": loss.detach(), "l1_loss": l1.detach(), "l2_loss": l2.detach(),
               "quant_loss": q_loss.detach(), **extra, "lr": lr}
    if temp is not None:
        metrics.update(gumbel_temperature=temp, gumbel_kl=kl_cost)
    return metrics


@torch.inference_mode()
def eval_step(state: TrainState, raw_images: torch.Tensor, mask: torch.Tensor,
              losses: Optional[LossStack] = None, gan: bool = False,
              temp: Optional[float] = None, kl_cost: Optional[float] = None,
              generator: Optional[torch.Generator] = None):
    """[0,1] NHWC batch and (B,) bool mask -> (metrics, usage (N,) int32 of the
    valid rows, [0,1] NHWC reconstructions). Metrics are means over the rows
    with ``mask`` True, and ``n_valid`` their count."""
    images = preprocess_batch(raw_images)
    maskf = mask.float()
    recon, q_loss, codes = state.model(images, train=False, mask=mask, temp=temp,
                                       kl_cost=kl_cost, generator=generator)

    def masked_mean(per_sample):
        return (per_sample * maskf).sum() / maskf.sum().clamp(min=1.0)

    l1_i = _per_sample_mean((images - recon).abs())
    l2_i = _per_sample_mean((images - recon) ** 2)
    n_valid = maskf.sum()
    extra = {}
    if losses is None:
        loss_i = q_loss + l2_i
    else:
        p_i = _perc(losses, images, recon, reduce=False)
        nll_i = l1_i * losses.l1_weight + l2_i * losses.l2_weight + p_i * losses.perc_weight
        g_i = d_i = torch.zeros_like(l1_i)
        if gan:
            adv = losses.adv
            logits_fake = state.disc(_nchw(recon), fused=False)
            g_i = generator_loss_per_sample(logits_fake, adv.loss_type)
            logits_real = state.disc(_nchw(images), fused=False)
            d_i = discriminator_loss_per_sample(logits_real, logits_fake, adv.loss_type)
            loss_i = nll_i + g_i * adv.g_weight + q_loss
        else:
            loss_i = nll_i + q_loss
        extra = {"perc_loss": masked_mean(p_i), "gen_loss": masked_mean(g_i),
                 "disc_loss": masked_mean(d_i)}
    metrics = {
        "loss": masked_mean(loss_i), "l1_loss": masked_mean(l1_i),
        "l2_loss": masked_mean(l2_i),
        # the JAX step's cross-shard weighting of the masked q_loss, on one shard
        "quant_loss": q_loss * n_valid / n_valid.clamp(min=1.0),
        **extra, "n_valid": n_valid,
    }
    usage = count_code_usage(codes, state.usage_count.shape[0], mask=mask)
    return metrics, usage, denormalize(recon)
