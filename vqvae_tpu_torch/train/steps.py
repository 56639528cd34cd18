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
  a second-order one. The backward passes through D that want no D
  gradient (toward the real images for R1, toward the decoder's last conv
  for the adaptive lambda, toward the autoencoder) run under
  ``ops.conv2d_resample.no_weight_gradients``, so D's convolutions form no
  weight gradient there. Both optimizers step once, after every backward pass
  of the step, so D sees pre-update reconstructions. With ``use_adaptive`` the generator
  loss's weight is the adaptive lambda (``_adaptive_g_weight``).
- Accumulation (``grad_accum_steps > 1``): the batch is taken in equal
  micro-batches, each at the weights before the step, its losses scaled by
  ``1 / accum`` into ``.grad`` (a mean of means), its graph freed before the
  next one is built; then one AdamW step per model. R1 is taken on every
  micro-batch of an R1 step. The EMA buffers advance once per micro-batch,
  as the JAX scan's carry does (a documented divergence from the
  reference, which never accumulates). Metrics are micro-batch means, usage
  their sum; every step reports the JAX step's nine metrics, 0 where a
  term is absent.
- Spans (``utils/introspect.named_scope``), per micro-batch: ``gan.d_real``,
  ``gan.r1_grad`` (R1 steps), ``gan.d_real_backward``, ``ae.forward``,
  ``gan.d_fake`` (the fake D forward, the G and D losses, adaptive lambda),
  ``gan.d_fake_backward`` and ``ae.backward``; then ``optim`` (the
  reductions, both AdamW steps) and ``usage`` (the usage count). A module's
  backward runs inside the phase span that calls it.
- Eval: no augmentations, no optimizer, no EMA update; masked per-sample
  means, so zero-padded rows of a partial final batch count for nothing;
  with the GAN active, the per-sample G and D losses of the plain D.

- Data parallel (a process group of one rank per card, ``parallel/dist.py``):
  each rank takes its own rows through the micro-batch loop, then the
  gradients of each model are averaged over the ranks once, before its
  optimizer steps (JAX ``steps.py:424-432``); the step's usage is summed
  and its metrics averaged (``g_weight`` stays each rank's own value,
  averaged as a metric only); the D's minibatch-std groups stay inside each
  rank's micro-batch. The eval step's masked means are global sums over
  global counts, and ``quant_loss`` is weighted by each rank's valid rows
  (JAX ``steps.py:471-522``). At world size 1 nothing is reduced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vqvae_tpu_torch.config import AdversarialConf
from vqvae_tpu_torch.losses.losses import (discriminator_loss_half,
                                           discriminator_loss_per_sample, generator_loss,
                                           generator_loss_per_sample, l1_loss, l2_loss)
from vqvae_tpu_torch.models.preprocess import denormalize, preprocess_batch, to_nchw
from vqvae_tpu_torch.models.quantizers import count_code_usage
from vqvae_tpu_torch.ops.conv2d_resample import no_weight_gradients
from vqvae_tpu_torch.parallel.dist import all_reduce_mean_, all_reduce_sum_
from vqvae_tpu_torch.train.optim import set_lr
from vqvae_tpu_torch.train.state import TrainState
from vqvae_tpu_torch.utils.introspect import named_scope


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


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float().mean(1)


def _perc(losses: LossStack, images, recon, reduce: bool) -> torch.Tensor:
    if losses.lpips is None:
        z = torch.zeros(images.shape[0], device=images.device)
        return z.mean() if reduce else z
    return losses.lpips(images, recon, reduce=reduce)


def _adaptive_g_weight(model, perc: torch.Tensor, g_loss: torch.Tensor,
                       g_weight: float) -> torch.Tensor:
    """Adaptive lambda (counterpart of ``vqvae_tpu/train/steps.py:296-322``):
    ``|d perc / dW| / (|d g_loss / dW| + 1e-8)``, clipped to [0, 1e4], times
    ``g_weight``, with W the decoder's last conv kernel and ``perc`` the
    unweighted LPIPS term (the reference's quirk). Both gradients are taken
    on the graph already built, and no gradient flows through the result."""
    w = model.decoder.conv_out.weight
    (gp,) = torch.autograd.grad(perc, w, retain_graph=True)
    (gg,) = torch.autograd.grad(g_loss, w, retain_graph=True)
    lam = torch.linalg.vector_norm(gp.float()) / (torch.linalg.vector_norm(gg.float()) + 1e-8)
    return (lam.clamp(0.0, 1e4) * g_weight).detach()


def _micro_step(state: TrainState, raw_images: torch.Tensor, augment: bool, image_size: int,
                losses: Optional[LossStack], gan: bool, r1: bool, temp, kl_cost,
                scale: float):
    """Forward and backward of one micro-batch at the weights before the
    step: each loss, times ``scale``, adds its gradient into ``.grad``. The
    graph is freed before returning. -> (detached metrics, codes)."""
    images = preprocess_batch(raw_images, state.generator, training=augment,
                              image_size=image_size)
    zero = torch.zeros((), device=images.device)
    d_real = r1_penalty = zero
    if gan:
        adv = losses.adv
        d_params = list(state.disc.parameters())
        with named_scope("gan.d_real"):
            real = to_nchw(images).detach().requires_grad_(r1)
            logits_real = state.disc(real, fused=not r1)
            d_real = discriminator_loss_half(logits_real, True, adv.loss_type).mean()
        if r1:
            with named_scope("gan.r1_grad"), no_weight_gradients():
                (grad,) = torch.autograd.grad(logits_real.sum(), real, create_graph=True)
                per_sample = grad.square().reshape(grad.shape[0], -1).sum(1)
                r1_penalty = adv.r1_reg_weight * per_sample.mean()
        with named_scope("gan.d_real_backward"):
            ((d_real + r1_penalty) * scale).backward(inputs=d_params)
        del logits_real, real
    with named_scope("ae.forward"):
        recon, q_loss, codes = state.model(images, train=True, temp=temp, kl_cost=kl_cost,
                                           generator=state.noise_generator)
    l1 = l1_loss(recon, images)
    l2 = l2_loss(recon, images)
    perc = g_loss = d_loss = g_weight = zero
    if losses is None:
        loss = q_loss + l2
        with named_scope("ae.backward"):
            (loss * scale).backward()
    else:
        perc = _perc(losses, images, recon, reduce=True)
        nll = l1 * losses.l1_weight + l2 * losses.l2_weight + perc * losses.perc_weight
        if gan:
            with named_scope("gan.d_fake"):
                logits_fake = state.disc(to_nchw(recon))   # shared by the G and D losses
                g_loss = generator_loss(logits_fake, adv.loss_type)
                if adv.use_adaptive:
                    with no_weight_gradients():
                        g_weight = _adaptive_g_weight(state.model, perc, g_loss, adv.g_weight)
                    loss = nll + g_loss * g_weight + q_loss
                else:
                    g_weight = torch.tensor(adv.g_weight, device=images.device)
                    loss = nll + g_loss * adv.g_weight + q_loss
                d_fake = discriminator_loss_half(logits_fake, False, adv.loss_type).mean()
                d_loss = d_real + d_fake
            with named_scope("gan.d_fake_backward"):
                (d_fake * scale).backward(inputs=d_params, retain_graph=True)
            with named_scope("ae.backward"), no_weight_gradients():
                (loss * scale).backward(
                    inputs=[p for p in state.model.parameters() if p.requires_grad])
        else:
            loss = nll + q_loss
            with named_scope("ae.backward"):
                (loss * scale).backward()
    metrics = {"loss": loss, "l1_loss": l1, "l2_loss": l2, "quant_loss": q_loss,
               "perc_loss": perc, "gen_loss": g_loss, "disc_loss": d_loss,
               "r1_penalty": r1_penalty, "g_weight": g_weight}
    return {k: v.detach() for k, v in metrics.items()}, codes


def train_step(state: TrainState, raw_images: torch.Tensor, lr: float, augment: bool,
               image_size: int, losses: Optional[LossStack] = None, gan: bool = False,
               r1: bool = False, d_lr: Optional[float] = None, temp: Optional[float] = None,
               kl_cost: Optional[float] = None, accum: int = 1) -> dict:
    """One optimizer step (two with the GAN) on a [0,1] NHWC batch, taken in
    ``accum`` equal micro-batches (counterpart of ``vqvae_tpu/train/steps.py:382-422``);
    updates ``state`` in place and returns its metrics as 0-d tensors (no
    host sync), each the mean over the micro-batches, and the LR it used.
    ``temp`` / ``kl_cost``: the gumbel schedules' values."""
    b = raw_images.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not divisible by grad_accum_steps={accum}")
    set_lr(state.optimizer, lr)
    state.optimizer.zero_grad(set_to_none=True)
    if gan:
        set_lr(state.disc_optimizer, d_lr)
        state.disc_optimizer.zero_grad(set_to_none=True)
    sums, codes = None, []
    for micro in raw_images.split(b // accum):
        metrics, micro_codes = _micro_step(state, micro, augment, image_size, losses, gan, r1,
                                           temp, kl_cost, 1.0 / accum)
        sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
        codes.append(micro_codes)
    with named_scope("optim"):
        # one reduction per step, after the micro-batch loop (JAX steps.py:424-438)
        all_reduce_mean_([p.grad for p in state.model.parameters()])
        if gan:
            all_reduce_mean_([p.grad for p in state.disc.parameters()])
        metrics = sums if accum == 1 else {k: v * (1.0 / accum) for k, v in sums.items()}
        all_reduce_mean_(metrics.values())
        state.optimizer.step()
        if gan:
            state.disc_optimizer.step()
            state.disc_step += 1
    # bincount makes the host wait for the card: counted once the steps are enqueued
    with named_scope("usage"):
        usage = count_code_usage(torch.cat(codes), state.usage_count.shape[0])
        all_reduce_sum_([usage])
        state.usage_count += usage
    state.step += 1
    metrics["lr"] = lr
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

    l1_i = _per_sample_mean((images - recon).abs())
    l2_i = _per_sample_mean((images - recon) ** 2)
    p_i = g_i = d_i = torch.zeros_like(l1_i)
    if losses is None:
        loss_i = q_loss + l2_i
    else:
        p_i = _perc(losses, images, recon, reduce=False)
        nll_i = l1_i * losses.l1_weight + l2_i * losses.l2_weight + p_i * losses.perc_weight
        if gan:
            adv = losses.adv
            logits_fake = state.disc(to_nchw(recon), fused=False)
            g_i = generator_loss_per_sample(logits_fake, adv.loss_type)
            logits_real = state.disc(to_nchw(images), fused=False)
            d_i = discriminator_loss_per_sample(logits_real, logits_fake, adv.loss_type)
            loss_i = nll_i + g_i * adv.g_weight + q_loss
        else:
            loss_i = nll_i + q_loss
    # masked sums and the valid count, summed over the ranks: the masked
    # means are global; q_loss, a per-rank masked mean, is weighted by each
    # rank's valid rows (JAX steps.py:498-518)
    n_valid = maskf.sum()
    weighted = {"loss": loss_i, "l1_loss": l1_i, "l2_loss": l2_i, "quant_loss": None,
                "perc_loss": p_i, "gen_loss": g_i, "disc_loss": d_i}
    sums = torch.stack([(q_loss * n_valid if v is None else (v * maskf).sum()).float()
                        for v in weighted.values()] + [n_valid])
    usage = count_code_usage(codes, state.usage_count.shape[0], mask=mask)
    all_reduce_sum_([sums, usage])
    metrics = dict(zip(weighted, (sums[:-1] / sums[-1].clamp(min=1.0)).unbind()))
    metrics["n_valid"] = sums[-1]
    return metrics, usage, denormalize(recon)
