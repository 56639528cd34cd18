"""The non-GAN train and eval steps (counterpart of
``vqvae_tpu/train/steps.py:276-377, 459-525``, the branch without a
``loss:`` block).

- Train: preprocess (with the augmentations when asked), ``forward(train=True)``
  (which advances the EMA quantizer's buffers), ``ae_loss = q_loss + l2``, one
  AdamW step at the LR set before it, and the usage histogram accumulated
  over the epoch (the reference keeps only the last batch, SURVEY §2.4).
- Eval: no augmentations, no optimizer, no EMA update; masked per-sample
  means, so zero-padded rows of a partial final batch count for nothing.

Single device; the JAX package's cross-replica means and sums are
multi-GPU work (ROADMAP.md queue A, item 13).
"""

from __future__ import annotations

import torch

from vqvae_tpu_torch.losses.losses import l1_loss, l2_loss
from vqvae_tpu_torch.models.preprocess import denormalize, preprocess_batch
from vqvae_tpu_torch.models.quantizers import count_code_usage
from vqvae_tpu_torch.train.optim import set_lr
from vqvae_tpu_torch.train.state import TrainState


def train_step(state: TrainState, raw_images: torch.Tensor, lr: float, augment: bool,
               image_size: int) -> dict:
    """One optimizer step on a [0,1] NHWC batch; updates ``state`` in place and
    returns its metrics as 0-d tensors (no host sync) and the LR it used."""
    set_lr(state.optimizer, lr)
    images = preprocess_batch(raw_images, state.generator, training=augment,
                              image_size=image_size)
    recon, q_loss, codes = state.model(images, train=True)
    l1 = l1_loss(recon, images)
    l2 = l2_loss(recon, images)
    loss = q_loss + l2
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.usage_count += count_code_usage(codes, state.usage_count.shape[0])
    state.step += 1
    return {"loss": loss.detach(), "l1_loss": l1.detach(), "l2_loss": l2.detach(),
            "quant_loss": q_loss.detach(), "lr": lr}


@torch.inference_mode()
def eval_step(state: TrainState, raw_images: torch.Tensor, mask: torch.Tensor):
    """[0,1] NHWC batch and (B,) bool mask -> (metrics, usage (N,) int32 of the
    valid rows, [0,1] NHWC reconstructions). Metrics are means over the rows
    with ``mask`` True, and ``n_valid`` their count."""
    images = preprocess_batch(raw_images)
    maskf = mask.float()
    recon, q_loss, codes = state.model(images, train=False, mask=mask)

    def masked_mean(per_sample):
        return (per_sample * maskf).sum() / maskf.sum().clamp(min=1.0)

    def per_sample_mean(x):
        return x.reshape(x.shape[0], -1).float().mean(1)

    l1_i = per_sample_mean((images - recon).abs())
    l2_i = per_sample_mean((images - recon) ** 2)
    n_valid = maskf.sum()
    metrics = {
        "loss": masked_mean(q_loss + l2_i), "l1_loss": masked_mean(l1_i),
        "l2_loss": masked_mean(l2_i),
        # the JAX step's cross-shard weighting of the masked q_loss, on one shard
        "quant_loss": q_loss * n_valid / n_valid.clamp(min=1.0),
        "n_valid": n_valid,
    }
    usage = count_code_usage(codes, state.usage_count.shape[0], mask=mask)
    return metrics, usage, denormalize(recon)
