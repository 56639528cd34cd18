"""Reconstruction and GAN losses (counterpart of ``vqvae_tpu/losses/losses.py``,
reference loss.py:11-51). The R1 penalty is composed in ``train/steps.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - recon).abs().mean()


def l2_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((target - recon) ** 2).mean()


def generator_loss_per_sample(logits_fake: torch.Tensor, loss_type: str = "hinge"):
    """(B,) generator adversarial loss; the trainer's is its batch mean."""
    if loss_type == "hinge":
        per = -logits_fake
    elif loss_type == "non-saturating":
        per = F.softplus(-logits_fake)   # BCE-with-logits against ones
    else:
        raise ValueError(f"unknown loss_type: {loss_type}")
    return per.reshape(per.shape[0], -1).mean(1)


def generator_loss(logits_fake: torch.Tensor, loss_type: str = "hinge"):
    return generator_loss_per_sample(logits_fake, loss_type).mean()


def discriminator_loss_half(logits: torch.Tensor, real: bool, loss_type: str = "hinge"):
    """(B,) real-image or fake-image term of the discriminator loss."""
    if loss_type == "hinge":
        per = F.relu(1.0 - logits) if real else F.relu(1.0 + logits)
    elif loss_type == "non-saturating":
        # BCE against ones (real) or zeros (fake)
        per = F.softplus(-logits) if real else F.softplus(logits)
    else:
        raise ValueError(f"unknown loss_type: {loss_type}")
    return per.reshape(per.shape[0], -1).mean(1)


def discriminator_loss_per_sample(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                                  loss_type: str = "hinge"):
    """(B,) discriminator adversarial loss."""
    return (discriminator_loss_half(logits_real, True, loss_type)
            + discriminator_loss_half(logits_fake, False, loss_type))


def discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
                       loss_type: str = "hinge"):
    return discriminator_loss_per_sample(logits_real, logits_fake, loss_type).mean()
