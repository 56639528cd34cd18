"""Reconstruction losses (counterpart of ``vqvae_tpu/losses/losses.py:16-21``);
the GAN losses come with the VQGAN slice."""

from __future__ import annotations

import torch


def l1_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (target - recon).abs().mean()


def l2_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((target - recon) ** 2).mean()
