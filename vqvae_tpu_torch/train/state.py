"""Training state (counterpart of ``vqvae_tpu/train/state.py``): everything a
train step touches, in one object. The JAX state is an immutable pytree
that each step replaces; here the step updates the models, the optimizers,
the generators and the usage histogram in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from vqvae_tpu_torch.models.discriminator import Discriminator
from vqvae_tpu_torch.models.vqvae import VQVAE


@dataclass
class TrainState:
    step: int                     # global step: the number of optimizer steps taken
    model: VQVAE                  # parameters and, for the EMA quantizer, its buffers
    optimizer: torch.optim.Optimizer
    generator: torch.Generator    # draws the augmentations, on the CPU
    usage_count: torch.Tensor     # (N,) int32 per-code usage since the last reset
    # the gumbel quantizer's noise, on the state's device, seeded from the seed
    noise_generator: Optional[torch.Generator] = None
    # GAN configs: the discriminator, its optimizer and its step count (its
    # LR schedule runs on disc_step + start_epoch * steps_per_epoch)
    disc: Optional[Discriminator] = None
    disc_optimizer: Optional[torch.optim.Optimizer] = None
    disc_step: int = 0
