"""Training state (counterpart of ``vqvae_tpu/train/state.py``): everything a
train step touches, in one object. The JAX state is an immutable pytree
that each step replaces; here the step updates the model, the optimizer,
the generator and the usage histogram in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vqvae_tpu_torch.models.vqvae import VQVAE


@dataclass
class TrainState:
    step: int                     # global step: the number of optimizer steps taken
    model: VQVAE                  # parameters and, for the EMA quantizer, its buffers
    optimizer: torch.optim.Optimizer
    generator: torch.Generator    # draws the augmentations, on the CPU
    usage_count: torch.Tensor     # (N,) int32 per-code usage since the last reset
