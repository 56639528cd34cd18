"""The optimizers (counterpart of ``vqvae_tpu/train/optim.py``): the
autoencoder's AdamW with the reference's decay / no-decay split (reference
model.py:372-410), and the discriminator's, with decay on every parameter.

Weight decay applies to convolution kernels only; biases, GroupNorm scales
and biases and the codebook get none. The JAX package finds the kernels as
the 4-D leaves of its parameter tree; here GroupNorm's parameters are 4-D
too ((1, C, 1, 1)), so the split goes by module: the ``weight`` of every
``nn.Conv2d``. Every parameter trains (PARITY.md §2.4: the reference's
name-collision drops most of the encoder, the port does not). Buffers, such
as the EMA quantizer's, never enter the optimizer.

With betas (0, 0.99) AdamW's first moment is the gradient itself; the JAX
package drops that moment from its state (``scale_by_adam_b1zero``), which
changes no value. ``torch.optim.AdamW`` keeps it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies (conv kernels)."""
    kernels = {id(m.weight) for m in model.modules() if isinstance(m, nn.Conv2d)}
    return {name: id(p) in kernels for name, p in model.named_parameters()}


def make_ae_optimizer(model: nn.Module, betas, eps: float,
                      weight_decay: float) -> torch.optim.AdamW:
    """AdamW over every parameter of ``model`` in two groups, decay and no
    decay. The LR is set before each step with ``set_lr``."""
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if mask[n]],
         "weight_decay": float(weight_decay)},
        {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(float(b) for b in betas),
                             eps=float(eps))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """One LR for every param group (reference model.py:202-216)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_disc_optimizer(disc: nn.Module, betas, eps: float,
                        weight_decay: float) -> torch.optim.AdamW:
    """The discriminator's AdamW: weight decay on every parameter
    (reference model.py:431-434). The LR is set before each step."""
    return torch.optim.AdamW(disc.parameters(), lr=0.0, betas=tuple(float(b) for b in betas),
                             eps=float(eps), weight_decay=float(weight_decay))
