"""Bias + activation + gain + clamp (counterpart of ``vqvae_tpu/ops/bias_act.py``).

Plain PyTorch ops, twice differentiable (the R1 penalty differentiates the
discriminator twice). The activation table is the reference's: names,
default alpha and gain. The bias broadcasts over dim 1, the channel dim of
NCHW activations and of (B, C) features.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class _Act(NamedTuple):
    fn: Callable
    def_alpha: float
    def_gain: float


def lrelu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``where(x >= 0, x, alpha x)``: slope 1 at 0, as ``jax.nn.leaky_relu``
    (``F.leaky_relu``'s gradient takes the alpha branch at 0)."""
    return torch.where(x >= 0, x, x * alpha)


activation_funcs = {
    "linear": _Act(lambda x, alpha: x, 0.0, 1.0),
    "relu": _Act(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2)),
    "lrelu": _Act(lrelu, 0.2, math.sqrt(2)),
    "tanh": _Act(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _Act(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _Act(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _Act(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _Act(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _Act(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(gain * act(x + b)); ``b`` (C,) is cast to x's dtype and
    added over dim 1."""
    spec = activation_funcs[act]
    alpha = spec.def_alpha if alpha is None else float(alpha)
    gain = spec.def_gain if gain is None else float(gain)
    if b is not None:
        x = x + b.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
