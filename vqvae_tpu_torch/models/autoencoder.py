"""Conv ResNet encoder / decoder (counterpart of ``vqvae_tpu/models/autoencoder.py``).

NCHW inside, with the reference's torch module names, so that
``vqvae_tpu.utils.torch_convert`` and ``vqvae_tpu_torch.utils.convert`` map
weights both ways. The plain forms are carried: the JAX package's exact TPU
rewrites (pool folded into a stride-2 conv, upsample folded into an
lhs-dilated conv, the fused GN-SiLU VJP, the padded output conv) are not.

Spans (``utils/introspect.named_scope``): ``encoder`` and ``decoder``
around each module's forward, and ``norm_act`` in ``norm_act``, the helper
every GroupNorm -> SiLU pair goes through (the one place a fused kernel
would replace).

``remat=True`` checkpoints every ``ResBlock`` (the JAX modules' ``nn.remat``,
``vqvae_tpu/models/autoencoder.py:527,563``): its activations are recomputed
in the backward pass instead of being kept. The flag lives on the block, so
the module tree and the ``state_dict`` keys do not depend on it, and it acts
only where autograd records (``torch.is_grad_enabled()``): eval and serving
run the plain forward.

Precision policy as in the JAX package: fp32 parameters, convolutions in the
compute ``dtype``, GroupNorm statistics in fp32. Parameters are drawn with
torch's default conv init, U(+-1/sqrt(fan_in)) for kernels and biases, from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqvae_tpu_torch.utils.introspect import named_scope


class Conv2d(nn.Conv2d):
    """'same' conv that casts input and parameters to the compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, bias: bool,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                         bias=bias, device="meta")
        self.compute_dtype = dtype
        bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.weight = nn.Parameter(
            _uniform(self.weight.shape, bound, generator))
        if bias:
            self.bias = nn.Parameter(_uniform(self.bias.shape, bound, generator))

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) fp32, drawn on the CPU so that a seed gives the same
    weights on every device."""
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class GroupNorm(nn.Module):
    """GroupNorm with the unbiased variance (``/(n-1)``) and fp32 statistics
    (``vqvae_tpu/models/autoencoder.py:138-169``); ``nn.GroupNorm`` is biased.
    Output in the compute dtype.

    ``shards`` is None but while a height-sharded call runs
    (``parallel/spatial.py``): then each process holds rows of the image, and
    the two passes' sums (for the mean, then of the centred squares) are
    summed over the processes, so the statistics are the whole image's."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % num_groups != 0:
            raise ValueError("num_channels must be divisible by num_groups")
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.shards = None
        self.weight = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        n = (c // g) * h * w
        xg = x.float().reshape(b, g, n)
        if self.shards is None:
            mean = xg.mean(-1, keepdim=True)
        else:
            n *= self.shards.size
            mean = self.shards.sum(xg.sum(-1, keepdim=True)) / n
        centered = xg - mean
        squares = (centered * centered).sum(-1, keepdim=True)
        if self.shards is not None:
            squares = self.shards.sum(squares)
        var = squares / max(n - 1, 1)
        xf = (centered * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return (xf * self.weight + self.bias).to(self.dtype)


def norm_act(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """SiLU(norm(x)), under the span ``norm_act``."""
    with named_scope("norm_act"):
        return F.silu(norm(x))


class ResBlock(nn.Module):
    """Pre-activation residual block: (GN -> SiLU -> 3x3 conv) x 2, bias-free
    convs, 1x1 shortcut when channels change (reference autoencoder.py:42-77)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.norm1 = GroupNorm(in_ch, dtype=dtype)
        self.conv1 = Conv2d(in_ch, out_ch, 3, bias=False, dtype=dtype, generator=generator)
        self.norm2 = GroupNorm(out_ch, dtype=dtype)
        self.conv2 = Conv2d(out_ch, out_ch, 3, bias=False, dtype=dtype, generator=generator)
        self.conv_shortcut = (Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype,
                                     generator=generator)
                              if in_ch != out_ch else None)

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            # the block draws no random numbers: no RNG state to replay
            return checkpoint(self._forward, x, use_reentrant=False, preserve_rng_state=False)
        return self._forward(x)

    def _forward(self, x):
        residual = self.conv1(norm_act(self.norm1, x))
        residual = self.conv2(norm_act(self.norm2, residual))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + residual


class Downsample(nn.Module):
    """2x2 average pool, stride 2 (reference autoencoder.py:80-91)."""

    def forward(self, x):
        return F.avg_pool2d(x, 2)


class Upsample(nn.Module):
    """Nearest x2 then a 3x3 conv with bias (reference autoencoder.py:94-106)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, bias=True, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Encoder(nn.Module):
    """stem 3x3 -> per multiplier [num_res_blocks ResBlocks + Downsample] ->
    num_res_blocks final ResBlocks -> GN -> SiLU -> 1x1 conv; fp32 output
    (reference autoencoder.py:109-143). ``remat``: checkpoint each ResBlock."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_in = Conv2d(3, channels, 3, bias=False, dtype=dtype, generator=generator)
        blocks = []
        ch = channels
        for mult in channel_multipliers:
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(ch, channels * mult, dtype, generator, remat))
                ch = channels * mult
            blocks.append(Downsample())
        self.blocks = nn.Sequential(*blocks)
        self.final_residual = nn.Sequential(
            *[ResBlock(ch, ch, dtype, generator, remat) for _ in range(num_res_blocks)])
        self.norm = GroupNorm(ch, dtype=dtype)
        self.conv_out = Conv2d(ch, embedding_dim, 1, bias=True, dtype=dtype,
                               generator=generator)

    def forward(self, x):
        with named_scope("encoder", images=x.shape[0]):
            x = self.conv_in(x.to(self.dtype))
            x = self.final_residual(self.blocks(x))
            return self.conv_out(norm_act(self.norm, x)).float()


class Decoder(nn.Module):
    """Mirror of the encoder with nearest x2 upsampling and a final tanh in
    fp32 (reference autoencoder.py:146-180). ``remat``: checkpoint each
    ResBlock."""

    def __init__(self, channels: int, num_res_blocks: int,
                 channel_multipliers: Sequence[int], embedding_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        ch = channels * channel_multipliers[-1]
        self.conv_in = Conv2d(embedding_dim, ch, 3, bias=True, dtype=dtype,
                              generator=generator)
        self.initial_residual = nn.Sequential(
            *[ResBlock(ch, ch, dtype, generator, remat) for _ in range(num_res_blocks)])
        blocks = []
        for i in reversed(range(len(channel_multipliers))):
            ch_out = channels * channel_multipliers[i - 1] if i > 0 else channels
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(ch, ch_out, dtype, generator, remat))
                ch = ch_out
            blocks.append(Upsample(ch, dtype, generator))
        self.blocks = nn.Sequential(*blocks)
        self.norm = GroupNorm(ch, dtype=dtype)
        self.conv_out = Conv2d(ch, 3, 3, bias=True, dtype=dtype, generator=generator)

    def forward(self, x):
        with named_scope("decoder", images=x.shape[0]):
            x = self.conv_in(x.to(self.dtype))
            x = self.blocks(self.initial_residual(x))
            return torch.tanh(self.conv_out(norm_act(self.norm, x)).float())
