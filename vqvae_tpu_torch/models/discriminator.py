"""StyleGAN2 discriminator, resnet architecture (counterpart of
``vqvae_tpu/models/discriminator.py``, reference discriminator.py:92-412 as
the VQGAN loss builds it: c_dim 0, channel_base 32768, channel_max 512, no
fp16 layers, no conv clamp).

NCHW, contiguous, with the reference's torch module names (``b{res}.fromrgb``
/ ``conv0`` / ``conv1`` / ``skip``, ``b4.conv`` / ``fc`` / ``out``) and
parameter layouts (conv OIHW, FC (out, in), ``b4.fc`` over the NCHW flatten),
so that ``vqvae_tpu/utils/torch_convert.py::convert_discriminator_state_dict``
reads the port's state dict and ``utils.convert.convert_discriminator_params``
writes it. Equalized learning rate: unit-normal weights, ``1/sqrt(fan_in)``
gains at run time. The blocks compute in ``dtype``; the epilogue in fp32.

``fused_dbwd`` / ``fused_skip`` route each block's bias-act-blur span and its
input fan-out through ``ops.fused_dbwd``'s Functions, whose backwards are the
kernels B3 and B4: the same parameters and forward, another backward, first
order only. ``forward(img, fused=False)`` runs the plain module, as the R1
penalty must.

``remat=True`` checkpoints every block (the JAX module's ``nn.remat``,
``vqvae_tpu/models/discriminator.py:285``) where autograd records; the
epilogue stays plain, as there. The checkpoint is the non-reentrant one,
which the R1 penalty's ``autograd.grad(create_graph=True)`` and
``backward(inputs=...)`` go through; recomputing a fused block's forward
launches no kernel (B3 / B4 are its backward).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqvae_tpu_torch.ops.bias_act import activation_funcs, bias_act
from vqvae_tpu_torch.ops.conv2d_resample import conv2d, conv2d_resample
from vqvae_tpu_torch.ops.fused_dbwd import TAPS, FusedActBlur, FusedSkipFanout
from vqvae_tpu_torch.ops.upfirdn2d import setup_filter

RESAMPLE_FILTER = (1, 3, 3, 1)


class FullyConnectedLayer(nn.Module):
    """Equalized-LR linear layer (reference discriminator.py:92-121)."""

    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(out_features, in_features, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.weight_gain = 1.0 / math.sqrt(in_features)

    def forward(self, x):
        w = (self.weight * self.weight_gain).to(self.dtype)
        return bias_act(x.to(self.dtype) @ w.T, self.bias, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with FIR resampling and bias_act
    (reference discriminator.py:127-174)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels, kernel_size,
                                               kernel_size, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
        self.filter = (setup_filter(RESAMPLE_FILTER) if up > 1 or down > 1 else None)

    def _act(self, x, gain: float):
        act_gain = activation_funcs[self.activation].def_gain * gain
        return bias_act(x, self.bias, act=self.activation, gain=act_gain)

    def _w(self):
        return (self.weight * self.weight_gain).to(self.dtype)

    def forward(self, x, gain: float = 1.0):
        x = conv2d_resample(x.to(self.dtype), self._w(), f=self.filter, up=self.up,
                            down=self.down, padding=self.kernel_size // 2,
                            flip_weight=(self.up == 1))
        return self._act(x, gain)

    def preact(self, x):
        """-> (conv output before its bias, the fp32 bias): the fused span
        rebuilds only ``lrelu * def_gain`` from them."""
        assert self.up == 1 and self.down == 1 and self.kernel_size > 1
        return conv2d(x.to(self.dtype), self._w(), padding=self.kernel_size // 2), self.bias

    def pre_filtered(self, x, gain: float = 1.0):
        """The conv of an input the FIR already filtered: stride 1 for a 1x1
        kernel (its FIR carried the down-2), else stride ``down``."""
        assert self.down > 1 and self.up == 1
        stride = 1 if self.kernel_size == 1 else self.down
        return self._act(conv2d(x.to(self.dtype), self._w(), stride=stride), gain)


class DiscriminatorBlock(nn.Module):
    """Residual down-2 block (reference discriminator.py:180-265)."""

    def __init__(self, tmp_channels: int, out_channels: int, has_fromrgb: bool,
                 img_channels: int = 3, activation: str = "lrelu",
                 dtype: torch.dtype = torch.float32, fused_dbwd: bool = False,
                 fused_skip: bool = False, generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.dtype = dtype
        self.activation = activation
        self.fused_dbwd = fused_dbwd
        self.fused_skip = fused_skip
        g = generator
        if has_fromrgb:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation=activation,
                                       dtype=dtype, generator=g)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation=activation,
                                 dtype=dtype, generator=g)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation=activation,
                                 down=2, dtype=dtype, generator=g)
        self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2,
                                dtype=dtype, generator=g)
        self.has_fromrgb = has_fromrgb

    def forward(self, x, img, fused: bool = True):
        if self.remat and torch.is_grad_enabled():
            # the block draws no random numbers: no RNG state to replay
            return checkpoint(self._forward, x, img, fused, use_reentrant=False,
                              preserve_rng_state=False)
        return self._forward(x, img, fused)

    def _forward(self, x, img, fused: bool):
        if self.has_fromrgb:
            y = self.fromrgb(img)
            x = x + y if x is not None else y
        gain = math.sqrt(0.5)
        if fused and self.fused_skip:
            x, ys = FusedSkipFanout.apply(x.to(self.dtype).contiguous(), TAPS)
            skip = self.skip.pre_filtered(ys, gain=gain)
        else:
            skip = self.skip(x, gain=gain)
        if fused and self.fused_dbwd and self.activation == "lrelu":
            p0, b0 = self.conv0.preact(x)
            spec = activation_funcs["lrelu"]
            y = FusedActBlur.apply(p0.contiguous(), b0, TAPS, spec.def_alpha, spec.def_gain)
            x = self.conv1.pre_filtered(y, gain=gain)
        else:
            x = self.conv1(self.conv0(x), gain=gain)
        return skip + x


def minibatch_std(x: torch.Tensor, group_size: Optional[int] = 4,
                  num_channels: int = 1) -> torch.Tensor:
    """Append the per-group feature stddev (reference discriminator.py:271-293),
    NCHW. Groups are strided: sample b joins b mod (N/G) and b +- k N/G."""
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    y = x.reshape(g, n // g, f, c // f, h, w).float()
    y = y - y.mean(0, keepdim=True)
    y = (y * y).mean(0)
    y = (y + 1e-8).sqrt()
    y = y.mean((2, 3, 4)).to(x.dtype)             # (n/g, f)
    y = y.reshape(1, n // g, f, 1, 1).expand(g, n // g, f, h, w).reshape(n, f, h, w)
    return torch.cat([x, y], 1)


class DiscriminatorEpilogue(nn.Module):
    """mbstd -> conv 3x3 -> FC -> 1 logit, in fp32 (reference
    discriminator.py:299-354)."""

    def __init__(self, in_channels: int, resolution: int = 4, mbstd_group_size: int = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation=activation, generator=generator)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation, generator=generator)
        self.out = FullyConnectedLayer(in_channels, 1, generator=generator)

    def forward(self, x):
        x = x.float()
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        return self.out(self.fc(x.flatten(1)))


class Discriminator(nn.Module):
    """Full-image StyleGAN2 discriminator (reference discriminator.py:360-412):
    ``channels[res] = min(channel_base // res, channel_max)``, blocks from
    ``img_resolution`` down to 8, the epilogue at 4. Takes NCHW images in
    (-1, 1), returns (B, 1) fp32 logits.

    The weights are drawn on the CPU from ``seed`` (the same on every device),
    then moved to ``device``, the card unless the caller asks for the CPU.
    ``remat``: checkpoint each block."""

    def __init__(self, img_resolution: int, img_channels: int = 3, channel_base: int = 32768,
                 channel_max: int = 512, activation: str = "lrelu",
                 dtype: torch.dtype = torch.float32, fused_dbwd: bool = False,
                 fused_skip: bool = False, seed: int = 0, device="cuda", remat: bool = False):
        super().__init__()
        generator = torch.Generator().manual_seed(seed)
        res_log2 = int(math.log2(img_resolution))
        assert 2 ** res_log2 == img_resolution, "image size must be a power of 2"
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.block_resolutions + [4]}
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels[res], channels[res // 2],
                has_fromrgb=(res == img_resolution), img_channels=img_channels,
                activation=activation, dtype=dtype, fused_dbwd=fused_dbwd,
                fused_skip=fused_skip, generator=generator, remat=remat))
        self.b4 = DiscriminatorEpilogue(channels[4], activation=activation, generator=generator)
        self.to(device)

    def set_fused(self, fused_dbwd: bool, fused_skip: bool) -> None:
        """Switch the first-order backward of every block (same parameters)."""
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            block.fused_dbwd, block.fused_skip = fused_dbwd, fused_skip

    def forward(self, img: torch.Tensor, fused: bool = True) -> torch.Tensor:
        """``fused=False`` takes the plain path in every block, whatever the
        module's ``fused_dbwd`` / ``fused_skip``."""
        x = None
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x, img, fused=fused)
        return self.b4(x)
