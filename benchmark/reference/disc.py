"""The plain reference of the StyleGAN2 discriminator (resnet architecture,
as the VQGAN loss builds it: no conditioning, channel_base 32768,
channel_max 512, minibatch-std groups of 4) and of LPIPS with its VGG16
backbone, in plain PyTorch and float32, with the port's parameter names.

The discriminator's layers are the published ``bias_act``, ``upfirdn2d``
(the [1, 3, 3, 1] FIR, as one depthwise convolution of the padded input)
and ``conv2d_resample`` for the two cases the blocks use: a 3x3 conv after
an FIR pad-and-filter, at stride 2, and a 1x1 conv after an FIR
filter-and-downsample. Everything is differentiable twice, as the R1
penalty needs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import numerics

LRELU_GAIN = math.sqrt(2.0)
_FIR = torch.tensor([1.0, 3.0, 3.0, 1.0])


def _lrelu(x, gain):
    return torch.where(x >= 0, x, 0.2 * x) * gain


def fir(x, down: int, pad: int):
    """Pad by ``pad`` on every side, filter with the normalized 4x4 outer
    product of [1, 3, 3, 1], keep every ``down``-th sample."""
    f = torch.outer(_FIR, _FIR)
    f = (f / f.sum()).to(x.device)
    c = x.shape[1]
    x = F.pad(x, [pad] * 4)
    return numerics.conv2d(x, f[None, None].expand(c, 1, 4, 4), stride=down, groups=c)


class ConvLayer(nn.Module):
    """Equalized-LR conv: unit-normal weights scaled by 1/sqrt(fan_in)."""

    def __init__(self, cin, cout, k, bias=True, act="lrelu", down=1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.act, self.down, self.k = act, down, k
        self.gain = 1.0 / math.sqrt(cin * k * k)

    def forward(self, x, gain=1.0):
        w = self.weight * self.gain
        if self.down == 1:
            x = numerics.conv2d(x, w, padding=self.k // 2)
        elif self.k == 1:
            x = numerics.conv2d(fir(x, 2, 1), w)
        else:
            x = numerics.conv2d(fir(x, 1, 2), w, stride=2)
        if self.bias is not None:
            x = x + self.bias.reshape(1, -1, 1, 1)
        return _lrelu(x, LRELU_GAIN * gain) if self.act == "lrelu" else x * gain


class FCLayer(nn.Module):
    def __init__(self, cin, cout, act="linear"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.act, self.gain = act, 1.0 / math.sqrt(cin)

    def forward(self, x):
        x = numerics.matmul(x, (self.weight * self.gain).T) + self.bias
        return _lrelu(x, LRELU_GAIN) if self.act == "lrelu" else x


class Block(nn.Module):
    def __init__(self, tmp, out, fromrgb: bool):
        super().__init__()
        if fromrgb:
            self.fromrgb = ConvLayer(3, tmp, 1)
        self.conv0 = ConvLayer(tmp, tmp, 3)
        self.conv1 = ConvLayer(tmp, out, 3, down=2)
        self.skip = ConvLayer(tmp, out, 1, bias=False, act="linear", down=2)

    def forward(self, x, img):
        if hasattr(self, "fromrgb"):
            y = self.fromrgb(img)
            x = y if x is None else x + y
        g = math.sqrt(0.5)
        return self.skip(x, gain=g) + self.conv1(self.conv0(x), gain=g)


class Epilogue(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = ConvLayer(ch + 1, ch, 3)
        self.fc = FCLayer(ch * 16, ch, act="lrelu")
        self.out = FCLayer(ch, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        g = min(4, n)
        y = x.reshape(g, n // g, 1, c, h, w)
        y = ((y - y.mean(0, keepdim=True)).square().mean(0) + 1e-8).sqrt()
        y = y.mean((2, 3, 4)).reshape(1, n // g, 1, 1, 1).expand(g, n // g, 1, h, w)
        x = torch.cat([x, y.reshape(n, 1, h, w)], 1)
        return self.out(self.fc(self.conv(x).flatten(1)))


class Discriminator(nn.Module):
    def __init__(self, resolution: int, channel_base: int = 32768, channel_max: int = 512):
        super().__init__()
        self.resolutions = [2 ** i for i in range(int(math.log2(resolution)), 2, -1)]
        ch = {r: min(channel_base // r, channel_max) for r in self.resolutions + [4]}
        for r in self.resolutions:
            setattr(self, f"b{r}", Block(ch[r], ch[r // 2], r == resolution))
        self.b4 = Epilogue(ch[4])

    def forward(self, img):
        x = None
        for r in self.resolutions:
            x = getattr(self, f"b{r}")(x, img)
        return self.b4(x)


VGG16 = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _VGG(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for ch, n in VGG16:
            for _ in range(n):
                conv = nn.Module()
                conv.weight = nn.Parameter(torch.zeros(ch, cin, 3, 3))
                conv.bias = nn.Parameter(torch.zeros(ch))
                setattr(self, f"conv{i}", conv)
                cin, i = ch, i + 1

    def forward(self, x):
        taps, i = [], 0
        for stage, (_, n) in enumerate(VGG16):
            for _ in range(n):
                conv = getattr(self, f"conv{i}")
                x = F.relu(numerics.conv2d(x, conv.weight, conv.bias, padding=1))
                i += 1
            ss = x.square().sum(1, keepdim=True)
            # the unit normalization of each tap; a pixel whose channels are
            # all zero maps to zero, with a finite gradient
            taps.append(x / (ss.clamp(min=1e-30).sqrt() + 1e-10))
            if stage < len(VGG16) - 1:
                x = F.max_pool2d(x, 2)
        return taps


class LPIPS(nn.Module):
    """LPIPS-VGG of two NHWC batches in (-1, 1): the sum over taps of the
    spatial mean of lin-weighted squared differences, then the batch mean."""

    def __init__(self):
        super().__init__()
        self.net = _VGG()
        for i, (ch, _) in enumerate(VGG16):
            setattr(self, f"lin{i}", nn.Parameter(torch.zeros(ch, 1)))
        self.requires_grad_(False)

    def forward(self, x, y):
        shift = torch.tensor(_SHIFT, device=x.device)
        scale = torch.tensor(_SCALE, device=x.device)
        fx, fy = ((self.net(((im - shift) / scale).permute(0, 3, 1, 2))) for im in (x, y))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            lin = getattr(self, f"lin{i}")[:, 0]
            total = total + ((a - b).square() * lin[None, :, None, None]).sum(1).mean((1, 2))
        return total.mean()
