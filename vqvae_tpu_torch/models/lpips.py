"""LPIPS perceptual distance (counterpart of ``vqvae_tpu/models/lpips.py``,
reference lpips_pytorch), with its three backbones written in ``torch.nn``
(no torchvision):

- ``vgg``: VGG16 ``features`` up to relu5_3, five taps after relu{1_2, 2_2,
  3_3, 4_3, 5_3}, 2x2 max pools (the GAN configs' LPIPS);
- ``alex``: AlexNet ``features``, five taps after each ReLU, 3x3/2 max
  pools (floor), in the compute dtype (a ``loss:`` block without a GAN);
- ``squeeze``: squeezenet1_1 ``features`` with its ``Fire`` modules, seven
  taps, 3x3/2 max pools in ceil mode; always fp32, as the JAX module (it
  sets no dtype);
- inputs in (-1, 1) z-scored with the reference's shift and scale;
- each tap unit-normalized over channels (``_normalize_activation``: fp32
  statistics, result in the compute dtype, a hand-written backward);
- frozen ``lin{i}`` heads (C, 1); the distance is the sum over taps of the
  spatial mean of the lin-weighted squared differences, fp32.

The VGG and AlexNet backbones compute in ``dtype`` (the training compute
dtype, as the JAX ``Trainer`` builds them). Every parameter is frozen
(``requires_grad=False``); the input gradient still flows. Pretrained
weights come from the same converted ``.npz`` the JAX package reads
(``tools/convert_lpips_weights.py``); without it, ``init_lpips`` draws
seeded random weights and warns. The JAX package's opt-in VGG stage-1
rewrites (polyphase, tap VJP, fused pass) are not ported.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from vqvae_tpu_torch.models.preprocess import to_nchw
from vqvae_tpu_torch.utils.introspect import named_scope

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

VGG16_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
VGG16_CHANNELS = tuple(ch for ch, _ in VGG16_CFG)
ALEX_CHANNELS = (64, 192, 384, 256, 256)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)


class _NormalizeActivation(torch.autograd.Function):
    """``x / (sqrt(sum_c x^2) + eps)`` over dim 1 with the backward of
    ``vqvae_tpu/models/lpips.py:84-92``: it stays in x's dtype and is finite
    at pixels where every channel is 0 (autograd of the formula would give
    inf * 0 there)."""

    @staticmethod
    def forward(ctx, x, eps, out_dtype):
        ss = x.float().square().sum(1, keepdim=True)
        rt = ss.sqrt()
        inv = 1.0 / (rt + eps)
        ctx.save_for_backward(x, rt, inv)
        return (x * inv.to(x.dtype)).to(out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, rt, inv = ctx.saved_tensors
        ctc = ct.to(x.dtype)
        t = (ctc.float() * x.float()).sum(1, keepdim=True)
        scale = t * inv * inv / rt.clamp(min=1e-20)
        return ctc * inv.to(x.dtype) - x * scale.to(x.dtype), None, None


def normalize_activation(x: torch.Tensor, eps: float = 1e-10,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Channel unit-normalization of an NCHW tap (reference utils.py:6-8)."""
    return _NormalizeActivation.apply(x, float(eps), out_dtype)


def _conv(in_ch: int, out_ch: int, k: int, generator: Optional[torch.Generator],
          stride: int = 1, padding: int = 0) -> nn.Conv2d:
    """A conv with lecun-normal weights (the JAX package's random init's
    scale) and zero bias, drawn on the CPU from ``generator``."""
    conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding, device="meta")
    conv.weight = nn.Parameter(torch.randn(out_ch, in_ch, k, k, generator=generator)
                               / np.sqrt(k * k * in_ch))
    conv.bias = nn.Parameter(torch.zeros(out_ch))
    return conv


def _relu_conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.relu(F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                           stride=conv.stride, padding=conv.padding))


class VGG16Features(nn.Module):
    """VGG16 ``features`` up to relu5_3 (convs ``conv0`` .. ``conv12``),
    returning the five LPIPS taps."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        in_ch, idx = 3, 0
        for ch, n_convs in VGG16_CFG:
            for _ in range(n_convs):
                setattr(self, f"conv{idx}", _conv(in_ch, ch, 3, generator, padding=1))
                in_ch, idx = ch, idx + 1

    def forward(self, x):
        taps = []
        x = x.to(self.dtype)
        idx = 0
        for stage, (_, n_convs) in enumerate(VGG16_CFG):
            for _ in range(n_convs):
                x = _relu_conv(getattr(self, f"conv{idx}"), x, self.dtype)
                idx += 1
            taps.append(normalize_activation(x, out_dtype=self.dtype))
            if stage < len(VGG16_CFG) - 1:
                x = F.max_pool2d(x, 2)
        return taps


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features`` (``conv0`` .. ``conv4``), returning
    the five LPIPS taps (JAX ``lpips.py:365-391``)."""

    # (out channels, kernel, stride, padding, max-pool after the tap)
    CFG = ((64, 11, 4, 2, True), (192, 5, 1, 2, True), (384, 3, 1, 1, False),
           (256, 3, 1, 1, False), (256, 3, 1, 1, False))

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for i, (ch, k, stride, pad, _) in enumerate(self.CFG):
            setattr(self, f"conv{i}", _conv(in_ch, ch, k, generator, stride, pad))
            in_ch = ch

    def forward(self, x):
        taps = []
        x = x.to(self.dtype)
        for i, (*_, pool) in enumerate(self.CFG):
            x = _relu_conv(getattr(self, f"conv{i}"), x, self.dtype)
            taps.append(normalize_activation(x, out_dtype=self.dtype))
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return taps


class Fire(nn.Module):
    """SqueezeNet Fire module: squeeze 1x1, then expand 1x1 and 3x3,
    concatenated over channels (JAX ``lpips.py:394-406``)."""

    def __init__(self, in_ch: int, squeeze: int, expand: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.squeeze = _conv(in_ch, squeeze, 1, generator)
        self.expand1x1 = _conv(squeeze, expand, 1, generator)
        self.expand3x3 = _conv(squeeze, expand, 3, generator, padding=1)

    def forward(self, x):
        x = _relu_conv(self.squeeze, x, x.dtype)
        return torch.cat([_relu_conv(self.expand1x1, x, x.dtype),
                          _relu_conv(self.expand3x3, x, x.dtype)], dim=1)


class SqueezeNetFeatures(nn.Module):
    """torchvision squeezenet1_1 ``features``, returning the seven LPIPS taps
    (reference networks.py:67-74, JAX ``lpips.py:419-445``). The 3x3/2 pools
    are in ceil mode (``_max_pool_ceil`` there). fp32 whatever the compute
    dtype: the JAX module sets none."""

    # (name, squeeze, expand) of each Fire; a tap after the names in TAPS
    FIRES = (("fire1", 16, 64), ("fire2", 16, 64), ("fire3", 32, 128), ("fire4", 32, 128),
             ("fire5", 48, 192), ("fire6", 48, 192), ("fire7", 64, 256), ("fire8", 64, 256))
    TAPS = ("fire2", "fire4", "fire5", "fire6", "fire7", "fire8")
    POOL_AFTER = ("conv0", "fire2", "fire4")

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = _conv(3, 64, 3, generator, stride=2)
        in_ch = 64
        for name, squeeze, expand in self.FIRES:
            setattr(self, name, Fire(in_ch, squeeze, expand, generator))
            in_ch = 2 * expand

    def forward(self, x):
        x = _relu_conv(self.conv0, x.float(), torch.float32)
        taps = [normalize_activation(x)]
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        for name, _, _ in self.FIRES:
            x = getattr(self, name)(x)
            if name in self.TAPS:
                taps.append(normalize_activation(x))
            if name in self.POOL_AFTER:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        return taps


NETS = {"vgg": (VGG16Features, VGG16_CHANNELS), "alex": (AlexNetFeatures, ALEX_CHANNELS),
        "squeeze": (SqueezeNetFeatures, SQUEEZE_CHANNELS)}


class LPIPS(nn.Module):
    """LPIPS(x, y) for NHWC images in (-1, 1) (reference modules/lpips.py:8-38);
    ``reduce=False`` gives the per-sample distances (B,). Frozen.

    Built on the CPU from ``generator``, then moved to ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, net_type: str = "vgg", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if net_type not in NETS:
            raise NotImplementedError(
                f"LPIPS net_type {net_type!r} not supported (vgg | alex | squeeze)")
        features, channels = NETS[net_type]
        self.net = features(dtype, generator)
        for i, ch in enumerate(channels):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(ch, 1)))
        self.requires_grad_(False)
        self.to(device)

    def _z_score(self, im: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=im.device)
        scale = torch.tensor(_SCALE, device=im.device)
        return to_nchw((im.float() - shift) / scale)

    def forward(self, x: torch.Tensor, y: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """Under the span ``lpips`` (the forward; the backward runs in the
        caller's)."""
        with named_scope("lpips", images=x.shape[0]):
            feat_x = self.net(self._z_score(x))
            feat_y = self.net(self._z_score(y))
            total = 0.0
            for i, (fx, fy) in enumerate(zip(feat_x, feat_y)):
                diff = (fx - fy) ** 2
                lin = getattr(self, f"lin{i}")[:, 0].to(diff.dtype).float()
                # products of the tap-dtype values, summed in fp32
                weighted = (diff.float() * lin[None, :, None, None]).sum(1)
                total = total + weighted.mean((1, 2))
            return total.mean() if reduce else total


def lpips_weights_path(net_type: str) -> Path:
    """Where the converted weights live: ``$VQVAE_TPU_LPIPS_WEIGHTS_DIR`` or
    ``~/.cache/vqvae_tpu``, file ``lpips_<net>.npz`` (the JAX package's rule)."""
    env = os.environ.get("VQVAE_TPU_LPIPS_WEIGHTS_DIR")
    base = Path(env) if env else Path.home() / ".cache" / "vqvae_tpu"
    return base / f"lpips_{net_type}.npz"


def _unflatten(flat: dict) -> dict:
    params: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return params


def init_lpips(net_type: str = "vgg", seed: int = 0, dtype: torch.dtype = torch.float32,
               device="cuda", params: Optional[dict] = None) -> LPIPS:
    """A frozen LPIPS on ``device`` (the card unless asked otherwise):
    ``params`` (a JAX-layout tree) if given, else the converted ``.npz`` at
    ``lpips_weights_path`` if present, else random weights drawn from
    ``seed``, with a warning."""
    from vqvae_tpu_torch.utils.convert import convert_lpips_params
    module = LPIPS(net_type, dtype, torch.Generator().manual_seed(seed), device=device)
    if params is None:
        path = lpips_weights_path(net_type)
        if path.exists():
            params = _unflatten(dict(np.load(path)))
        else:
            warnings.warn(f"LPIPS pretrained weights not found at {path}; using random init. "
                          "Run tools/convert_lpips_weights.py for quality-parity training.")
    if params is not None:
        module.load_state_dict(convert_lpips_params(params), strict=True)
    return module
