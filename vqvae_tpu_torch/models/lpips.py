"""LPIPS perceptual distance with the VGG16 backbone (counterpart of the VGG
path of ``vqvae_tpu/models/lpips.py``, reference lpips_pytorch).

- VGG16 ``features`` up to relu5_3 written in ``torch.nn`` (no torchvision),
  five taps after relu{1_2, 2_2, 3_3, 4_3, 5_3}, 2x2 max pools;
- inputs in (-1, 1) z-scored with the reference's shift and scale;
- each tap unit-normalized over channels (``_normalize_activation``: fp32
  statistics, result in the compute dtype, a hand-written backward);
- frozen ``lin{i}`` heads (C, 1); the distance is the sum over taps of the
  spatial mean of the lin-weighted squared differences, fp32.

The backbone computes in ``dtype`` (the training compute dtype, as the JAX
``Trainer`` builds it). Every parameter is frozen (``requires_grad=False``);
the input gradient still flows. Pretrained weights come from the same
converted ``.npz`` the JAX package reads (``tools/convert_lpips_weights.py``);
without it, ``init_lpips`` draws seeded random weights and warns.
The AlexNet and SqueezeNet backbones and the JAX package's opt-in stage-1
rewrites are not ported (ROADMAP.md queue A).
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

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

VGG16_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
VGG16_CHANNELS = tuple(ch for ch, _ in VGG16_CFG)


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
                conv = nn.Conv2d(in_ch, ch, 3, padding=1, device="meta")
                # lecun-normal scale, as the JAX package's random init
                conv.weight = nn.Parameter(torch.randn(ch, in_ch, 3, 3, generator=generator)
                                           / np.sqrt(9 * in_ch))
                conv.bias = nn.Parameter(torch.zeros(ch))
                setattr(self, f"conv{idx}", conv)
                in_ch, idx = ch, idx + 1

    def forward(self, x):
        taps = []
        x = x.to(self.dtype)
        idx = 0
        for stage, (_, n_convs) in enumerate(VGG16_CFG):
            for _ in range(n_convs):
                conv = getattr(self, f"conv{idx}")
                x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                    padding=1))
                idx += 1
            taps.append(normalize_activation(x, out_dtype=self.dtype))
            if stage < len(VGG16_CFG) - 1:
                x = F.max_pool2d(x, 2)
        return taps


class LPIPS(nn.Module):
    """LPIPS(x, y) for NHWC images in (-1, 1) (reference modules/lpips.py:8-38);
    ``reduce=False`` gives the per-sample distances (B,). Frozen.

    Built on the CPU from ``generator``, then moved to ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, net_type: str = "vgg", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if net_type != "vgg":
            raise NotImplementedError(
                f"LPIPS net_type {net_type!r} is not ported yet (ROADMAP.md queue A, item 9): "
                "the port carries the VGG16 backbone")
        self.net = VGG16Features(dtype, generator)
        for i, ch in enumerate(VGG16_CHANNELS):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(ch, 1)))
        self.requires_grad_(False)
        self.to(device)

    def _z_score(self, im: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=im.device)
        scale = torch.tensor(_SCALE, device=im.device)
        return ((im.float() - shift) / scale).permute(0, 3, 1, 2).contiguous()

    def forward(self, x: torch.Tensor, y: torch.Tensor, reduce: bool = True) -> torch.Tensor:
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
