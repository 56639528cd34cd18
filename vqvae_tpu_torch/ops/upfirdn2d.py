"""upfirdn2d: zero-stuff upsample, pad (negative = crop), FIR-filter and
downsample a batch of NCHW images (counterpart of ``vqvae_tpu/ops/upfirdn2d.py``).

The whole pipeline is one depthwise ``F.conv2d`` (``groups=C``) on the
stuffed, padded input. As in the JAX package, the up-``k`` path puts
``k - 1`` zeros *after* each pixel (``H * up`` samples), padding is applied
to the upsampled image, and the filter is cast to the input's dtype (made
on the input's device once per filter and dtype: ``_filter_tensor``).

Derivatives (the reference's ``upfirdn2d`` Function, whose backward is
again ``upfirdn2d``): the depthwise conv is ``_FIRConv``, whose backward is
its adjoint ``_FIRConvT`` (the depthwise conv's input gradient), whose
backward is ``_FIRConv`` again. So a derivative of any order (R1 takes the
second) is the filter's forward or transposed depthwise conv at the
layer's own size; the filter is a constant and its gradient is never
formed (autograd's generic double backward forms it as one batch-1
convolution per channel with an image-sized kernel). The stuffing, pads
and crops around the conv are plain autograd ops. ``second_order.calls``
counts entries into ``_FIRConvT.backward`` and, in ``conv2d_resample``,
``_Conv2dInput.backward``: the backward passes of a second-order pass.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Scaling = Union[int, Sequence[int]]
Padding = Union[int, Sequence[int]]

second_order = SimpleNamespace(calls=0)


class _FIRConv(torch.autograd.Function):
    """Depthwise conv of x (B, C, H, W) with the constant filter ``weight``
    (C, 1, fh, fw) at ``stride`` (sy, sx); its backward is ``_FIRConvT``."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        assert not weight.requires_grad, "the FIR filter is a constant"
        ctx.save_for_backward(weight)
        ctx.stride, ctx.in_shape = stride, x.shape
        return F.conv2d(x, weight, stride=stride, groups=x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        (weight,) = ctx.saved_tensors
        if not torch.is_grad_enabled():   # first order only: no node to record
            return _fir_conv_t(dy, weight, ctx.stride, ctx.in_shape), None, None
        return _FIRConvT.apply(dy, weight, ctx.stride, ctx.in_shape), None, None


def _fir_conv_t(dy, weight, stride, in_shape):
    """The depthwise conv's input gradient: dy -> dx of shape ``in_shape``."""
    return torch.nn.grad.conv2d_input(in_shape, weight, dy, stride=stride, groups=in_shape[1])


class _FIRConvT(torch.autograd.Function):
    """The adjoint of ``_FIRConv``: dy -> its input gradient, of shape
    ``in_shape``; its backward is ``_FIRConv``."""

    @staticmethod
    def forward(ctx, dy, weight, stride, in_shape):
        ctx.save_for_backward(weight)
        ctx.stride = stride
        return _fir_conv_t(dy, weight, stride, in_shape)

    @staticmethod
    def backward(ctx, ddx):
        second_order.calls += 1
        (weight,) = ctx.saved_tensors
        return _FIRConv.apply(ddx, weight, ctx.stride), None, None, None


def _parse_scaling(scaling: Scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding: Padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1,
                 separable: Optional[bool] = None) -> np.ndarray:
    """Prepare a FIR filter (reference upfirdn2d.py:72-116): unit DC gain,
    optional flip, scaled by ``gain ** (ndim / 2)``; a numpy array."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[tuple(slice(None, None, -1) for _ in range(f.ndim))]
    return f * (gain ** (f.ndim / 2))


def get_filter_size(f):
    """(width, height) of a filter; (1, 1) for None."""
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def _depthwise_fir(x, f2d, up, down, pads, flip_filter):
    upx, upy = up
    downx, downy = down
    padx0, padx1, pady0, pady1 = pads
    b, c, h, w = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(b, c, h * upy, w * upx)
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0):x.shape[2] - max(-pady1, 0),
          max(-padx0, 0):x.shape[3] - max(-padx1, 0)]
    f2d = np.asarray(f2d, dtype=np.float32)
    f = _filter_tensor(tuple(f2d.ravel().tolist()), f2d.shape, flip_filter, x.dtype, x.device)
    weight = f[None, None].expand(c, 1, *f.shape)
    return _FIRConv.apply(x, weight, (downy, downx))


@functools.lru_cache(maxsize=64)
def _filter_tensor(taps: tuple, shape, flip_filter: bool, dtype, device) -> torch.Tensor:
    """A float32 2-D filter's taps as a tensor of ``dtype`` on ``device``,
    flipped unless ``flip_filter`` (conv2d correlates; the flip makes it a
    convolution). Made once per filter: a copy from host memory makes the
    host wait for the device's stream, once per FIR call if made there. Never
    an inference tensor, which a later training step could not save."""
    with torch.inference_mode(False):
        f = torch.tensor(taps, dtype=torch.float32).reshape(shape).to(device=device, dtype=dtype)
        return f if flip_filter else f.flip([0, 1])


def upfirdn2d(x: torch.Tensor, f, up: Scaling = 1, down: Scaling = 1, padding: Padding = 0,
              flip_filter: bool = False, gain: float = 1) -> torch.Tensor:
    """Pad / upsample / filter / downsample NCHW images (reference
    upfirdn2d.py:120-208). ``f``: numpy 2-D filter, or 1-D for two separable
    passes (vertical, then horizontal); None is the identity."""
    assert x.dim() == 4
    if f is None:
        f = np.ones((1, 1), dtype=np.float32)
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    f = f * (gain ** (f.ndim / 2))
    if f.ndim == 1:
        y = _depthwise_fir(x, f[:, None], (1, upy), (1, downy), (0, 0, pady0, pady1),
                           flip_filter)
        return _depthwise_fir(y, f[None, :], (upx, 1), (downx, 1), (padx0, padx1, 0, 0),
                              flip_filter)
    return _depthwise_fir(x, f, (upx, upy), (downx, downy), (padx0, padx1, pady0, pady1),
                          flip_filter)
