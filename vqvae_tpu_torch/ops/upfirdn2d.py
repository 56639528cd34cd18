"""upfirdn2d: zero-stuff upsample, pad (negative = crop), FIR-filter and
downsample a batch of NCHW images (counterpart of ``vqvae_tpu/ops/upfirdn2d.py``).

The whole pipeline is one depthwise ``F.conv2d`` (``groups=C``) on the
stuffed, padded input, so autograd differentiates it to any order (R1). As
in the JAX package, the up-``k`` path puts ``k - 1`` zeros *after* each
pixel (``H * up`` samples), padding is applied to the upsampled image, and
the filter is cast to the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Scaling = Union[int, Sequence[int]]
Padding = Union[int, Sequence[int]]


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
    f = torch.as_tensor(np.ascontiguousarray(f2d), dtype=x.dtype, device=x.device)
    if not flip_filter:
        f = f.flip([0, 1])  # conv2d correlates; a flip makes it a convolution
    weight = f[None, None].expand(c, 1, *f.shape)
    return F.conv2d(x, weight, stride=(downy, downx), groups=c)


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
