"""2-D convolution fused with FIR up/downsampling (counterpart of
``vqvae_tpu/ops/conv2d_resample.py``, reference conv2d_resample.py:59-154):
the same padding arithmetic and branch order, on NCHW images with OIHW
weights. ``flip_weight=True`` is correlation (``F.conv2d``'s own sense).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.ops.upfirdn2d import _parse_padding, get_filter_size, upfirdn2d


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0,
           flip_weight: bool = True) -> torch.Tensor:
    """Dense conv, weight cast to x's dtype; ``padding`` int or (py, px)."""
    if not flip_weight:
        w = w.flip([2, 3])
    if isinstance(padding, int):
        padding = (padding, padding)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=tuple(padding))


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1, down: int = 1,
                    padding: int = 0, flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Convolution with optional FIR resampling; padding applied once, up front."""
    assert up >= 1 and down >= 1
    kh, kw = w.shape[2], w.shape[3]
    fw, fh = get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: FIR+down fused, then pointwise conv
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return conv2d(x, w, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: pointwise conv, then FIR+up
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = conv2d(x, w, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)

    # downsampling only: FIR pad+filter, then strided conv
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return conv2d(x, w, stride=down, flip_weight=flip_weight)

    # plain conv with symmetric non-negative padding
    if up == 1 and down == 1 and px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return conv2d(x, w, padding=(py0, px0), flip_weight=flip_weight)

    # generic: upsample (with the filter if up > 1), conv, downsample
    x = upfirdn2d(x, (f if up > 1 else None), up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2 if up > 1 else 1, flip_filter=flip_filter)
    x = conv2d(x, w, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
