"""Small ops completing the reference's custom-ops surface (counterpart of
``vqvae_tpu/ops/misc_ops.py``, in NCHW). No model path uses them.

- ``fma``: ``a * b + c`` (reference ops/fma.py:15-58 wraps it in an autograd
  Function only to fuse it on CUDA; PyTorch's autograd differentiates the
  plain expression exactly).
- ``grid_sample``: bilinear sampling with zero padding and
  ``align_corners=False``, differentiable to any order in both the image and
  the grid (reference grid_sample_gradfix.py:27-81 exists because
  ``F.grid_sample``'s backward has no backward): the four taps are gathered
  and weighted in plain tensor ops.
- ``modulated_conv2d``: StyleGAN2's style-modulated convolution (reference
  discriminator.py:25-86; shipped, unused by the discriminator), as the JAX
  package runs it: the input scaled by the styles, one shared convolution,
  then the demodulation per sample and output channel.
- ``set_matmul_precision``: the default precision of fp32 matmuls and cuDNN
  convolutions (reference common_utils.py:16-27; JAX's
  ``jax_default_matmul_precision``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c``."""
    return a * b + c


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear grid sample, NCHW: ``F.grid_sample(x, grid, "bilinear",
    "zeros", align_corners=False)``, differentiable to any order.

    Args:
      x: (B, C, H, W) images.
      grid: (B, Ho, Wo, 2) sampling locations in [-1, 1], (x, y) order;
        a tap outside the image reads 0.

    Returns:
      (B, C, Ho, Wo).
    """
    b, c, h, w = x.shape
    # [-1, 1] -> pixel coordinates with half-pixel centres (align_corners=False)
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = gx.floor(), gy.floor()
    fx, fy = gx - x0, gy - y0
    flat = x.reshape(b, c, h * w)
    out = 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            weight = wx * wy
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            taps = torch.gather(flat, 2, index.reshape(b, 1, -1).expand(b, c, -1))
            out = out + taps.reshape(b, c, *gx.shape[1:]) * (weight * inside)[:, None]
    return out


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     demodulate: bool = True, padding: int = 0) -> torch.Tensor:
    """Style-modulated convolution, NCHW / OIHW.

    Args:
      x: (B, I, H, W); weight: (O, I, kh, kw); styles: (B, I).
    """
    y = F.conv2d(x * styles[:, :, None, None], weight, padding=padding)
    if demodulate:
        d = torch.rsqrt(((weight[None] * styles[:, None, :, None, None]) ** 2)
                        .sum(dim=(2, 3, 4)) + 1e-8)   # (B, O)
        y = y * d[:, :, None, None]
    return y


_PRECISIONS = {"highest": "highest", "float32": "highest",
               "high": "high", "tensorfloat32": "high",
               "default": "medium", "bfloat16": "medium"}


def set_matmul_precision(precision: Optional[str] = None) -> None:
    """Set the default precision of fp32 matmuls and cuDNN convolutions, by
    the JAX package's names: ``highest`` / ``float32`` (true fp32, TF32 off),
    ``high`` / ``tensorfloat32`` (TF32), ``default`` / ``bfloat16`` (PyTorch's
    ``medium``: bf16 passes allowed in matmuls, TF32 in convolutions). None
    changes nothing, as in JAX."""
    if precision is None:
        return
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, not {precision!r}")
    torch_name = _PRECISIONS[precision]
    # also sets torch.backends.cuda.matmul.allow_tf32 (False only at "highest")
    torch.set_float32_matmul_precision(torch_name)
    torch.backends.cudnn.allow_tf32 = torch_name != "highest"
