"""Image preprocessing, eval path (counterpart of
``vqvae_tpu/models/preprocess.py:28-35, 73-87``). Images are NHWC.

The training augmentations (RandomResizedCrop + flip) come with the
training slice.
"""

from __future__ import annotations

import torch


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0,1] -> (-1,1) with mean = std = 0.5."""
    return images * 2.0 - 1.0


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """(-1,1) -> [0,1], clipped."""
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


def preprocess_batch(images: torch.Tensor) -> torch.Tensor:
    """[0,1] float or uint8 NHWC batch -> normalized (-1,1) fp32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return normalize(torch.clamp(images.float(), 0.0, 1.0))
