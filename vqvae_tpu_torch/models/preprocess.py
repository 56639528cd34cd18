"""Image preprocessing and the training augmentations (counterpart of
``vqvae_tpu/models/preprocess.py:28-87``). Images are NHWC; ``to_nchw`` /
``to_nhwc`` are the port's one hop to the modules' NCHW and back.

The augmentation is the reference's RandomResizedCrop(scale 0.7-1, ratio 1)
+ RandomHorizontalFlip(0.5), drawn from an explicit ``torch.Generator``. The
crop-resize is ``jax.image.scale_and_translate`` (linear, no antialias) as
the JAX package calls it: every output pixel samples the *whole* image at
``(i + 0.5) / s - 0.5 + y0`` with tent weights normalized per output pixel.
Cropping first and then resizing with ``F.interpolate`` differs from that
at the crop's edges, so the port builds the two small (out, H) and (out, W)
weight matrices per image and applies them with ``einsum``.
"""

from __future__ import annotations

from typing import Optional

import torch


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous NCHW: the hop from the API's format to the modules'."""
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC: the hop back."""
    return x.permute(0, 2, 3, 1).contiguous()


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0,1] -> (-1,1) with mean = std = 0.5."""
    return images * 2.0 - 1.0


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """(-1,1) -> [0,1], clipped."""
    return torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)


def _linear_weights(in_size: int, out_size: int, crop: torch.Tensor,
                    start: torch.Tensor) -> torch.Tensor:
    """(B,) crop sides and starts -> (B, out, in) fp32 weights of
    ``jax.image.scale_and_translate(method="linear", antialias=False)`` with
    scale ``out / crop`` and translation ``-start * scale``."""
    inv_scale = (crop / out_size)[:, None]
    i = torch.arange(out_size, dtype=torch.float32, device=crop.device)
    sample = (i[None] + 0.5) * inv_scale - 0.5 + start[:, None]          # (B, out)
    j = torch.arange(in_size, dtype=torch.float32, device=crop.device)
    weights = torch.clamp(1.0 - (sample[:, :, None] - j).abs(), min=0.0)  # (B, out, in)
    total = weights.sum(2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def crop_resize(images: torch.Tensor, crop: torch.Tensor, y0: torch.Tensor,
                x0: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resize the square crops ``[y0:y0+crop, x0:x0+crop]`` of an NHWC fp32
    batch to (out_size, out_size), bilinear; ``crop``, ``y0``, ``x0`` are (B,)
    fp32 (counterpart of ``vqvae_tpu/models/preprocess.py::_crop_resize_one``)."""
    _, h, w, _ = images.shape
    wy = _linear_weights(h, out_size, crop, y0)
    wx = _linear_weights(w, out_size, crop, x0)
    return torch.einsum("biy,byxc,bjx->bijc", wy, images, wx)


def random_resized_crop_flip(images: torch.Tensor, out_size: int,
                             generator: torch.Generator,
                             scale_range=(0.7, 1.0)) -> torch.Tensor:
    """Per-sample RandomResizedCrop(scale=scale_range, ratio=(1,1)) +
    RandomHorizontalFlip(p=0.5) of an NHWC fp32 batch. The draws come from
    ``generator`` on its own device and are then moved to the images'."""
    b, h, w, _ = images.shape

    def uniform():
        return torch.rand(b, generator=generator, device=generator.device).to(images.device)

    area_scale = scale_range[0] + (scale_range[1] - scale_range[0]) * uniform()
    # fixed aspect ratio 1 -> square crop side = sqrt(area_scale) * side
    crop = torch.floor(torch.sqrt(area_scale * h * w)).clamp(1, min(h, w))
    y0 = torch.floor(uniform() * (h - crop))
    x0 = torch.floor(uniform() * (w - crop))
    out = crop_resize(images, crop, y0, x0, out_size)
    flip = uniform() < 0.5
    return torch.where(flip[:, None, None, None], out.flip(2), out)


def preprocess_batch(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                     training: bool = False, image_size: Optional[int] = None) -> torch.Tensor:
    """[0,1] float or uint8 NHWC batch -> normalized (-1,1) fp32, with the
    training augmentations when ``training`` (which needs ``generator``)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    images = torch.clamp(images.float(), 0.0, 1.0)
    if training:
        if generator is None:
            raise ValueError("training preprocessing needs a torch.Generator")
        size = image_size if image_size is not None else images.shape[1]
        images = torch.clamp(random_resized_crop_flip(images, size, generator), 0.0, 1.0)
    return normalize(images)
