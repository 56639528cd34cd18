"""Evaluation metrics: L2 / PSNR / SSIM (counterpart of
``vqvae_tpu/eval/metrics.py``; rFID is in ``eval/fid.py``).

The reference's torchmetrics suite (model.py:16-19, 491-562):
- MSE: the mean over images of the per-image mean squared error;
- PSNR: ``10 log10(data_range^2 / max(mse, 1e-12))`` with ``data_range``
  fixed to 1.0 (images are [0,1]; torchmetrics would infer the range from
  the data, a divergence the JAX package documents);
- SSIM: Gaussian window 11, sigma 1.5, k1 0.01, k2 0.03, the mean over
  images.

Images are NHWC floats in [0, 1], as in the JAX package. The blur is
separable, valid-padded and depthwise (``F.conv2d(groups=C)``) in fp32 with
TF32 off. The accumulators are streaming masked sums, so the zero-padded
rows of a partial final batch count for nothing; they stay on the images'
device (float64) and are fetched once, by ``compute()``. Under a process
group each rank streams its shard and ``reduce_across_hosts`` sums the
accumulators over the ranks before ``compute()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.parallel.dist import all_reduce_sum_, reduce_device, world
from vqvae_tpu_torch.utils.precision import full_fp32


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(x: torch.Tensor, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Separable valid-padding Gaussian filter, depthwise over NCHW: along H,
    then along W."""
    k = torch.from_numpy(_gaussian_kernel1d(size, sigma)).to(x.device)
    c = x.shape[1]
    x = F.conv2d(x, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


@torch.inference_mode()
def ssim_per_sample(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
                    kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM (B,) of NHWC images, torchmetrics' Gaussian form."""
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    with full_fp32():
        mu_x = _gaussian_blur(pred, kernel_size, sigma)
        mu_y = _gaussian_blur(target, kernel_size, sigma)
        mu_xx = _gaussian_blur(pred * pred, kernel_size, sigma)
        mu_yy = _gaussian_blur(target * target, kernel_size, sigma)
        mu_xy = _gaussian_blur(pred * target, kernel_size, sigma)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return (num / den).mean(dim=(1, 2, 3))


@torch.inference_mode()
def mse_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean(dim=(1, 2, 3))


class ReconMetrics:
    """Streaming MSE / PSNR / SSIM with padded-batch masking."""

    def __init__(self, data_range: float = 1.0):
        self.data_range = data_range
        self._se_sum = 0.0    # sum of per-image mean squared errors
        self._ssim_sum = 0.0
        self._n = 0

    def update(self, recons, images, mask: Optional[torch.Tensor] = None) -> None:
        """NHWC [0,1] reconstructions and images (tensors or arrays; the
        images go to the reconstructions' device) and an optional (B,) bool
        mask."""
        recons = torch.as_tensor(recons)
        images = torch.as_tensor(images).to(recons.device)
        mse_s = mse_per_sample(recons, images)
        ssim_s = ssim_per_sample(recons, images, self.data_range)
        keep = (torch.ones(recons.shape[0], dtype=torch.bool) if mask is None
                else torch.as_tensor(mask, dtype=torch.bool)).to(recons.device)
        self._se_sum = self._se_sum + mse_s.double()[keep].sum()
        self._ssim_sum = self._ssim_sum + ssim_s.double()[keep].sum()
        self._n = self._n + keep.sum()

    def reduce_across_hosts(self) -> None:
        """Sum the accumulators over the ranks of the process group, in place
        (JAX ``eval/metrics.py:102``); a no-op at world size 1."""
        if world()[1] == 1:
            return
        sums = torch.stack([torch.as_tensor(v, dtype=torch.float64).to(reduce_device())
                            for v in (self._se_sum, self._ssim_sum, self._n)])
        all_reduce_sum_([sums])
        self._se_sum, self._ssim_sum, self._n = sums[0], sums[1], int(sums[2])

    def compute(self) -> dict:
        n = max(int(self._n), 1)
        mse = float(self._se_sum) / n
        psnr = 10.0 * np.log10(self.data_range ** 2 / max(mse, 1e-12))
        return {"mse": mse, "psnr": float(psnr), "ssim": float(self._ssim_sum) / n}
