"""Frechet Inception Distance (rFID): streaming statistics and the FID math
(a copy of ``vqvae_tpu/eval/fid.py`` for the port).

It replaces torchmetrics' FrechetInceptionDistance (reference model.py:497,
536-541: reconstructions and real images as uint8, features from pool3 of
InceptionV3). The feature extractor is pluggable:

- ``load_inception_extractor(device)`` returns the ``torch.nn`` pool3
  extractor (``eval/inception.py``) when the converted weights are present
  (``tools/convert_inception_weights.py``: FID is comparable across
  implementations only with the standard pt_inception weights), else None;
- any callable ``(uint8 NHWC images) -> (B, D) host features`` works.

The statistics stay on the host in float64 numpy; under a process group
``reduce_across_hosts`` sums them over the ranks (NCCL reduces only CUDA
tensors, so they travel to the rank's card for the sum and come back). The
Frechet distance uses
the eigen-decomposition form ``tr(S1) + tr(S2) - 2 tr((S1^(1/2) S2
S1^(1/2))^(1/2))``, the math of scipy's ``sqrtm`` route without scipy.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from vqvae_tpu_torch.parallel.dist import all_reduce_sum_, reduce_device, world


class FIDAccumulator:
    """Streaming mean and second moment of the feature vectors of one
    distribution."""

    def __init__(self, feature_dim: int):
        self.n = 0
        self.sum = np.zeros((feature_dim,), np.float64)
        self.outer = np.zeros((feature_dim, feature_dim), np.float64)

    def update(self, features: np.ndarray, mask: Optional[np.ndarray] = None):
        features = np.asarray(features, np.float64)
        if mask is not None:
            features = features[np.asarray(mask, bool)]
        self.n += features.shape[0]
        self.sum += features.sum(axis=0)
        self.outer += features.T @ features

    def reduce_across_hosts(self) -> None:
        """Sum ``n``, the sums and the second moments over the ranks, in
        place (JAX ``eval/fid.py:46``); a no-op at world size 1."""
        if world()[1] == 1:
            return
        device = reduce_device()
        parts = [torch.tensor([float(self.n)], dtype=torch.float64, device=device),
                 torch.from_numpy(self.sum).to(device), torch.from_numpy(self.outer).to(device)]
        all_reduce_sum_(parts)
        self.n = int(parts[0].item())
        self.sum = parts[1].cpu().numpy()
        self.outer = parts[2].cpu().numpy()

    def stats(self):
        assert self.n > 1, "need at least 2 samples for covariance"
        mu = self.sum / self.n
        # unbiased covariance (as torchmetrics / pytorch-fid)
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a symmetric PSD matrix by eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FD between two Gaussians (Heusel et al. 2017)."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1_half @ cov2 @ s1_half)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner))


class FID:
    """Two-distribution streaming FID (real against reconstructed),
    torchmetrics' API."""

    def __init__(self, extractor: Callable, feature_dim: int):
        self.extractor = extractor
        self.real = FIDAccumulator(feature_dim)
        self.fake = FIDAccumulator(feature_dim)

    def update(self, images_uint8, real: bool, mask: Optional[np.ndarray] = None):
        feats = np.asarray(self.extractor(images_uint8))
        (self.real if real else self.fake).update(feats, mask)

    def reduce_across_hosts(self) -> None:
        self.real.reduce_across_hosts()
        self.fake.reduce_across_hosts()

    def compute(self) -> float:
        mu_r, cov_r = self.real.stats()
        mu_f, cov_f = self.fake.stats()
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)


def inception_weights_path() -> Path:
    """``$VQVAE_TPU_INCEPTION_WEIGHTS``, else
    ``~/.cache/vqvae_tpu/inception_fid.npz``: the file the JAX package reads."""
    env = os.environ.get("VQVAE_TPU_INCEPTION_WEIGHTS")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "vqvae_tpu" / "inception_fid.npz"


def load_inception_extractor(device="cuda"):
    """(extractor on ``device``, feature_dim) with the converted FID-inception
    weights, or (None, 0) when the file is missing."""
    path = inception_weights_path()
    if not path.exists():
        warnings.warn(
            f"FID inception weights not found at {path}; rFID will be skipped. "
            "Run tools/convert_inception_weights.py to enable it.")
        return None, 0
    from vqvae_tpu_torch.eval.inception import make_pool3_extractor
    return make_pool3_extractor(path, device), 2048
