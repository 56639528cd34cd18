"""The port's eval metrics and FID statistics against ``vqvae_tpu/eval`` on
the CPU:

- ``mse_per_sample`` / ``ssim_per_sample`` per image, and ``ReconMetrics``'
  MSE / PSNR / SSIM over two batches, the second zero-padded with masked
  garbage rows: rtol 1e-5;
- the TF1 resize matrices: exactly equal;
- ``frechet_distance`` on identical float64 statistics: within 1e-10 of
  JAX's (relative); the streaming ``FIDAccumulator`` / ``FID`` with masks:
  the same moments, rtol 1e-12;
- ``inception_weights_path`` and a missing weights file, as JAX's.
"""

import warnings

import numpy as np
import pytest
import torch

from vqvae_tpu.eval import fid as jfid
from vqvae_tpu.eval import inception as jinc
from vqvae_tpu.eval import metrics as jmetrics
from vqvae_tpu_torch.eval import fid as tfid
from vqvae_tpu_torch.eval import inception as tinc
from vqvae_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)


def _pair(seed, b=4, size=24):
    """Images and a noisy copy, both NHWC in [0, 1]."""
    rs = np.random.RandomState(seed)
    images = rs.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    recons = np.clip(images + 0.1 * rs.randn(*images.shape), 0, 1).astype(np.float32)
    return recons, images


@pytest.mark.parametrize("size", [11, 24])
def test_per_sample_metrics_match_jax(size):
    recons, images = _pair(0, size=size)
    for port, jax_fn in ((tmetrics.mse_per_sample, jmetrics.mse_per_sample),
                         (tmetrics.ssim_per_sample, jmetrics.ssim_per_sample)):
        got = port(torch.from_numpy(recons), torch.from_numpy(images)).numpy()
        want = np.asarray(jax_fn(recons, images))
        assert got.shape == (4,)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ssim_of_identical_images_is_one():
    _, images = _pair(1)
    got = tmetrics.ssim_per_sample(torch.from_numpy(images), torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-6)


def test_streaming_metrics_with_a_padded_batch_match_jax():
    """Two batches, the second with 2 zero-padded masked rows that carry
    garbage: the padded rows count for nothing on either side."""
    r1, i1 = _pair(2)
    r2, i2 = _pair(3)
    r2[2:], i2[2:] = 1.0, 0.0
    mask2 = np.array([True, True, False, False])
    port, ref = tmetrics.ReconMetrics(1.0), jmetrics.ReconMetrics(1.0)
    for r, i, m in ((r1, i1, None), (r2, i2, mask2)):
        port.update(torch.from_numpy(r), torch.from_numpy(i),
                    None if m is None else torch.from_numpy(m))
        ref.update(r, i, m)
    got, want = port.compute(), ref.compute()
    assert set(got) == set(want) == {"mse", "psnr", "ssim"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    only_valid = tmetrics.ReconMetrics(1.0)
    only_valid.update(torch.from_numpy(np.concatenate([r1, r2[:2]])),
                      torch.from_numpy(np.concatenate([i1, i2[:2]])))
    for k, v in only_valid.compute().items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_psnr_floor_and_empty_metrics():
    _, images = _pair(4)
    m = tmetrics.ReconMetrics(1.0)
    m.update(torch.from_numpy(images), torch.from_numpy(images))
    assert m.compute()["mse"] == 0.0 and m.compute()["psnr"] == pytest.approx(120.0)
    assert tmetrics.ReconMetrics(1.0).compute() == jmetrics.ReconMetrics(1.0).compute()


@pytest.mark.parametrize("in_size", [1, 16, 32, 256, 299, 512])
def test_resize_matrix_equals_jax(in_size):
    got = tinc.tf1_bilinear_matrix(in_size, 299)
    want = jinc._tf1_bilinear_matrix(in_size, 299)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _stats(seed, n=40, d=16):
    rs = np.random.RandomState(seed)
    feats = rs.randn(n, d) @ rs.randn(d, d) * 0.3 + rs.randn(d)
    return feats.mean(0), np.cov(feats, rowvar=False)


def test_frechet_distance_matches_jax():
    mu1, cov1 = _stats(5)
    mu2, cov2 = _stats(6)
    got = tfid.frechet_distance(mu1, cov1, mu2, cov2)
    want = jfid.frechet_distance(mu1, cov1, mu2, cov2)
    assert abs(got - want) <= 1e-10 * abs(want) and want > 0
    assert abs(tfid.frechet_distance(mu1, cov1, mu1, cov1)) < 1e-8


def test_streaming_fid_matches_jax():
    rs = np.random.RandomState(7)
    proj = rs.randn(12, 8)

    def extractor(images):
        return np.asarray(images, np.float64).reshape(len(images), -1)[:, :12] @ proj

    port, ref = tfid.FID(extractor, 8), jfid.FID(extractor, 8)
    for i in range(3):
        images = rs.randint(0, 256, (5, 2, 2, 3)).astype(np.uint8)
        mask = np.array([True, True, True, i < 2, False])
        for real in (True, False):
            port.update(images if real else 255 - images, real, mask)
            ref.update(images if real else 255 - images, real, mask)
    for side in ("real", "fake"):
        a, b = getattr(port, side), getattr(ref, side)
        assert a.n == b.n == 11
        np.testing.assert_allclose(a.sum, b.sum, rtol=1e-12)
        np.testing.assert_allclose(a.outer, b.outer, rtol=1e-12)
    np.testing.assert_allclose(port.compute(), ref.compute(), rtol=1e-10)


def test_weights_path_and_missing_file_as_jax(monkeypatch, tmp_path):
    monkeypatch.delenv("VQVAE_TPU_INCEPTION_WEIGHTS", raising=False)
    assert tfid.inception_weights_path() == jfid.inception_weights_path()
    assert str(tfid.inception_weights_path()).endswith(".cache/vqvae_tpu/inception_fid.npz")
    missing = tmp_path / "none.npz"
    monkeypatch.setenv("VQVAE_TPU_INCEPTION_WEIGHTS", str(missing))
    assert tfid.inception_weights_path() == jfid.inception_weights_path() == missing
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tfid.load_inception_extractor("cpu") == (None, 0)
    assert any("convert_inception_weights" in str(w.message) for w in caught)
