"""Nearest-code assignment (B1) and its fused form with the EMA statistics
(B2) of the PyTorch port against the JAX package: the plain versions against
``_nearest_codes_xla`` / ``_nearest_codes_stats_xla`` and the Pallas kernels
in interpret mode, and the Hopper kernels against the plain versions on the
card (tests marked ``cuda``, skipped without one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.vq import _nearest_codes_stats_xla, _nearest_codes_xla
from vqvae_tpu.ops.vq_pallas import nearest_codes_pallas, nearest_codes_stats_pallas
from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.ops.vq import (code_mismatches, nearest_codes, nearest_codes_reference,
                                    nearest_codes_stats, nearest_codes_stats_reference)
from vqvae_tpu_torch.ops.vq_cuda import nearest_codes_cuda, nearest_codes_stats_cuda

torch.set_num_threads(1)


def _gaussian(seed, m, n, d):
    rs = np.random.RandomState(seed)
    return rs.randn(m, d).astype(np.float32), rs.randn(n, d).astype(np.float32)


@pytest.mark.parametrize("seed,m,n,d", [(11, 512, 128, 128), (12, 100, 37, 8)])
def test_reference_matches_xla(seed, m, n, d):
    x, cb = _gaussian(seed, m, n, d)
    want = np.asarray(_nearest_codes_xla(jnp.asarray(x), jnp.asarray(cb)))
    got = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_matches_pallas_interpret():
    # the pair that tests/test_ops.py holds exactly on the JAX side
    x, cb = _gaussian(11, 512, 128, 128)
    want = np.asarray(nearest_codes_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), want)


def _assert_stats_equal(got, want):
    """codes and counts exact, dw within rtol 1e-5 / atol 1e-5."""
    codes, counts, dw = (np.asarray(a) for a in want)
    assert got[0].dtype == torch.int32 and got[1].dtype == got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), codes)
    np.testing.assert_array_equal(got[1].numpy(), counts)
    np.testing.assert_allclose(got[2].numpy(), dw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,m,n,d", [(12, 100, 37, 8), (11, 512, 128, 128)])
def test_stats_reference_matches_xla(seed, m, n, d):
    x, cb = _gaussian(seed, m, n, d)
    want = _nearest_codes_stats_xla(jnp.asarray(x), jnp.asarray(cb))
    got = nearest_codes_stats_reference(torch.from_numpy(x), torch.from_numpy(cb))
    _assert_stats_equal(got, want)
    assert got[1].sum() == m and (got[1] == 0).any() == (len(np.unique(want[0])) < n)


def test_stats_reference_matches_pallas_interpret():
    x, cb = _gaussian(11, 512, 128, 128)
    want = nearest_codes_stats_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True)
    got = nearest_codes_stats_reference(torch.from_numpy(x), torch.from_numpy(cb))
    _assert_stats_equal(got, want)


def test_stats_cpu_tensors_take_the_plain_version():
    x, cb = _gaussian(13, 64, 32, 16)
    before = nearest_codes_stats.launches
    got = nearest_codes_stats(torch.from_numpy(x).requires_grad_(), torch.from_numpy(cb))
    assert nearest_codes_stats.launches == before
    want = nearest_codes_stats_reference(torch.from_numpy(x), torch.from_numpy(cb))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[2].requires_grad


def test_stats_non_cpu_tensors_reach_the_kernel_contiguous(monkeypatch):
    from vqvae_tpu_torch.ops import vq_cuda
    seen = []

    def fake_kernel(x, cb):
        seen.append((x.is_contiguous(), cb.is_contiguous()))
        return (torch.empty(x.shape[0], dtype=torch.int32, device=x.device),
                torch.empty(cb.shape[0], device=x.device), torch.empty(cb.shape, device=x.device))

    monkeypatch.setattr(vq_cuda, "nearest_codes_stats_cuda", fake_kernel)
    monkeypatch.setattr(nearest_codes_stats, "launches", 0)
    flat = torch.empty(1, 8, 4, 4, device="meta").permute(0, 2, 3, 1).reshape(16, 8)
    codes, counts, dw = nearest_codes_stats(flat, torch.empty(8, 32, device="meta").T)
    assert seen == [(True, True)] and codes.shape == (16,) and dw.shape == (32, 8)
    assert nearest_codes_stats.launches == 0


def test_ties_go_to_first_index():
    _, cb = _gaussian(3, 1, 16, 8)
    cb[9] = cb[2]          # duplicate of an earlier row
    x = np.stack([cb[2], cb[9], cb[5]]).astype(np.float32)
    got = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), [2, 2, 5])


def test_nan_follows_argmin_rule():
    """A NaN score ranks first and the first NaN wins: a NaN latent row maps
    to code 0, a NaN codebook row takes every row (the kernel's rule too)."""
    x, cb = _gaussian(4, 6, 10, 8)
    x[1, 3] = np.nan
    got = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert got[1] == 0
    cb[7, 0] = np.nan
    got = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert got[0] == 7 and got[1] == 0


def test_cpu_tensors_take_the_plain_version():
    x, cb = _gaussian(5, 64, 32, 16)
    before = nearest_codes.launches
    got = nearest_codes(torch.from_numpy(x).requires_grad_(), torch.from_numpy(cb))
    assert nearest_codes.launches == before
    np.testing.assert_array_equal(
        got.numpy(), nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb)).numpy())


def test_code_mismatches_near_tie_rule():
    x, cb = _gaussian(6, 32, 16, 8)
    want = nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert code_mismatches(torch.from_numpy(x), torch.from_numpy(cb), want, want) == (0, 0, 0.0)
    cb[5] = cb[want[0]]    # an exact tie: either pick is allowed
    got = want.clone()
    got[0] = 5
    n_mis, n_bad, gap = code_mismatches(torch.from_numpy(x), torch.from_numpy(cb), got, want)
    assert (n_mis, n_bad, gap) == (1, 0, 0.0)
    got[1] = (want[1] + 1) % 16  # a clear miss
    n_mis, n_bad, gap = code_mismatches(torch.from_numpy(x), torch.from_numpy(cb), got, want)
    assert (n_mis, n_bad) == (2, 1) and gap > 0


def test_non_cpu_tensors_reach_the_kernel_contiguous(monkeypatch):
    """A batch-of-one latent flattened from NCHW is a transposed view; the
    dispatcher hands the kernel wrapper contiguous tensors. The launch count
    belongs to the wrapper, so a stand-in that launches nothing adds none."""
    from vqvae_tpu_torch.ops import vq_cuda
    seen = []

    def fake_kernel(x, cb):
        seen.append((x.is_contiguous(), cb.is_contiguous()))
        return torch.empty(x.shape[0], dtype=torch.int32, device=x.device)

    monkeypatch.setattr(vq_cuda, "nearest_codes_cuda", fake_kernel)
    monkeypatch.setattr(nearest_codes, "launches", 0)
    z = torch.empty(1, 8, 4, 4, device="meta")
    flat = z.permute(0, 2, 3, 1).reshape(16, 8)
    assert not flat.is_contiguous()
    codes = nearest_codes(flat, torch.empty(8, 32, device="meta").T)
    assert seen == [(True, True)] and codes.shape == (16,)
    assert nearest_codes.launches == 0


def test_cuda_wrapper_rejects_cpu_tensors():
    x, cb = _gaussian(7, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_codes_cuda(torch.from_numpy(x), torch.from_numpy(cb))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_codes_stats_cuda(torch.from_numpy(x), torch.from_numpy(cb))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_codes_stats(torch.from_numpy(x), torch.from_numpy(cb).to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_codes(torch.from_numpy(x), torch.from_numpy(cb).to("meta"))


def test_find_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_tracks_the_source(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// v2\n")
    second = _build.library_path("k")
    assert first != second
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")


def test_library_name_tracks_the_shared_headers(monkeypatch, tmp_path):
    """A kernel's library is named by its headers too: an edited header is
    never served by a library built from the old one."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert len({first, second, _build.library_path("k")}) == 3


def test_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    """Every missing library gets its own nvcc, all started before any is
    waited for; a failed one raises with the compiler's message."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"error: $*\" >&2\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path.parent))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError) as err:
        _build.build(["nearest_codes", "nearest_codes_stats"])
    msg = str(err.value)
    assert "nearest_codes.cu (exit 3)" in msg and "nearest_codes_stats.cu (exit 3)" in msg
    assert "error: -gencode arch=compute_90a,code=sm_90a" in msg
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for seed, (m, n, d) in enumerate([(256, 1024, 256), (1000, 37, 8), (512, 128, 128)]):
        x, cb = (torch.from_numpy(a).cuda() for a in _gaussian(seed, m, n, d))
        before = nearest_codes.launches
        got = nearest_codes(x, cb)
        assert nearest_codes.launches == before + 1
        want = nearest_codes_reference(x, cb)
        n_mis, n_bad, _ = code_mismatches(x, cb, got, want)
        assert n_bad == 0 and n_mis <= 1e-4 * m
    x, cb = (torch.from_numpy(a).cuda() for a in _gaussian(9, 64, 40, 16))
    cb[30] = cb[3]
    x[:8] = cb[3]
    x[10, 2] = float("nan")
    torch.testing.assert_close(nearest_codes(x, cb), nearest_codes_reference(x, cb))
    before = nearest_codes.launches
    assert nearest_codes(x[:0], cb).shape == (0,)  # an empty batch launches nothing
    assert nearest_codes.launches == before


def _near_rows(gen, cb, m):
    idx = torch.randint(0, cb.shape[0], (m,), device=cb.device, generator=gen)
    return cb[idx] + 0.05 * torch.randn(m, cb.shape[1], device=cb.device, generator=gen)


@pytest.mark.cuda
def test_stats_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, d in [(256, 1024, 256), (1000, 37, 8), (4097, 512, 256)]:
        cb = torch.randn(n, d, device="cuda", generator=gen)
        for x in (torch.randn(m, d, device="cuda", generator=gen), _near_rows(gen, cb, m)):
            before = nearest_codes_stats.launches
            codes, counts, dw = nearest_codes_stats(x, cb)
            assert nearest_codes_stats.launches == before + 1
            n_mis, n_bad, _ = code_mismatches(x, cb, codes, nearest_codes_reference(x, cb))
            assert n_bad == 0 and n_mis <= 1e-4 * m
            assert torch.equal(codes, nearest_codes(x, cb))   # B1 and B2 agree exactly
            assert torch.equal(counts, torch.bincount(codes.long(), minlength=n).float())
            onehot = torch.nn.functional.one_hot(codes.long(), n).float()
            bound = 1e-6 * (1 + counts[:, None]) * x.abs().max()
            assert ((dw - onehot.T @ x).abs() <= bound).all()
            assert (dw[counts == 0] == 0).all()
            again = nearest_codes_stats(x, cb)
            assert all(torch.equal(a, b) for a, b in zip((codes, counts, dw), again))
    codes, counts, dw = nearest_codes_stats(x[:0], cb)
    assert codes.shape == (0,) and not counts.any() and not dw.any()
