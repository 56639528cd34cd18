"""Nearest-code assignment (B1) and its fused form with the EMA statistics
(B2) of the PyTorch port against the JAX package: the plain versions against
``_nearest_codes_xla`` / ``_nearest_codes_stats_xla`` and the Pallas kernels
in interpret mode, and the Hopper kernels against the plain versions on the
card (tests marked ``cuda``, skipped without one).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.vq import _nearest_codes_stats_xla, _nearest_codes_xla
from vqvae_tpu.ops.vq_pallas import nearest_codes_pallas, nearest_codes_stats_pallas
from vqvae_tpu_torch.ops import _build
from vqvae_tpu_torch.ops.vq import (code_mismatches, nearest_codes, nearest_codes_reference,
                                    nearest_codes_stats, nearest_codes_stats_reference)
from vqvae_tpu_torch.ops.vq_cuda import (BM, BN, NEAR_RTOL, code_ranges, listed_rows,
                                         nearest_codes_cuda, nearest_codes_stats_cuda,
                                         scan_scratch, scan_splits, scratch_pointers)

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


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``; inf and NaN pass through."""
    a = np.asarray(a, dtype=np.float32)
    bits = a.view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isfinite(a), rounded, bits).astype(np.uint32).view(np.float32)


def test_tf32_rna_helper():
    v = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -11, 1 + 2 ** -10,
                  np.inf, -np.inf, np.nan], dtype=np.float32)
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 1 + 2 ** -10, np.inf, -np.inf, np.nan]
    np.testing.assert_array_equal(_tf32_rna(v), np.array(want, dtype=np.float32))
    r = _tf32_rna(np.random.RandomState(0).randn(1000).astype(np.float32))
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()   # 13 low bits clear


def _split_tf32(a: np.ndarray):
    """The kernel's split of finite values: a = hi + lo, both rounded to TF32."""
    hi = _tf32_rna(a)
    return torch.from_numpy(hi), torch.from_numpy(_tf32_rna((a - hi).astype(np.float32)))


@pytest.mark.parametrize("seed,m,n,d", [(0, 8192, 1024, 256), (1, 2048, 4096, 256)])
def test_tf32_split_keeps_the_plain_codes(seed, m, n, d):
    """The scan's 3xTF32 product (hi.hi + (hi.lo + lo.hi), fp32 sums),
    emulated with fp32 matmuls on TF32-rounded operands, picks the plain
    version's code on every row; one TF32 pass (hi.hi) does not."""
    rs = np.random.RandomState(seed)
    cb = rs.randn(n, d).astype(np.float32)
    ct = torch.from_numpy(cb)
    c2 = (ct ** 2).sum(1)
    ch, cl = _split_tf32(cb)
    one_pass_misses = 0
    for x in (rs.randn(m, d).astype(np.float32),
              (cb[rs.randint(0, n, m)] + 0.05 * rs.randn(m, d)).astype(np.float32)):
        xt = torch.from_numpy(x)
        want = nearest_codes_reference(xt, ct)
        xh, xl = _split_tf32(x)
        big = xh @ ch.T
        three = (c2[None] - 2 * (big + (xh @ cl.T + xl @ ch.T))).argmin(1).int()
        assert code_mismatches(xt, ct, three, want) == (0, 0, 0.0)
        one = (c2[None] - 2 * big).argmin(1).int()
        one_pass_misses += code_mismatches(xt, ct, one, want)[0]
    assert one_pass_misses > 0


def _listed_near_ties(x: np.ndarray, cb: np.ndarray):
    """The emulated 3xTF32 codes and the rows the kernel rescores: those whose
    best two scores lie within NEAR_RTOL (|x| max|c| + |best|)."""
    xt, ct = torch.from_numpy(x), torch.from_numpy(cb)
    xh, xl = _split_tf32(x)
    ch, cl = _split_tf32(cb)
    c2 = (ct ** 2).sum(1)
    scores = c2[None] - 2 * (xh @ ch.T + (xh @ cl.T + xl @ ch.T))
    top2 = scores.topk(2, dim=1, largest=False).values
    scale = ((xt ** 2).sum(1) * c2.max()).sqrt() + top2[:, 0].abs()
    listed = top2[:, 1] - top2[:, 0] <= NEAR_RTOL * scale
    return scores.argmin(1).int(), listed


def test_near_tie_bound_covers_every_flip():
    """Where the emulated 3xTF32 scores pick another code than the plain fp32
    version (latents between near-duplicate codes), the row is on the
    kernel's rescoring list; Gaussian latents against a Gaussian codebook,
    or against one far smaller, are rarely on it."""
    rs = np.random.RandomState(2)
    m, n, d = 2048, 512, 256
    cb = rs.randn(n, d).astype(np.float32)
    cb[1::2] = cb[0::2] + 1e-3 * rs.randn(n // 2, d).astype(np.float32)
    pair = 2 * rs.randint(0, n // 2, m)
    x = (0.5 * (cb[pair] + cb[pair + 1]) + 0.01 * rs.randn(m, d)).astype(np.float32)
    codes, listed = _listed_near_ties(x, cb)
    flips = codes != nearest_codes_reference(torch.from_numpy(x), torch.from_numpy(cb))
    assert flips.sum() > 0 and bool(listed[flips].all())
    x, cb = _gaussian(3, m, n, d)
    assert _listed_near_ties(x, cb)[1].float().mean() < 0.01
    # a codebook far smaller than the latents, as at initialisation
    assert _listed_near_ties(x, cb / n)[1].float().mean() < 0.01


@pytest.mark.parametrize("m,n", [(8192, 1024), (8192, 4096), (256, 1024), (256, 4096),
                                 (4097, 1024), (1000, 37), (1, 5), (65536, 1024),
                                 (8192, 16384), (8192, 1000)])
def test_scan_split_fills_the_card(m, n):
    """The wrapper's split of the codebook into ranges: as many as one wave
    of one block per SM of a 132-SM card holds (the scan holds one block per
    SM), at least one and at most one per code; whole code tiles per range
    where the tiles divide evenly; the ranges cover [0, n) in order, none
    empty; one partial (score, second score, index) per range and row, a
    rescoring list of m rows, its count, the bits of max |c|^2 and a key per
    listed row, laid out in one buffer."""
    sms = 132
    splits = scan_splits(m, n, sms)
    row_tiles = -(-m // BM)
    assert 1 <= splits <= n
    assert row_tiles * splits <= max(sms, row_tiles)
    assert splits == n or row_tiles * (splits + 1) > sms
    ranges = code_ranges(n, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if n % BN == 0 and (n // BN) % splits == 0:
        assert all(lo % BN == 0 for lo, _ in ranges)
    scratch = scan_scratch(m, splits, "cpu")
    score, second, index, rows, count, keys = scratch_pointers(scratch, m, splits)
    assert keys == scratch.data_ptr() and score - keys == 8 * m and keys % 8 == 0
    assert second - score == index - second == rows - index == 4 * splits * m
    assert count - rows == 4 * m and count + 8 == scratch.data_ptr() + scratch.numel()
    scratch.zero_()
    scratch[count - keys:count - keys + 4].view(torch.int32)[0] = 7
    assert listed_rows(scratch, m, splits) == 7


def test_scan_split_examples():
    """8192 rows (64 row tiles) split N = 1024 into 2 ranges of 4 code tiles
    (128 blocks, one wave) and N = 4096 into 2 of 16 tiles; 256 rows (2 row
    tiles) split N = 1024 into 66 ranges of 15-16 codes (132 blocks, one per
    SM); past 132 row tiles the codebook is one range."""
    assert scan_splits(8192, 1024, 132) == 2
    assert code_ranges(4096, scan_splits(8192, 4096, 132)) == [(0, 2048), (2048, 4096)]
    assert scan_splits(256, 1024, 132) == 66
    assert {hi - lo for lo, hi in code_ranges(1024, 66)} == {15, 16}
    assert scan_splits(65536, 1024, 132) == 1


@pytest.mark.parametrize("name,value", [("BM", BM), ("BN", BN), ("NEAR_RTOL", NEAR_RTOL)])
def test_wrapper_constants_match_the_header(name, value):
    """The wrapper's copies of the scan's tile sizes and near-tie bound, on
    which its split, its scratch and the CPU emulation above rest, hold the
    values ``nearest_codes.cuh`` compiles with."""
    header = (_build.CSRC_DIR / "nearest_codes.cuh").read_text()
    found = re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;", header)
    assert found is not None and float(found.group(1)) == value


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
    # a duplicated codebook row whose copies fall in different code ranges of
    # the scan: the first index wins across ranges too
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, n, d, i, j in [(256, 1024, 256, 5, 900), (8192, 1024, 256, 511, 512)]:
        x, cb = (torch.from_numpy(a).cuda() for a in _gaussian(10, m, n, d))
        ranges = code_ranges(n, scan_splits(m, n, sms))
        assert len({r for r, (lo, hi) in enumerate(ranges) for c in (i, j) if lo <= c < hi}) == 2
        cb[j] = cb[i]
        x[: m // 4] = cb[i]
        got = nearest_codes(x, cb)
        assert (got[: m // 4] == i).all()
        n_mis, n_bad, _ = code_mismatches(x, cb, got, nearest_codes_reference(x, cb))
        assert n_bad == 0 and n_mis <= 1e-4 * m
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
