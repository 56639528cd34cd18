"""Nearest-neighbour code assignment, the VQ hot op, and its fused form with
the EMA update statistics (counterpart of ``vqvae_tpu/ops/vq.py:48-162``).

``|x|^2`` is constant across codes, so the argmin needs only
``|c|^2 - 2 x c^T``. A CPU tensor goes to the plain PyTorch version; a CUDA
tensor goes to the hand-written Hopper kernel (``vq_cuda.py``), and a failed
build or launch raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_codes_reference(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, D), (N, D) -> (M,) int32, fp32 scores, first index
    on ties; the formula of ``vqvae_tpu.ops.vq._nearest_codes_xla``."""
    cb = codebook.float()
    c2 = (cb ** 2).sum(1)
    scores = c2[None] - 2 * (flat_x.float() @ cb.T)
    return scores.argmin(1).int()


def nearest_codes(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook indices for flattened latents: (M, D), (N, D) ->
    (M,) int32. Not differentiable (an integer argmin); gradients reach the
    codebook through the lookup, not through this assignment.

    ``nearest_codes.launches`` counts launches of the CUDA kernel; the launch
    wrapper (``vq_cuda.nearest_codes_cuda``) adds one after each launch that
    succeeded, and nothing else touches it.
    """
    flat_x = flat_x.detach()
    codebook = codebook.detach()
    if flat_x.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_codes_reference(flat_x, codebook)
    from vqvae_tpu_torch.ops import vq_cuda
    # flattened NCHW latents of one image are a transposed view
    return vq_cuda.nearest_codes_cuda(flat_x.contiguous(), codebook.contiguous())


nearest_codes.launches = 0


def nearest_codes_stats_reference(flat_x: torch.Tensor, codebook: torch.Tensor):
    """Plain version of B2: (M, D), (N, D) -> (codes (M,) int32, counts (N,)
    fp32, dw (N, D) fp32) with counts[n] = #{m: codes[m] = n} and dw[n] the
    sum of the rows assigned to n; the formula of
    ``vqvae_tpu.ops.vq._nearest_codes_stats_xla`` (``one_hot(codes).T @ x``)."""
    codes = nearest_codes_reference(flat_x, codebook)
    onehot = F.one_hot(codes.long(), codebook.shape[0]).float()
    return codes, onehot.sum(0), onehot.T @ flat_x.float()


def nearest_codes_stats(flat_x: torch.Tensor, codebook: torch.Tensor):
    """Nearest-code assignment fused with the EMA codebook-update statistics
    (counterpart of ``vqvae_tpu/ops/vq.py:129-162``): (M, D), (N, D) ->
    (codes (M,) int32, counts (N,) fp32, dw (N, D) fp32). Not differentiable:
    counts and dw feed the EMA buffers.

    CPU tensors take ``nearest_codes_stats_reference``; CUDA tensors always
    take kernel B2 (``vq_cuda.nearest_codes_stats_cuda``), whose wrapper adds
    one to ``nearest_codes_stats.launches`` after each launch that succeeded.
    """
    flat_x = flat_x.detach()
    codebook = codebook.detach()
    if flat_x.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_codes_stats_reference(flat_x, codebook)
    from vqvae_tpu_torch.ops import vq_cuda
    return vq_cuda.nearest_codes_stats_cuda(flat_x.contiguous(), codebook.contiguous())


nearest_codes_stats.launches = 0


NEAR_TIE_RTOL = 1e-4


def code_mismatches(flat_x: torch.Tensor, codebook: torch.Tensor,
                    got: torch.Tensor, want: torch.Tensor):
    """Compare two code assignments of the same latents.

    Two fp32 argmins that sum in different orders may pick different codes
    where scores nearly tie. A mismatching row counts as a near-tie when,
    recomputed in float64, the two codes' scores differ by at most
    ``NEAR_TIE_RTOL * (1 + max_n |s_mn|)``. Returns ``(n_mismatch, n_not_near_tie,
    max_gap)``, ``max_gap`` being the largest float64 score gap between the
    two picks over the mismatching rows (0.0 when they agree everywhere).
    """
    rows = (got.long() != want.long()).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0, 0.0
    cb = codebook.double()
    s = (cb ** 2).sum(1)[None] - 2 * (flat_x[rows].double() @ cb.T)
    s_got = s.gather(1, got[rows].long()[:, None])[:, 0]
    s_want = s.gather(1, want[rows].long()[:, None])[:, 0]
    gap = (s_got - s_want).abs()
    tol = NEAR_TIE_RTOL * (1 + s.abs().amax(1))
    return int(rows.numel()), int((~(gap <= tol)).sum()), float(gap.max())
