"""How far the GroupNorm -> SiLU kernel's outputs lie from the plain
version's (``vqvae_tpu_torch/ops/gn_silu.py``): the measure of the card
tests in ``test_torch_gn_silu.py`` and of ``chip_smoke.py``.

The limit of each GroupNorm value is taken at the affine's scale, the sum
of its terms' magnitudes, not at the value itself: where the terms cancel,
either version's fp32 rounding moves the result by more than an ulp of the
result.

- bf16 output: one bf16 ulp of |x - mean| rstd |w| + |b|.
- fp32 output: ``FP32_LIMIT`` of (|x - mean| + |mean|) rstd |w| + |b|. The
  |mean| term carries the statistics' rounding. Each version sums the mean
  in another order, so the two means differ by some fp32 ulps of |mean|,
  and ``rstd |w|`` scales that difference into every output. Against the
  float64 result, the plain version alone misses the limit without the
  term by 2367 times at mean 50, std 1; with the term it is at 0.022
  (PERF.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.ops.gn_silu import gn_silu_reference

FP32_LIMIT = 4e-6   # fp32: the share of the scale


@torch.no_grad()
def kernel_error(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                 eps: float, ddof: int, norm: torch.Tensor, act: torch.Tensor,
                 rows: int = 8) -> float:
    """The worst share of the limit (<= 1 passes) of the kernel's outputs
    for ``x``: ``norm`` is the GroupNorm alone, ``act`` the GroupNorm with the
    SiLU. inf where ``act`` is not ``F.silu(norm)`` bit for bit. Takes
    ``rows`` images at a time."""
    b, c, h, w = x.shape
    n = (c // num_groups) * h * w
    bf16 = x.dtype == torch.bfloat16
    worst = 0.0
    for i in range(0, b, rows):
        xs = x[i:i + rows].float().reshape(-1, num_groups, n)
        mean = xs.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((xs - mean) ** 2).sum(-1, keepdim=True) / max(n - ddof, 1) + eps)
        terms = ((xs - mean).abs() + (0 if bf16 else mean.abs())) * rstd
        scale = (terms.reshape(-1, c, h, w) * weight.abs().reshape(1, c, 1, 1)
                 + bias.abs().reshape(1, c, 1, 1))
        if bf16:
            scale = scale.clamp(min=torch.finfo(torch.bfloat16).tiny)
            unit = torch.exp2(torch.floor(torch.log2(scale)) - 7)
        else:
            unit = FP32_LIMIT * scale.clamp(min=torch.finfo(torch.float32).tiny)
        want = gn_silu_reference(x[i:i + rows], weight, bias, num_groups, eps, ddof, x.dtype,
                                 act=False)
        got = norm[i:i + rows]
        worst = max(worst, float(((got.float() - want.float()).abs() / unit).max()))
        if not torch.equal(act[i:i + rows], F.silu(got)):
            return float("inf")
    return worst
