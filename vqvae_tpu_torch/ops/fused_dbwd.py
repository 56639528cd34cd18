"""The discriminator's fused backward (counterpart of ``vqvae_tpu/ops/fused_dbwd.py``).

Two ``torch.autograd.Function``s wrap spans of a ``DiscriminatorBlock``.
Their forward is exactly the plain ops; only the backward changes:

- ``FusedActBlur``: conv0's bias + lrelu, then the [1,3,3,1]/8 FIR that
  conv1 (down 2) filters with; its backward is B3, ``blur_t_gate``:
  ``dp0 = blur_T(dy) * gain lrelu'(p0 + b0)`` and ``db0 = sum dp0``.
- ``FusedSkipFanout``: the block input's fan-out into conv0 and the skip
  path's down-2 FIR; its backward is B4, ``skip_fanout_bwd``:
  ``dc + up2_blur_T(dys)``.

Both are first-order only (``once_differentiable``): the R1 penalty, which
differentiates D twice, runs the plain module. CPU tensors take the plain
versions (``*_reference``, the formulas of ``_blur_t_gate_xla`` and
``_skip_fanout_bwd_xla``); CUDA tensors take the hand-written kernels
(``fused_dbwd_cuda.py``), and a failed build or launch raises: there is no
fallback for CUDA tensors. NCHW throughout.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from vqvae_tpu_torch.ops.bias_act import lrelu
from vqvae_tpu_torch.ops.upfirdn2d import upfirdn2d

TAPS = (1 / 8, 3 / 8, 3 / 8, 1 / 8)   # the [1,3,3,1] low-pass, unit DC gain


def _f2d(taps: Sequence[float]) -> np.ndarray:
    t = np.asarray(taps, np.float32)
    return np.outer(t, t)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def blur_t_gate_reference(dy, p0, b0, taps=TAPS, alpha: float = 0.2,
                          gain: float = float(np.sqrt(2))):
    """Plain B3: dy (B, C, H+1, W+1), p0 (B, C, H, W), b0 (C,) -> (dp0 in
    p0's dtype, db0 in b0's dtype). The adjoint of ``upfirdn2d(., f,
    padding=2)`` is the correlation with the same filter at pads 1; the gate
    is taken from ``p0 + b0`` summed in p0's dtype, as the forward sums them."""
    da = upfirdn2d(dy, _f2d(taps), padding=1, flip_filter=True)
    s = p0 + b0.to(p0.dtype)[None, :, None, None]
    gate = torch.where(s >= 0, gain, gain * alpha).float()
    prod = da.float() * gate
    return prod.to(p0.dtype), prod.sum((0, 2, 3)).to(b0.dtype)


def skip_fanout_bwd_reference(dc, dys, taps=TAPS):
    """Plain B4: dc (B, C, H, W), dys (B, C, H//2, W//2) -> dc + the adjoint
    of ``upfirdn2d(., f, down=2, padding=1)`` applied to dys (the up-2 FIR at
    transpose pads (2, 1), one more high pad for an odd side), in dc's dtype."""
    h, w = dc.shape[2], dc.shape[3]
    da = upfirdn2d(dys, _f2d(taps), up=2, padding=(2, 1 + w % 2, 2, 1 + h % 2),
                   flip_filter=True)
    return dc + da.to(dc.dtype)


def blur_t_gate(dy, p0, b0, taps=TAPS, alpha: float = 0.2, gain: float = float(np.sqrt(2))):
    """B3 dispatch: CPU tensors -> ``blur_t_gate_reference``; otherwise the
    kernel (``fused_dbwd_cuda.blur_t_gate_cuda``), whose wrapper adds one to
    ``blur_t_gate.launches`` after each launch that succeeded."""
    if _on_cpu(dy, p0, b0):
        return blur_t_gate_reference(dy, p0, b0, taps, alpha, gain)
    from vqvae_tpu_torch.ops import fused_dbwd_cuda
    return fused_dbwd_cuda.blur_t_gate_cuda(dy, p0, b0, taps, alpha, gain)


blur_t_gate.launches = 0


def skip_fanout_bwd(dc, dys, taps=TAPS):
    """B4 dispatch: CPU tensors -> ``skip_fanout_bwd_reference``; otherwise
    the kernel (``fused_dbwd_cuda.skip_fanout_bwd_cuda``), whose wrapper adds
    one to ``skip_fanout_bwd.launches`` after each launch that succeeded."""
    if _on_cpu(dc, dys):
        return skip_fanout_bwd_reference(dc, dys, taps)
    from vqvae_tpu_torch.ops import fused_dbwd_cuda
    return fused_dbwd_cuda.skip_fanout_bwd_cuda(dc, dys, taps)


skip_fanout_bwd.launches = 0


def act_blur(p0, b0, taps=TAPS, alpha: float = 0.2, gain: float = float(np.sqrt(2))):
    """The plain span: ``upfirdn2d(lrelu(p0 + b0) * gain, f, padding=2)``."""
    a = lrelu(p0 + b0.to(p0.dtype)[None, :, None, None], alpha) * gain
    return upfirdn2d(a, _f2d(taps), padding=2)


class FusedActBlur(torch.autograd.Function):
    """``act_blur`` with B3 as its backward (``make_fused_act_blur``)."""

    @staticmethod
    def forward(ctx, p0, b0, taps, alpha, gain):
        ctx.save_for_backward(p0, b0)
        ctx.cfg = (tuple(taps), float(alpha), float(gain))
        return act_blur(p0, b0, taps, alpha, gain)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        p0, b0 = ctx.saved_tensors
        dp0, db0 = blur_t_gate(dy.contiguous(), p0.contiguous(), b0.contiguous(), *ctx.cfg)
        return dp0, db0, None, None, None


def skip_fanout(x, taps=TAPS):
    """The plain fan-out: ``(x, upfirdn2d(x, f, down=2, padding=1))``."""
    return x, upfirdn2d(x, _f2d(taps), down=2, padding=1)


class FusedSkipFanout(torch.autograd.Function):
    """``skip_fanout`` with B4 as its backward (``make_fused_skip_fanout``):
    the skip FIR's transpose and the add of the two branches' cotangents in
    one pass."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = tuple(taps)
        return skip_fanout(x, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dc, dys):
        return skip_fanout_bwd(dc.contiguous(), dys.contiguous(), ctx.taps), None
