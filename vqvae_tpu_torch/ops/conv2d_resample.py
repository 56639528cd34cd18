"""2-D convolution fused with FIR up/downsampling (counterpart of
``vqvae_tpu/ops/conv2d_resample.py``, reference conv2d_resample.py:59-154):
the same padding arithmetic and branch order, on NCHW images with OIHW
weights. ``flip_weight=True`` is correlation (``F.conv2d``'s own sense).

Derivatives (the reference's ``conv2d_gradfix``): the dense conv is
``_Conv2d``, whose backward gives the input gradient as ``_Conv2dInput``
and the weight gradient as ``_Conv2dWeight``; the backward of each of the
three is again made of the three. So a derivative of any order (R1 takes
the second) is a forward conv, an input-gradient conv or a weight-gradient
conv of the layer's own size: autograd's generic double backward forms the
second-order weight gradient as a forward conv whose kernel is the whole
gradient image. A Function's ``needs_input_grad`` is fixed at its forward,
so the caller says where the first-order weight gradient is not wanted:
``no_weight_gradients()`` (the backward toward the input of the R1
penalty, or toward the generator). The FIR steps are ``upfirdn2d``'s.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.ops.upfirdn2d import (_parse_padding, get_filter_size, second_order,
                                           upfirdn2d)

# read by ``_Conv2d.backward``, which autograd runs on its device thread for
# CUDA tensors: a module global reaches it, a thread-local would not
_weight_gradients_disabled = False


@contextlib.contextmanager
def no_weight_gradients():
    """Within: the first-order backward of ``conv2d`` forms no weight
    gradient (reference conv2d_gradfix.py:29-38). Second-order weight
    gradients (``_Conv2dInput.backward``) are formed as before."""
    global _weight_gradients_disabled
    old = _weight_gradients_disabled
    _weight_gradients_disabled = True
    try:
        yield
    finally:
        _weight_gradients_disabled = old


def _conv_backward(dy, x, w, conv, mask):
    """(dx, dw) of ``F.conv2d(x, w, stride, padding)`` as ``mask`` asks, in
    one call of aten's convolution backward; the operand whose gradient is
    not asked may be a shape-only stand-in."""
    stride, padding = conv
    return torch.ops.aten.convolution_backward(dy, x, w, None, stride, padding, (1, 1), False,
                                               (0, 0), 1, (*mask, False))[:2]


class _Conv2d(torch.autograd.Function):
    """``F.conv2d(x, w, stride=stride, padding=padding)``, no bias."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x = ctx.needs_input_grad[0]
        need_w = ctx.needs_input_grad[1] and not _weight_gradients_disabled
        if not torch.is_grad_enabled():   # first order only: one call, as autograd's own node
            dx, dw = _conv_backward(dy, x, w, ctx.conv, (need_x, need_w))
            return dx, dw, None, None
        dx = _Conv2dInput.apply(dy, w, x.shape, *ctx.conv) if need_x else None
        dw = _Conv2dWeight.apply(x, dy, w.shape, *ctx.conv) if need_w else None
        return dx, dw, None, None


class _Conv2dInput(torch.autograd.Function):
    """The input gradient of ``_Conv2d``: (dy, w) -> dx of shape ``in_shape``."""

    @staticmethod
    def forward(ctx, dy, w, in_shape, stride, padding):
        ctx.save_for_backward(dy, w)
        ctx.conv = (stride, padding)
        return _conv_backward(dy, dy.new_empty(1).expand(in_shape), w, ctx.conv,
                              (True, False))[0]

    @staticmethod
    def backward(ctx, ddx):
        second_order.calls += 1
        dy, w = ctx.saved_tensors
        d_dy = d_w = None
        if ctx.needs_input_grad[0]:
            d_dy = _Conv2d.apply(ddx, w, *ctx.conv)
        if ctx.needs_input_grad[1]:
            d_w = _Conv2dWeight.apply(ddx, dy, w.shape, *ctx.conv)
        return d_dy, d_w, None, None, None


class _Conv2dWeight(torch.autograd.Function):
    """The weight gradient of ``_Conv2d``: (x, dy) -> dw of shape ``w_shape``."""

    @staticmethod
    def forward(ctx, x, dy, w_shape, stride, padding):
        ctx.save_for_backward(x, dy)
        ctx.conv = (stride, padding)
        return _conv_backward(dy, x, x.new_empty(1).expand(w_shape), ctx.conv,
                              (False, True))[1]

    @staticmethod
    def backward(ctx, ddw):
        x, dy = ctx.saved_tensors
        d_x = d_dy = None
        if ctx.needs_input_grad[0]:
            d_x = _Conv2dInput.apply(dy, ddw, x.shape, *ctx.conv)
        if ctx.needs_input_grad[1]:
            d_dy = _Conv2d.apply(x, ddw, *ctx.conv)
        return d_x, d_dy, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0,
           flip_weight: bool = True) -> torch.Tensor:
    """Dense conv, weight cast to x's dtype; ``padding`` int or (py, px)."""
    if not flip_weight:
        w = w.flip([2, 3])
    if isinstance(padding, int):
        padding = (padding, padding)
    return _Conv2d.apply(x, w.to(x.dtype), (stride, stride), tuple(padding))


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1, down: int = 1,
                    padding: int = 0, flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Convolution with optional FIR resampling; padding applied once, up front."""
    assert up >= 1 and down >= 1
    kh, kw = w.shape[2], w.shape[3]
    fw, fh = get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: FIR+down fused, then pointwise conv
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return conv2d(x, w, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: pointwise conv, then FIR+up
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = conv2d(x, w, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)

    # downsampling only: FIR pad+filter, then strided conv
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return conv2d(x, w, stride=down, flip_weight=flip_weight)

    # plain conv with symmetric non-negative padding
    if up == 1 and down == 1 and px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return conv2d(x, w, padding=(py0, px0), flip_weight=flip_weight)

    # generic: upsample (with the filter if up > 1), conv, downsample
    x = upfirdn2d(x, (f if up > 1 else None), up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2 if up > 1 else 1, flip_filter=flip_filter)
    x = conv2d(x, w, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
