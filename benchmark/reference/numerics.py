"""How the plain reference computes its convolutions and matrix products.

Every convolution and matrix product of the reference goes through ``conv2d``
and ``matmul`` here, in one of three modes (``mode``):

- ``fp32``: float32 operands, float32 sums, TF32 off. The reference proper.
- ``tf32``: each operand rounded to TF32 (10 mantissa bits, round to nearest
  even) first, then float32 sums: what the tensor cores' TF32 mode does to
  a float32 product. The control of a float32 configuration.
- ``fp8``: each operand rounded to float8 e4m3 with a per-tensor scale
  (largest magnitude to 448), float32 sums, and the result rounded to fp8
  again, as a bf16 program stores its products in bf16. The control of a
  bfloat16 configuration. In training the rounding passes the gradient
  straight through, so the backward products stay float32.

The rounding is done by hand, so a mode gives the same numbers on the CPU
and on the card.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
_state = {"mode": "fp32"}


@contextmanager
def mode(name: str):
    """Run the reference's products in ``name`` while entered; TF32 is off
    in every mode (a lower precision is applied by hand)."""
    if name not in MODES:
        raise ValueError(f"unknown numerics mode {name!r}")
    saved = (_state["mode"], torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _state["mode"] = name
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (_state["mode"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8 e4m3 with a per-tensor scale, back as float32."""
    x = x.float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _operand(x: torch.Tensor) -> torch.Tensor:
    m = _state["mode"]
    if m == "fp32":
        return x.float()
    rounded = round_tf32(x.detach()) if m == "tf32" else round_fp8(x.detach())
    x = x.float()
    return x + (rounded - x).detach()


def _result(y: torch.Tensor) -> torch.Tensor:
    """A product as the mode stores it: rounded to fp8 in ``fp8`` mode."""
    if _state["mode"] != "fp8":
        return y
    return y + (round_fp8(y.detach()) - y).detach()


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    """``F.conv2d`` with both operands in the mode's precision, the bias
    added in float32, the result stored in the mode's precision."""
    y = F.conv2d(_operand(x), _operand(w), None, stride=stride, padding=padding, groups=groups)
    if b is not None:
        y = y + b.float().reshape(1, -1, 1, 1)
    return _result(y)


def matmul(a, b):
    return _result(_operand(a) @ _operand(b))
