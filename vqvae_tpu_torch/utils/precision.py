"""Eval-grade numerics: fp32 matmuls and cuDNN convolutions in true fp32.

On the card, TF32 rounds the inputs of an fp32 matmul or convolution to 10
mantissa bits. The JAX package pins ``Precision.HIGHEST`` where that matters
(the entropy quantizer's distances, SSIM's blur, the FID network), and its
eval CLIs set ``set_matmul_precision("highest")``; ``full_fp32`` is the
counterpart for one block of code. It changes nothing on the CPU.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions while entered; the
    previous settings come back on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def set_full_fp32() -> None:
    """TF32 off for the rest of the process (the eval CLIs' setting)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
