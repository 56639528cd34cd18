"""GroupNorm -> SiLU: the plain version and the dispatch to the hand-written
kernel (``csrc/gn_silu.cu``, launched by ``gn_silu_cuda.py``).

The kernel replaces no TPU kernel: the JAX package fuses the pair as
``GNSiLU`` / ``_gn_silu_core`` (``vqvae_tpu/models/autoencoder.py:172-272``),
a composition that XLA fuses, with no Pallas kernel. The plain version below
is the op sequence the port's ``GroupNorm`` and ``norm_act`` have always run:
about 13 launches, most of them a read and a write of a full-size fp32
tensor. What bounds the pair on the card is bytes, and the kernel reads its
input once and writes its output once (its source says how).

``gn_silu`` takes the plain version for CPU tensors and the kernel for CUDA
tensors; an input it cannot take, a failed build or a failed launch raises
(no fallback). It is forward only: ``models/autoencoder.py`` sends it the
calls that autograd does not record outside a height-sharded call
(``GroupNorm.takes_kernel``), and runs the plain version as the module's own
form in those two cases. Both versions return their input's memory format:
contiguous NCHW, or channels-last, which the bf16 inference autoencoder
keeps (``models/autoencoder.layout``) and the kernel takes in its NHWC form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_DTYPES = (torch.float32, torch.bfloat16)   # the kernel's element types


def gn_silu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float, ddof: int, dtype: torch.dtype,
                      act: bool = True, shards=None) -> torch.Tensor:
    """SiLU(GroupNorm(x)) (``act``) or GroupNorm(x), x (B, C, H, W), weight and
    bias (1, C, 1, 1): fp32 statistics in two passes (the mean, then the
    centred squares), the variance over ``max(n - ddof, 1)`` (ddof 1 for
    SerezD's layout, 0 for taming's), the affine in fp32, the result rounded
    to ``dtype`` in x's memory format (channels-last stays channels-last),
    then ``F.silu`` on it.

    ``shards`` is None but while a height-sharded call runs
    (``parallel/spatial.py``): then each process holds rows of the image, and
    the two passes' sums (for the mean, then of the centred squares) are
    summed over the processes, so the statistics are the whole image's."""
    b, c, h, w = x.shape
    g = num_groups
    n = (c // g) * h * w
    xg = x.float().reshape(b, g, n)
    if shards is None:
        mean = xg.mean(-1, keepdim=True)
    else:
        n *= shards.size
        mean = shards.sum(xg.sum(-1, keepdim=True)) / n
    centered = xg - mean
    squares = (centered * centered).sum(-1, keepdim=True)
    if shards is not None:
        squares = shards.sum(squares)
    var = squares / max(n - ddof, 1)
    xf = (centered * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    fmt = torch.channels_last if channels_last(x) else torch.preserve_format
    out = (xf * weight + bias).to(dtype, memory_format=fmt)
    return F.silu(out) if act else out


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
            eps: float, ddof: int, dtype: torch.dtype, act: bool = True) -> torch.Tensor:
    """Dispatch: ``x``'s dtype must be ``dtype`` (the kernel writes the
    input's; ValueError otherwise, on every device, so that the CPU tests
    hold the card's rule); CPU tensors -> ``gn_silu_reference``; otherwise
    the kernel (``gn_silu_cuda.gn_silu_cuda``), fp32 or bf16, on ``x`` as it
    lies where it is contiguous NCHW or channels-last bf16 with an NHWC form
    (``gn_silu_cuda.takes``), else on ``x`` made contiguous. The wrapper adds
    the kernels it launched to ``gn_silu.launches``, and the calls that took
    the NHWC form to ``gn_silu.nhwc_calls``."""
    if x.dtype != dtype:
        raise ValueError(f"the kernel writes the input's dtype {x.dtype}, asked for {dtype}")
    if x.is_cpu:
        return gn_silu_reference(x, weight, bias, num_groups, eps, ddof, dtype, act)
    from vqvae_tpu_torch.ops import gn_silu_cuda
    if not gn_silu_cuda.takes(x, num_groups):
        x = x.contiguous()
    return gn_silu_cuda.gn_silu_cuda(x, weight, bias, num_groups, eps, ddof, act)


gn_silu.launches = 0
gn_silu.nhwc_calls = 0


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is a channels-last (NHWC in memory) 4-D tensor that is not
    also contiguous NCHW."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))

