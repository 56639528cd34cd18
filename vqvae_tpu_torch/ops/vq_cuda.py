"""Launch wrapper of the Hopper nearest-code kernel (csrc/nearest_codes.cu).

Counterpart of ``vqvae_tpu/ops/vq_pallas.py::nearest_codes_pallas``. The
library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.ops import _build, vq

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """The kernel's library, built at the first call."""
    lib = _build.load_library("nearest_codes")
    lib.vqt_nearest_codes.argtypes = _ARGTYPES
    lib.vqt_nearest_codes.restype = ctypes.c_int
    return lib


def nearest_codes_cuda(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(M, D) fp32, (N, D) fp32 contiguous CUDA tensors -> (M,) int32 codes.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``vq.nearest_codes.launches``; an empty batch
    launches nothing.
    """
    for name, t in (("flat_x", flat_x), ("codebook", codebook)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codebook.device != flat_x.device:
        raise ValueError(f"flat_x on {flat_x.device}, codebook on {codebook.device}")
    m, d = flat_x.shape
    n = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"flat_x has D={d}, codebook has D={codebook.shape[1]}")
    if n == 0 or d == 0:
        raise ValueError(f"empty codebook or latents: N={n}, D={d}")
    if m * d > _INT_MAX or n * d > _INT_MAX:
        raise ValueError(f"M={m}, N={n}, D={d} exceed the kernel's int32 sizes")

    out = torch.empty(m, dtype=torch.int32, device=flat_x.device)
    if m == 0:
        return out
    c2 = (codebook ** 2).sum(1)  # as nearest_codes_reference forms it
    lib = library()
    with torch.cuda.device(flat_x.device):
        stream = torch.cuda.current_stream(flat_x.device).cuda_stream
        code = lib.vqt_nearest_codes(flat_x.data_ptr(), codebook.data_ptr(),
                                     c2.data_ptr(), out.data_ptr(), m, n, d, stream)
    _build.check_launch(lib, code, "nearest_codes")
    vq.nearest_codes.launches += 1
    return out
