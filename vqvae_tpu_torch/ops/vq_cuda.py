"""Launch wrappers of the Hopper nearest-code kernels: B1
(``csrc/nearest_codes.cu``, counterpart of
``vqvae_tpu/ops/vq_pallas.py::nearest_codes_pallas``) and B2
(``csrc/nearest_codes_stats.cu``, counterpart of ``nearest_codes_stats_pallas``).
Each library is built and loaded at its first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.ops import _build, vq

_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """B1's library, built at the first call."""
    lib = _build.load_library("nearest_codes")
    lib.vqt_nearest_codes.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.vqt_nearest_codes.restype = ctypes.c_int
    return lib


def stats_library() -> ctypes.CDLL:
    """B2's library, built at the first call."""
    lib = _build.load_library("nearest_codes_stats")
    lib.vqt_nearest_codes_stats.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
    lib.vqt_nearest_codes_stats.restype = ctypes.c_int
    return lib


def _check_inputs(flat_x: torch.Tensor, codebook: torch.Tensor):
    """-> (M, N, D); raises on any input the kernels do not take."""
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
    return m, n, d


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def nearest_codes_cuda(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(M, D) fp32, (N, D) fp32 contiguous CUDA tensors -> (M,) int32 codes.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``vq.nearest_codes.launches``; an empty batch
    launches nothing.
    """
    m, n, d = _check_inputs(flat_x, codebook)
    out = torch.empty(m, dtype=torch.int32, device=flat_x.device)
    if m == 0:
        return out
    c2 = (codebook ** 2).sum(1)  # as nearest_codes_reference forms it
    lib = library()
    with torch.cuda.device(flat_x.device):
        code = lib.vqt_nearest_codes(flat_x.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
                                     out.data_ptr(), m, n, d, _stream(flat_x.device))
    _build.check_launch(lib, code, "nearest_codes")
    vq.nearest_codes.launches += 1
    return out


def nearest_codes_stats_cuda(flat_x: torch.Tensor, codebook: torch.Tensor):
    """(M, D) fp32, (N, D) fp32 contiguous CUDA tensors -> (codes (M,) int32,
    counts (N,) fp32, dw (N, D) fp32), the same bits on every run.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``vq.nearest_codes_stats.launches``; an empty batch
    launches nothing and gives zero counts and sums.
    """
    m, n, d = _check_inputs(flat_x, codebook)
    dev = flat_x.device
    codes = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return (codes, torch.zeros(n, dtype=torch.float32, device=dev),
                torch.zeros(n, d, dtype=torch.float32, device=dev))
    counts = torch.empty(n, dtype=torch.float32, device=dev)
    dw = torch.empty(n, d, dtype=torch.float32, device=dev)
    c2 = (codebook ** 2).sum(1)  # as B1 and nearest_codes_reference form it
    lib = stats_library()
    with torch.cuda.device(dev):
        code = lib.vqt_nearest_codes_stats(
            flat_x.data_ptr(), codebook.data_ptr(), c2.data_ptr(), codes.data_ptr(),
            counts.data_ptr(), dw.data_ptr(), m, n, d, _stream(dev))
    _build.check_launch(lib, code, "nearest_codes_stats")
    vq.nearest_codes_stats.launches += 1
    return codes, counts, dw
