"""Launch wrappers of the Hopper kernels of the discriminator's fused
backward: B3 (``vqt_blur_t_gate``, counterpart of
``vqvae_tpu/ops/fused_dbwd.py::blur_t_gate_pallas``) and B4
(``vqt_skip_fanout_bwd``, counterpart of ``skip_fanout_bwd_pallas``), both
in ``csrc/fused_dbwd.cu``. The library is built and loaded at the first
launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from vqvae_tpu_torch.ops import _build, fused_dbwd

_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1


def library() -> ctypes.CDLL:
    """B3's and B4's library, built at the first call."""
    lib = _build.load_library("fused_dbwd")
    f, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    lib.vqt_blur_t_gate_partials.argtypes = [i] * 4
    lib.vqt_blur_t_gate_partials.restype = ctypes.c_longlong
    lib.vqt_blur_t_gate.argtypes = [p] * 6 + [i] * 5 + [f] * 6 + [p]
    lib.vqt_blur_t_gate.restype = i
    lib.vqt_skip_fanout_bwd.argtypes = [p] * 3 + [i] * 7 + [f] * 4 + [p]
    lib.vqt_skip_fanout_bwd.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtypes, dim: int) -> None:
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NCHW)")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _same_device(*named) -> None:
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         + ", ".join(f"{n} on {t.device}" for n, t in named))


def _taps(taps):
    taps = [float(t) for t in taps]
    if len(taps) != 4:
        raise ValueError(f"the kernels take a 4-tap filter, got {len(taps)} taps")
    return taps


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def blur_t_gate_cuda(dy: torch.Tensor, p0: torch.Tensor, b0: torch.Tensor, taps,
                     alpha: float, gain: float):
    """B3. dy (B, C, H+1, W+1), p0 (B, C, H, W) fp32 or bf16, b0 (C,) fp32,
    contiguous CUDA tensors -> (dp0 in p0's dtype, db0 (C,) fp32), db0 the
    same bits on every run.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``fused_dbwd.blur_t_gate.launches``; an empty tensor
    launches nothing.
    """
    _check("dy", dy, _DTYPES, 4)
    _check("p0", p0, _DTYPES, 4)
    _check("b0", b0, (torch.float32,), 1)
    _same_device(("dy", dy), ("p0", p0), ("b0", b0))
    bsz, c, h, w = p0.shape
    if dy.dtype != p0.dtype:
        raise ValueError(f"dy is {dy.dtype}, p0 is {p0.dtype}")
    if tuple(dy.shape) != (bsz, c, h + 1, w + 1) or tuple(b0.shape) != (c,):
        raise ValueError(f"shapes dy {tuple(dy.shape)}, p0 {tuple(p0.shape)}, "
                         f"b0 {tuple(b0.shape)}: need (B, C, H+1, W+1), (B, C, H, W), (C,)")
    if bsz * c > _INT_MAX:
        raise ValueError(f"B*C = {bsz * c} exceeds the kernel's grid")
    dp0 = torch.empty_like(p0)
    if p0.numel() == 0:
        return dp0, torch.zeros(c, dtype=torch.float32, device=p0.device)
    taps = _taps(taps)
    lib = library()
    partial = torch.empty(lib.vqt_blur_t_gate_partials(bsz, c, h, w), dtype=torch.float32,
                          device=p0.device)
    db0 = torch.empty(c, dtype=torch.float32, device=p0.device)
    with torch.cuda.device(p0.device):
        code = lib.vqt_blur_t_gate(dy.data_ptr(), p0.data_ptr(), b0.data_ptr(), dp0.data_ptr(),
                                   partial.data_ptr(), db0.data_ptr(), bsz, c, h, w,
                                   int(p0.dtype == torch.bfloat16), *taps, float(alpha),
                                   float(gain), _stream(p0.device))
    _build.check_launch(lib, code, "blur_t_gate")
    fused_dbwd.blur_t_gate.launches += 1
    return dp0, db0


def skip_fanout_bwd_cuda(dc: torch.Tensor, dys: torch.Tensor, taps) -> torch.Tensor:
    """B4. dc (B, C, H, W), dys (B, C, H//2, W//2), one dtype (fp32 or bf16),
    contiguous CUDA tensors -> dc + up2_blur_T(dys) in dc's dtype.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``fused_dbwd.skip_fanout_bwd.launches``; an empty
    tensor launches nothing.
    """
    _check("dc", dc, _DTYPES, 4)
    _check("dys", dys, _DTYPES, 4)
    _same_device(("dc", dc), ("dys", dys))
    bsz, c, h, w = dc.shape
    if dys.dtype != dc.dtype:
        raise ValueError(f"dys is {dys.dtype}, dc is {dc.dtype}")
    if tuple(dys.shape) != (bsz, c, h // 2, w // 2):
        raise ValueError(f"shapes dc {tuple(dc.shape)}, dys {tuple(dys.shape)}: need "
                         "(B, C, H, W), (B, C, H//2, W//2)")
    if bsz * c > _INT_MAX:
        raise ValueError(f"B*C = {bsz * c} exceeds the kernel's grid")
    out = torch.empty_like(dc)
    if dc.numel() == 0:
        return out
    taps = _taps(taps)
    lib = library()
    with torch.cuda.device(dc.device):
        code = lib.vqt_skip_fanout_bwd(dc.data_ptr(), dys.data_ptr(), out.data_ptr(), bsz, c,
                                       h, w, h // 2, w // 2, int(dc.dtype == torch.bfloat16),
                                       *taps, _stream(dc.device))
    _build.check_launch(lib, code, "skip_fanout_bwd")
    fused_dbwd.skip_fanout_bwd.launches += 1
    return out
