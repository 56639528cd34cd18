"""Launch wrappers of the Hopper kernels of the discriminator's fused
backward: B3 (``vqt_blur_t_gate``, counterpart of
``vqvae_tpu/ops/fused_dbwd.py::blur_t_gate_pallas``) and B4
(``vqt_skip_fanout_bwd``, counterpart of ``skip_fanout_bwd_pallas``), both
in ``csrc/fused_dbwd.cu``. The library is built and loaded at the first
launch, never at import.

Both kernels give each worker (``seg_width`` lanes of a warp) a strip of
rows of one plane; ``geometry`` picks the segment width and the strip
height, ``vector_path`` the 16-byte path or the scalar one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vqvae_tpu_torch.ops import _build, fused_dbwd

_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1
# copies of fused_dbwd.cu's constants (a test compares them)
THREADS = 256          # threads per block
VEC = 8                # output columns per lane on the vector path
# the strip rule (geometry)
MAX_STRIP = 64         # rows of a strip, at most
MIN_WAVES = 4          # blocks per SM the strip height aims for, at least


@functools.cache
def library() -> ctypes.CDLL:
    """B3's and B4's library, built at the first call."""
    lib = _build.load_library("fused_dbwd")
    f, i, p, ll = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.vqt_blur_t_gate.argtypes = [p] * 5 + [ll] + [p] * 2 + [i] * 8 + [f] * 6 + [p]
    lib.vqt_blur_t_gate.restype = i
    lib.vqt_skip_fanout_bwd.argtypes = [p] * 3 + [i] * 8 + [f] * 4 + [p]
    lib.vqt_skip_fanout_bwd.restype = i
    return lib


class Geometry(NamedTuple):
    seg_width: int     # lanes of a worker: a power of two <= 32
    segments: int      # workers across a row
    strip: int         # rows a worker walks down
    strips: int        # strips of a plane
    blocks: int        # the grid


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def geometry(planes: int, rows: int, lanes: int, sms: int) -> Geometry:
    """How the kernels cut ``planes`` planes of ``rows`` rows, ``lanes``
    lanes to a row, on a card with ``sms`` SMs. A row's lanes form one
    segment (the next power of two, so that narrow planes pack several
    segments, several planes, into a warp) or, past 32, several of 32. The
    strip is ``MAX_STRIP`` rows (or the plane's), halved while the grid has
    fewer than ``MIN_WAVES`` blocks per SM, down to one row."""
    sw = min(32, 1 << (lanes - 1).bit_length())
    nseg = _ceil_div(lanes, sw)
    per_block = THREADS // sw
    strip = min(MAX_STRIP, rows)
    while True:
        strips = _ceil_div(rows, strip)
        blocks = _ceil_div(planes * nseg * strips, per_block)
        if strip == 1 or blocks >= MIN_WAVES * sms:
            return Geometry(sw, nseg, strip, strips, blocks)
        strip = _ceil_div(strip, 2)


def vector_path(w: int, *aligned: bool) -> bool:
    """The 16-byte path takes rows of a multiple of ``VEC`` columns and the
    aligned pointers it needs; else the scalar path."""
    return w % VEC == 0 and all(aligned)


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def blur_t_gate_geometry(b: int, c: int, h: int, w: int, vec: bool, sms: int) -> Geometry:
    """B3: rows of ``w`` output columns, ``VEC`` to a lane on the vector path."""
    return geometry(b * c, h, w // VEC if vec else w, sms)


def skip_fanout_bwd_geometry(b: int, c: int, h: int, w: int, vec: bool, sms: int) -> Geometry:
    """B4: a row is a pair of output rows; ``VEC`` output columns to a lane on
    the vector path, 2 on the scalar one."""
    return geometry(b * c, _ceil_div(h, 2), w // VEC if vec else _ceil_div(w, 2), sms)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    vec = vector_path(w, _aligned(p0, 16), _aligned(dp0, 16))
    geo = blur_t_gate_geometry(bsz, c, h, w, vec, _sms(p0.device.index))
    n_partial = bsz * c * geo.segments * geo.strips
    partial = torch.empty(n_partial, dtype=torch.float64, device=p0.device)
    db0 = torch.empty(c, dtype=torch.float32, device=p0.device)
    # per-channel arrival counters (the channel's last worker writes db0); the
    # launcher zeroes them before each launch
    arrivals = torch.empty(c, dtype=torch.int32, device=p0.device)
    with torch.cuda.device(p0.device):
        code = lib.vqt_blur_t_gate(dy.data_ptr(), p0.data_ptr(), b0.data_ptr(), dp0.data_ptr(),
                                   partial.data_ptr(), n_partial, arrivals.data_ptr(),
                                   db0.data_ptr(), bsz, c, h, w,
                                   int(p0.dtype == torch.bfloat16), int(vec), geo.seg_width,
                                   geo.strip, *taps, float(alpha), float(gain),
                                   _stream(p0.device))
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
    vec = vector_path(w, _aligned(dc, 16), _aligned(out, 16),
                      _aligned(dys, 4 * dys.element_size()))
    geo = skip_fanout_bwd_geometry(bsz, c, h, w, vec, _sms(dc.device.index))
    with torch.cuda.device(dc.device):
        code = lib.vqt_skip_fanout_bwd(dc.data_ptr(), dys.data_ptr(), out.data_ptr(), bsz, c,
                                       h, w, int(dc.dtype == torch.bfloat16), int(vec),
                                       geo.seg_width, geo.strip, *taps, _stream(dc.device))
    _build.check_launch(lib, code, "skip_fanout_bwd")
    fused_dbwd.skip_fanout_bwd.launches += 1
    return out
