"""Launch wrapper of the GroupNorm -> SiLU kernel (``vqt_gn_silu`` in
``csrc/gn_silu.cu``). The library is built and loaded at the first launch,
never at import.

``plan`` picks the kernel's form from the shape: the cluster form (one read
and one write, one kernel; a cluster of ``cluster`` CTAs per (batch, group),
each CTA holding a slice of at most ``SLICE_BYTES`` in shared memory)
wherever ``MAX_CLUSTER`` CTAs hold a group, else the two-pass form
(statistics, then apply: two kernels). Clusters of 16 are the H100's
non-portable size; a card that cannot place them fails at launch. The
vector path (16-byte accesses) takes group sizes and planes that are
multiples of 16 bytes' worth of elements and aligned pointers; otherwise
one element an access.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from vqvae_tpu_torch.ops import _build, gn_silu

_INT_MAX = 2 ** 31 - 1
# copies of gn_silu.cu's constants (a test compares them)
THREADS = 256               # threads per CTA
MAX_CLUSTER = 16            # CTAs per group in the cluster form, at most
# the plan's rule
SLICE_BYTES = 64 * 1024     # a CTA's slice: three CTAs share an SM
CHUNK_BYTES = 32 * 1024     # the two-pass form's chunk


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's library, built at the first call."""
    lib = _build.load_library("gn_silu")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.vqt_gn_silu.argtypes = [p] * 7
    lib.vqt_gn_silu.restype = i
    return lib


class Args(ctypes.Structure):
    """gn_silu.cu's GnArgs: a call's shape and form."""
    _fields_ = [("groups", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in
        ("G", "n", "hw", "bf16", "vec", "cs", "slice", "parts", "act", "ddof")] + [
        ("eps", ctypes.c_float)]


class Plan(NamedTuple):
    vec: int       # elements an access: 16 bytes' worth, or 1
    cluster: int   # cluster form: CTAs per group; 0 in the two-pass form
    slice: int     # elements per CTA (cluster form) or per chunk (two-pass form)
    parts: int     # two-pass form: statistics CTAs per group; 0 in the cluster form


def plan(groups: int, n: int, hw: int, esize: int, aligned: bool, sms: int) -> Plan:
    """The form for ``groups`` groups of ``n`` elements of ``esize`` bytes,
    planes of ``hw``, on a card with ``sms`` SMs: the cluster form with the
    fewest CTAs per group whose slice is at most ``SLICE_BYTES``; where even
    ``MAX_CLUSTER`` CTAs need more, the two-pass form, chunks of
    ``CHUNK_BYTES``, with about four statistics CTAs per SM over the grid."""
    wide = 16 // esize
    vec = wide if aligned and n % wide == 0 and hw % wide == 0 else 1
    cs = 1
    while True:
        cut = -(-n // (cs * vec)) * vec
        if cut * esize <= SLICE_BYTES:
            return Plan(vec, cs, cut, 0)
        if cs == MAX_CLUSTER:
            break
        cs *= 2
    chunk = CHUNK_BYTES // esize
    chunks = -(-n // chunk)
    return Plan(vec, 0, chunk, min(chunks, max(1, -(-4 * sms // groups))))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in gn_silu.KERNEL_DTYPES:
        raise ValueError(f"x must be one of {gn_silu.KERNEL_DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NCHW)")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{c} channels do not divide into {num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.numel() != c or not t.is_contiguous():
            raise ValueError(f"{name} must be {c} contiguous fp32 values, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.get_device() != x.get_device():
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")


@functools.lru_cache(maxsize=4096)
def _args(b: int, c: int, h: int, w: int, num_groups: int, bf16: bool, aligned: bool,
          act: bool, eps: float, ddof: int, index: int) -> tuple:
    """(the launch's Args, its address, the plan) of a call; kept from call
    to call, so that a launch passes one pointer for them."""
    n = (c // num_groups) * h * w
    if n > _INT_MAX:
        raise ValueError(f"a group of {n} elements exceeds the kernel's 32-bit offsets")
    p = plan(b * num_groups, n, h * w, 2 if bf16 else 4, aligned, _sms(index))
    args = Args(b * num_groups, num_groups, n, h * w, int(bf16), p.vec, p.cluster, p.slice,
                p.parts, int(act), int(ddof), eps)
    return args, ctypes.addressof(args), p


def gn_silu_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                 eps: float, ddof: int, act: bool) -> torch.Tensor:
    """x (B, C, H, W) fp32 or bf16, contiguous CUDA; weight and bias C fp32
    values each -> SiLU(GroupNorm(x)) (``act``) or GroupNorm(x) in x's dtype,
    the variance over ``max(n - ddof, 1)``; the same bits on every run.

    Launches on x's card's current stream and does not synchronize. Raises
    on any input the kernel does not take and on a failed build or launch.
    Each call adds the kernels it launched to ``gn_silu.gn_silu.launches``:
    one in the cluster form, two in the two-pass form, none for an empty
    tensor.
    """
    _check(x, weight, bias, num_groups)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    index = x.get_device()
    xp, yp = x.data_ptr(), out.data_ptr()
    _, address, p = _args(*x.shape, num_groups, x.dtype == torch.bfloat16,
                          xp % 16 == 0 and yp % 16 == 0, bool(act), float(eps), int(ddof), index)
    partials = (torch.empty(x.shape[0] * num_groups * p.parts * 2, dtype=torch.float64,
                            device=x.device) if p.parts else None)
    lib = library()
    call = (xp, weight.data_ptr(), bias.data_ptr(), yp,
            None if partials is None else partials.data_ptr(), address,
            torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        code = lib.vqt_gn_silu(*call)
    _build.check_launch(lib, code, "gn_silu")
    gn_silu.gn_silu.launches += 2 if p.parts else 1
    return out
