"""Launch wrapper of the GroupNorm -> SiLU kernel (``vqt_gn_silu`` in
``csrc/gn_silu.cu``). The library is built and loaded at the first launch,
never at import.

The kernel takes a contiguous NCHW tensor or a channels-last bf16 one (NHWC
in memory), each in its own form. ``plan`` picks the NCHW form from the shape:
the cluster form (one read and one write, one kernel; a cluster of
``cluster`` CTAs per (batch, group), each CTA holding a slice of at most
``SLICE_BYTES`` in shared memory) wherever ``MAX_CLUSTER`` CTAs hold a
group, else the two-pass form (statistics, then apply: two kernels).
``plan_nhwc`` picks the NHWC form: the grid form (one read and one write,
one cooperative kernel of one CTA an SM; a round of ``images`` whole
images, each over ``cluster`` CTAs with slices of at most
``GRID_SLICE_BYTES`` of whole pixels) wherever a round holds one image and
the widths take 16-byte accesses, else a two-pass form over bands of
``band`` groups whose channels fill 32-byte sectors. Clusters of 16 are the
H100's non-portable size; a card that cannot place them fails at launch.
The vector path (16-byte accesses) takes aligned pointers and group sizes
and planes (NCHW) or group and channel counts (NHWC) that suit 16 bytes'
worth of elements; otherwise one element an access.
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
NHWC_THREADS = 512          # threads per CTA of the NHWC forms
MAX_BAND = 32               # groups a CTA sums in the NHWC forms, at most
# the plan's rule
SLICE_BYTES = 64 * 1024     # a CTA's slice: three CTAs share an SM
GRID_SLICE_BYTES = 176 * 1024   # the NHWC grid form's slice: one CTA an SM, with the
                                # image's staged partials beside it
CHUNK_BYTES = 32 * 1024     # the two-pass forms' chunk
SECTOR_BYTES = 32           # what an NHWC two-pass band's channels fill at each pixel


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
        ("G", "n", "hw", "bf16", "vec", "cs", "slice", "parts", "act", "ddof", "nhwc",
         "band", "images")] + [("eps", ctypes.c_float)]


class Plan(NamedTuple):
    vec: int         # elements an access: 16 bytes' worth, or 1
    cluster: int     # CTAs per group (NCHW cluster form) or per image (NHWC grid form)
    slice: int       # elements (NHWC: pixels) per CTA or per chunk (two-pass forms)
    parts: int       # two-pass forms: statistics CTAs per group or band; 0 otherwise
    band: int = 0    # NHWC two-pass form: groups a band
    images: int = 0  # NHWC grid form: images a round; 0 in the other forms


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


def nhwc_band(num_groups: int, cg: int, esize: int, aligned: bool):
    """(groups a band, elements an access) of the NHWC two-pass form for
    ``num_groups`` groups of ``cg`` channels of ``esize`` bytes: the fewest
    groups (a power of two dividing ``num_groups``, at most ``MAX_BAND``)
    whose channels fill ``SECTOR_BYTES``; 16-byte accesses where the pointers
    are aligned, the band's channels are a multiple of them and a group's a
    multiple, a half or a quarter of them. None where a pixel's part of the
    band is more accesses than a CTA has threads, or more than a chunk's
    bytes: no NHWC form takes the shape."""
    band = 1
    while (band * cg * esize < SECTOR_BYTES and 2 * band <= MAX_BAND
           and num_groups % (2 * band) == 0):
        band *= 2
    wide = 16 // esize
    vec = wide if aligned and _fits(cg, wide) and band * cg % wide == 0 else 1
    if band * cg // vec > NHWC_THREADS or band * cg * esize > CHUNK_BYTES:
        return None
    return band, vec


def _fits(cg: int, wide: int) -> bool:
    """Whether a group of ``cg`` channels suits accesses of ``wide``: a
    multiple of them, or a half or a quarter of one."""
    return cg % wide == 0 or (wide % cg == 0 and wide // cg <= 4)


def plan_nhwc(batch: int, num_groups: int, cg: int, hw: int, esize: int, aligned: bool,
              sms: int):
    """The NHWC form for ``batch`` images of ``num_groups`` groups of ``cg``
    channels, ``hw`` pixels, ``esize`` bytes an element, on a card with
    ``sms`` SMs (None where ``nhwc_band`` is). The grid form where 16-byte
    accesses suit the widths, a pixel is at most ``NHWC_THREADS`` accesses,
    ``num_groups`` even and at most ``MAX_BAND``, and ``sms`` CTAs hold an image in
    slices of at most ``GRID_SLICE_BYTES``: the most images a round that
    fit, spread evenly over the rounds, each over ``sms // images`` CTAs.
    Else the two-pass form, chunks of about ``CHUNK_BYTES``, with about four
    statistics CTAs per SM over the grid."""
    found = nhwc_band(num_groups, cg, esize, aligned)
    if found is None:
        return None
    c, wide = num_groups * cg, 16 // esize
    if (aligned and _fits(cg, wide) and c % wide == 0 and c // wide <= NHWC_THREADS
            and num_groups <= MAX_BAND and num_groups % 2 == 0):
        for images in range(min(batch, sms), 0, -1):
            if -(-hw // (sms // images)) * c * esize <= GRID_SLICE_BYTES:
                images = -(-batch // -(-batch // images))   # as many rounds, evened out
                cs = sms // images
                return Plan(wide, cs, -(-hw // cs), 0, 0, images)
    band, vec = found
    row = band * cg * esize   # bytes of a pixel's part of a band
    chunk = CHUNK_BYTES // row
    bands = batch * num_groups // band
    return Plan(vec, 0, chunk, min(-(-hw // chunk), max(1, -(-4 * sms // bands))), band)


def takes(x: torch.Tensor, num_groups: int) -> bool:
    """Whether the kernel takes ``x`` as it lies: contiguous NCHW, or
    channels-last bf16 with an NHWC form for its shape (the NHWC forms are
    for the bf16 inference autoencoder's layout; fp32 keeps NCHW)."""
    if not gn_silu.channels_last(x):
        return x.is_contiguous()
    c = x.shape[1]
    return (x.dtype == torch.bfloat16 and num_groups > 0 and c % num_groups == 0
            and nhwc_band(num_groups, c // num_groups, 2, x.data_ptr() % 16 == 0) is not None)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, C, H, W), got shape {tuple(x.shape)}")
    if x.dtype not in gn_silu.KERNEL_DTYPES:
        raise ValueError(f"x must be one of {gn_silu.KERNEL_DTYPES}, got {x.dtype}")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{c} channels do not divide into {num_groups} groups")
    if not takes(x, num_groups):
        raise ValueError("x must be contiguous (NCHW), or channels-last (NHWC) with a band "
                         "the NHWC form takes")
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
          act: bool, eps: float, ddof: int, index: int, nhwc: bool) -> tuple:
    """(the launch's Args, its address, the plan) of a call; kept from call
    to call, so that a launch passes one pointer for them."""
    n = (c // num_groups) * h * w
    if n > _INT_MAX:
        raise ValueError(f"a group of {n} elements exceeds the kernel's 32-bit offsets")
    esize = 2 if bf16 else 4
    if nhwc:
        p = plan_nhwc(b, num_groups, c // num_groups, h * w, esize, aligned, _sms(index))
    else:
        p = plan(b * num_groups, n, h * w, esize, aligned, _sms(index))
    args = Args(b * num_groups, num_groups, n, h * w, int(bf16), p.vec, p.cluster, p.slice,
                p.parts, int(act), int(ddof), int(nhwc), p.band, p.images, eps)
    return args, ctypes.addressof(args), p


def gn_silu_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                 eps: float, ddof: int, act: bool) -> torch.Tensor:
    """x (B, C, H, W) fp32 or bf16 CUDA, contiguous NCHW or channels-last bf16
    (``takes``); weight and bias C fp32 values each -> SiLU(GroupNorm(x))
    (``act``) or GroupNorm(x) in x's dtype and memory format, the variance
    over ``max(n - ddof, 1)``; the same bits on every run.

    Launches on x's card's current stream and does not synchronize. Raises
    on any input the kernel does not take and on a failed build or launch.
    Each call adds the kernels it launched to ``gn_silu.gn_silu.launches``:
    one in the cluster form, two in the two-pass form, none for an empty
    tensor; and a call in the NHWC form adds one to
    ``gn_silu.gn_silu.nhwc_calls``.
    """
    _check(x, weight, bias, num_groups)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    index = x.get_device()
    xp, yp = x.data_ptr(), out.data_ptr()
    nhwc = gn_silu.channels_last(x)
    _, address, p = _args(*x.shape, num_groups, x.dtype == torch.bfloat16,
                          xp % 16 == 0 and yp % 16 == 0, bool(act), float(eps), int(ddof), index,
                          nhwc)
    # scratch: the two-pass forms' (mean, M2) in double per group and part,
    # the grid form's in float per group and CTA for two rounds
    size = (x.shape[0] * num_groups * p.parts * 2 if p.parts
            else 2 * p.images * p.cluster * num_groups if p.images else 0)
    partials = torch.empty(size, dtype=torch.float64, device=x.device) if size else None
    lib = library()
    call = (xp, weight.data_ptr(), bias.data_ptr(), yp,
            None if partials is None else partials.data_ptr(), address,
            torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        code = lib.vqt_gn_silu(*call)
    _build.check_launch(lib, code, "gn_silu")
    gn_silu.gn_silu.launches += 2 if p.parts else 1
    gn_silu.gn_silu.nhwc_calls += nhwc
    return out
