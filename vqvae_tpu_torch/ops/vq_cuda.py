"""Launch wrappers of the Hopper nearest-code kernels: B1
(``csrc/nearest_codes.cu``, counterpart of
``vqvae_tpu/ops/vq_pallas.py::nearest_codes_pallas``) and B2
(``csrc/nearest_codes_stats.cu``, counterpart of ``nearest_codes_stats_pallas``).
Each library is built and loaded at its first launch, never at import.

Both scan the codebook with ``csrc/nearest_codes.cuh``: a grid of row tiles
(``BM`` rows each) by code ranges, each block writing one partial
(score, index, second-best score) per row into scratch that the wrapper
allocates, then a merge of each row's partials that lists the rows whose
best two scores lie within ``NEAR_RTOL`` (|x| max|c| + |best|), and an fp32
rescoring of those rows. ``scan_splits`` picks the number of ranges.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqvae_tpu_torch.ops import _build, vq

_INT_MAX = 2 ** 31 - 1
# copies of nearest_codes.cuh's constants (tests compare them)
BM = BN = 128          # rows per block and codes per code tile
NEAR_RTOL = 2e-5       # the near-tie bound
_MAX_SPLITS = 65535    # gridDim.y


@functools.cache
def library() -> ctypes.CDLL:
    """B1's library, built at the first call."""
    lib = _build.load_library("nearest_codes")
    lib.vqt_nearest_codes.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.vqt_nearest_codes.restype = ctypes.c_int
    return lib


@functools.cache
def stats_library() -> ctypes.CDLL:
    """B2's library, built at the first call."""
    lib = _build.load_library("nearest_codes_stats")
    lib.vqt_nearest_codes_stats.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
    lib.vqt_nearest_codes_stats.restype = ctypes.c_int
    return lib


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def scan_splits(m: int, n: int, sms: int) -> int:
    """Number of code ranges the scan splits an (m rows, n codes) problem
    into on a card with ``sms`` SMs: as many as one wave holds, one block per
    SM (at 254 registers a thread only one scan block fits on an SM), and at
    least one.

    ``chip_smoke.py`` times the scan at other splits beside this one: a
    second wave of shorter blocks took more device time at 256 rows (66
    ranges 0.0267 ms, 132 ranges 0.0423 on an H100) and no less at 8192
    rows (2, 4 and 8 ranges 0.1043, 0.1061 and 0.1086 ms at N = 1024).
    Where ranges are narrower than a tile of ``BN`` codes, a block's warps
    whose codes lie past its range skip their tensor-core work.
    """
    return max(1, min(sms // _ceil_div(m, BM), n, _MAX_SPLITS))


def code_ranges(n: int, splits: int) -> list[tuple[int, int]]:
    """The scan's code ranges, [r n / S, (r + 1) n / S) for r < S, as the
    kernel computes them."""
    return [(r * n // splits, (r + 1) * n // splits) for r in range(splits)]


def scan_scratch(m: int, splits: int, device) -> torch.Tensor:
    """The scan's scratch, one byte buffer: a key per listed row (m int64),
    the partial best and second-best scores (2 x splits x m fp32), the
    partial indices (splits x m int32), the rescoring list (m int32), its
    count and the bits of max |c|^2 (2 int32)."""
    return torch.empty(8 * m + 4 * (3 * splits * m + m + 2), dtype=torch.uint8, device=device)


def scratch_pointers(scratch: torch.Tensor, m: int, splits: int) -> list[int]:
    """part_score, part_second, part_index, near_rows, near_count, near_keys:
    the scratch arguments of ``vqt_nearest_codes``, in its order."""
    keys = scratch.data_ptr()
    score = keys + 8 * m
    second = score + 4 * splits * m
    index = second + 4 * splits * m
    rows = index + 4 * splits * m
    return [score, second, index, rows, rows + 4 * m, keys]


def listed_rows(scratch: torch.Tensor, m: int, splits: int) -> int:
    """How many rows the last launch on ``scratch`` put on its rescoring
    list (waits for it)."""
    at = 8 * m + 4 * (3 * splits * m + m)
    return int(scratch[at:at + 4].view(torch.int32)[0])


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _on(device: torch.device, launch):
    """launch() with ``device`` current; a device guard costs host time that
    a small batch feels, so only when another device is current."""
    if torch.cuda.current_device() == device.index:
        return launch()
    with torch.cuda.device(device):
        return launch()


def nearest_codes_cuda(flat_x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(M, D) fp32, (N, D) fp32 contiguous CUDA tensors -> (M,) int32 codes.

    Launches on the current stream and does not synchronize. Raises on any
    input the kernel does not take and on a failed build or launch. Each
    launch adds one to ``vq.nearest_codes.launches``; an empty batch
    launches nothing.
    """
    m, n, _ = _check_inputs(flat_x, codebook)
    if m == 0:
        return torch.empty(0, dtype=torch.int32, device=flat_x.device)
    out, _ = _launch_scan(flat_x, codebook, scan_splits(m, n, _sms(flat_x.device.index)))
    vq.nearest_codes.launches += 1
    return out


def _launch_scan(flat_x: torch.Tensor, codebook: torch.Tensor, splits: int):
    """B1's launches (scan, merge, rescoring, pick) on checked, non-empty
    inputs with the codebook in ``splits`` ranges -> (codes, scratch);
    raises on a failed build or launch and counts nothing."""
    m, d = flat_x.shape
    n = codebook.shape[0]
    dev = flat_x.device
    out = torch.empty(m, dtype=torch.int32, device=dev)
    c2 = (codebook ** 2).sum(1)  # as nearest_codes_reference forms it
    scratch = scan_scratch(m, splits, dev)
    lib = library()
    code = _on(dev, lambda: lib.vqt_nearest_codes(
        flat_x.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
        *scratch_pointers(scratch, m, splits), out.data_ptr(), m, n, d, splits, _stream(dev)))
    _build.check_launch(lib, code, "nearest_codes")
    return out, scratch


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
    splits = scan_splits(m, n, _sms(dev.index))
    scratch = scan_scratch(m, splits, dev)
    lib = stats_library()
    code = _on(dev, lambda: lib.vqt_nearest_codes_stats(
        flat_x.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
        *scratch_pointers(scratch, m, splits), codes.data_ptr(), counts.data_ptr(),
        dw.data_ptr(), m, n, d, splits, _stream(dev)))
    _build.check_launch(lib, code, "nearest_codes_stats")
    vq.nearest_codes_stats.launches += 1
    return codes, counts, dw
