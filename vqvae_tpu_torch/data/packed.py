"""Packed-record dataset, the FFCV ``.beton`` equivalent (counterpart of
``vqvae_tpu/data/packed.py``, same file format, so a file either package
writes, the other reads).

Writer in Python; reader through ``csrc/packio.cpp`` (mmap, a thread pool
per batch; built by g++ at first use, ``ops/_build.py``), with a pure-Python
mmap reader of the same semantics where g++ is missing (``is_native`` tells
which). Records are fixed-size HWC uint8 images (optionally zlib-compressed),
already resized to the training resolution, so decoding is a memcpy (raw) or
an inflate (zlib), with no PIL on the hot path. The write CLI is
``python -m vqvae_tpu_torch.cli.create_packed_dataset``.

Format (``csrc/packio.cpp``): a 64-byte header (magic 'VQPK', version 1,
count, h, w, c, mode 0 raw / 1 zlib), ``count`` index entries
(offset u64, length u64), then the records.
"""

from __future__ import annotations

import ctypes
import mmap
import shutil
import struct
import tempfile
import zlib
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from vqvae_tpu_torch.ops import _build

MAGIC = 0x4B505156  # 'VQPK'
HEADER_FMT = "<IIQIIII32x"
HEADER_SIZE = 64
INDEX_FMT = "<QQ"

_u32p = ctypes.POINTER(ctypes.c_uint32)
# the C interface of csrc/packio.cpp that this module binds:
# name -> (restype, argtypes)
SIGNATURES = {
    "packio_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "packio_info": (None, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                           _u32p, _u32p, _u32p, _u32p]),
    "packio_read_batch": (ctypes.c_int, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                                         ctypes.c_int]),
    "packio_close": (None, [ctypes.c_void_p]),
}


def _library() -> Optional[ctypes.CDLL]:
    return _build.load_host_library("packio", SIGNATURES)


def write_packed(path: str, images: Iterable[np.ndarray], image_size: int, channels: int = 3,
                 compress: bool = False) -> int:
    """Write HWC uint8 images (already resized) into a .pack file; returns
    the record count. The payloads stream to a temporary sidecar file and
    only the 16-byte index entries stay in memory, so a dataset of any size
    packs in constant memory."""
    lengths = []
    tmp = tempfile.NamedTemporaryFile(dir=str(Path(path).parent), prefix=Path(path).name + ".",
                                      suffix=".tmp", delete=False)
    try:
        with tmp:
            for img in images:
                img = np.ascontiguousarray(img, np.uint8)
                assert img.shape == (image_size, image_size, channels), img.shape
                raw = img.tobytes()
                rec = zlib.compress(raw, 6) if compress else raw
                tmp.write(rec)
                lengths.append(len(rec))
        count = len(lengths)
        header = struct.pack(HEADER_FMT, MAGIC, 1, count, image_size, image_size, channels,
                             1 if compress else 0)
        offset = HEADER_SIZE + count * struct.calcsize(INDEX_FMT)
        with open(path, "wb") as f:
            f.write(header)
            for length in lengths:
                f.write(struct.pack(INDEX_FMT, offset, length))
                offset += length
            with open(tmp.name, "rb") as data:
                shutil.copyfileobj(data, f, length=16 * 1024 * 1024)
    finally:
        Path(tmp.name).unlink(missing_ok=True)
    return count


class PackedDataset:
    """Random-access packed dataset, indexable like ``ImageFolderDataset``,
    with a vectorized ``read_batch``."""

    def __init__(self, path: str, image_size: Optional[int] = None, num_threads: int = 4):
        self.path = str(path)
        if not Path(self.path).exists():
            raise FileNotFoundError(f"dataset path not found: {path}")
        self.num_threads = num_threads
        self._handle = None
        self._mm = None
        self._lib = lib = _library()
        if lib is not None:
            self._handle = lib.packio_open(self.path.encode())
        if self._handle:
            count = ctypes.c_uint64()
            h, w, c, mode = (ctypes.c_uint32() for _ in range(4))
            lib.packio_info(self._handle, count, h, w, c, mode)
            self.count, self.h, self.w, self.c, self.mode = (
                count.value, h.value, w.value, c.value, mode.value)
        else:
            self._open_python()
        if image_size is not None and image_size != self.h:
            raise ValueError(f"packed file resolution {self.h} != requested {image_size}; "
                             "re-pack with create_packed_dataset --max_resolution")

    def _open_python(self):
        with open(self.path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, count, h, w, c, mode = struct.unpack_from(HEADER_FMT, self._mm, 0)
        if magic != MAGIC or version != 1:
            raise ValueError(f"not a packed file (version 1): {self.path}")
        self.count, self.h, self.w, self.c, self.mode = count, h, w, c, mode
        entry = struct.calcsize(INDEX_FMT)
        self._index = [struct.unpack_from(INDEX_FMT, self._mm, HEADER_SIZE + i * entry)
                       for i in range(count)]

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.read_batch(np.array([idx], np.int64))[0]

    def read_batch(self, indices: np.ndarray) -> np.ndarray:
        """(n,) int64 record indices -> (n, H, W, C) uint8."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        out = np.empty((n, self.h, self.w, self.c), np.uint8)
        if self._handle:
            err = self._lib.packio_read_batch(
                self._handle, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self.num_threads)
            if err != 0:
                raise IOError(f"packio_read_batch failed: code {err}")
            return out
        for i, idx in enumerate(indices):
            off, length = self._index[int(idx)]
            buf = self._mm[off:off + length]
            if self.mode == 1:
                buf = zlib.decompress(buf)
            out[i] = np.frombuffer(buf, np.uint8).reshape(self.h, self.w, self.c)
        return out

    def close(self):
        if self._handle:
            self._lib.packio_close(self._handle)
            self._handle = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    @property
    def is_native(self) -> bool:
        return bool(self._handle)
