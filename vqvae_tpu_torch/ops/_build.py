"""Build the package's CUDA sources with nvcc at first use and load them
through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (its launch functions
return ``cudaGetLastError()``, and it exports ``vqt_cuda_error_string``)
and is compiled on its own into ``_build/lib<name>-<hash>.so``; the hash
covers the source, every shared header ``csrc/*.cuh`` and the nvcc command,
so an edited source or header is never served by a stale library. The build
happens on the machine with the card, the first time a kernel is launched
(a few seconds per file), and never at import; ``build`` starts one nvcc per
missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# -Xptxas -v: the compiler's report of each kernel's registers, shared memory
# and spills, which ``build`` returns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else from $PATH; raises if neither has it."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of vqvae_tpu_torch are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit. Set CUDA_HOME "
        "to the toolkit's root or put nvcc on PATH.")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by a hash of the source, the
    shared headers and the flags."""
    digest = hashlib.sha256()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Build every library of ``names`` that is missing, one nvcc each, all
    started together; raises if any build fails. Returns nvcc's output of
    each library it built (ptxas's per-kernel report among it)."""
    jobs = []
    nvcc = None
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name and rename: concurrent first uses in
        # several processes never load a half-written library
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, so, tmp, cmd, proc))
    failures = []
    reports = {}
    for name, so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
            reports[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, load it once."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.vqt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vqt_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.vqt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
