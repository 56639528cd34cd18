"""Build the package's native sources at first use and load them through
ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (its launch functions
return ``cudaGetLastError()``, and it exports ``vqt_cuda_error_string``)
and is compiled on its own by nvcc into ``_build/lib<name>-<hash>.so``; the
hash covers the source, every shared header ``csrc/*.cuh`` and the nvcc
command, so an edited source or header is never served by a stale library.
The build happens on the machine with the card, the first time a kernel is
launched (a few seconds per file), and never at import; ``build`` starts
one compiler per missing library, all at once.

Each ``csrc/<name>.cpp`` is host code with a C interface (the LR schedulers,
the packed-record reader), built the same way by g++ with ``GXX_FLAGS`` and
the libraries in ``HOST_LIBS``, its hash over the source and that command.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# -Xptxas -v: the compiler's report of each kernel's registers, shared memory
# and spills, which ``build`` returns
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
# what a host source links, after the source on g++'s command line
HOST_LIBS = {"packio": ("-pthread", "-lz")}

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


def find_gxx() -> str:
    """g++ from $PATH; raises if it is missing."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(f"g++ not found: the host libraries of {CSRC_DIR} need it on PATH")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _is_cuda(name: str) -> bool:
    return source_path(name).suffix == ".cu"


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if _is_cuda(name) else GXX_FLAGS + HOST_LIBS.get(name, ())


def library_path(name: str) -> Path:
    """Where ``name``'s source builds to, named by a hash of the source, the
    shared headers (CUDA sources) and the flags."""
    digest = hashlib.sha256()
    src = source_path(name)
    for f in [src, *(sorted(CSRC_DIR.glob("*.cuh")) if _is_cuda(name) else [])]:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Build every library of ``names`` that is missing, one nvcc each, all
    started together; raises if any build fails. Returns nvcc's output of
    each library it built (ptxas's per-kernel report among it)."""
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        cuda = _is_cuda(name)
        compiler = find_nvcc() if cuda else find_gxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name and rename: concurrent first uses in
        # several processes never load a half-written library
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        src = str(source_path(name))
        if cuda:
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), src]
        else:
            cmd = [compiler, *GXX_FLAGS, "-o", str(tmp), src, *HOST_LIBS.get(name, ())]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, so, tmp, cmd, proc))
    failures = []
    reports = {}
    for name, so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{Path(cmd[0]).name} failed to build {source_path(name).name} "
                            f"(exit {proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
            reports[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """Build ``name``'s source if its library is missing, load it once."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    if _is_cuda(name):
        lib.vqt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vqt_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.vqt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")


def bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Set each function's (restype, argtypes) from ``signatures``."""
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def load_host_library(name: str, signatures: dict) -> Optional[ctypes.CDLL]:
    """``load_library`` of a host source with its functions bound, or None
    where g++ is missing: the callers keep a Python twin of the same
    semantics. A source that g++ fails to build, or a library that fails to
    load, raises."""
    if shutil.which("g++") is None:
        return None
    return bind(load_library(name), signatures)
