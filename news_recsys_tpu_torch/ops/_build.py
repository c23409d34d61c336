"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library, ``libnrt_kernels.so``, with a plain C interface that is
bound through ``ctypes``. The build runs at first use, from the package's
own sources, into ``news_recsys_tpu_torch/build/<digest>/``: the digest
covers the sources and the flags, so an edited kernel is rebuilt and a
stale library is never loaded. Building needs no PyTorch headers, which
keeps it to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIB_NAME = "libnrt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types; every one returns a cudaError_t as int
SIGNATURES = {
    # x0, ws, bs, out, xs, ss, B, D, NL, stream
    "nrt_dcn_cross_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # table, ids, mask, out, B, L, D, V, stream
    "nrt_lookup_pool_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_library = None


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` as PyTorch resolves CUDA_HOME, else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def nvcc_command(nvcc: str, output: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), *map(str, sources())]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this digest is built; returns its path.

    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside it in ``build.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(nvcc_path(), tmp), capture_output=True, text=True)
    (lib.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call in the process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nrt_error_string.argtypes = [ctypes.c_int]
            lib.nrt_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if the launch reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.nrt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {rc} ({msg})")
