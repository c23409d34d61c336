"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library, ``libnrt_kernels.so``, with a plain C interface
that is bound through ``ctypes``. The build runs at first use, from the
package's own sources, into ``news_recsys_tpu_torch/build/<digest>/``: the
digest covers the sources, their headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and
a stale library is never loaded. Building needs no PyTorch headers, which
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every one returns a cudaError_t as int
SIGNATURES = {
    # x0, ws, bs, out, ss, B, D, NL, vector, group, slots, warps, blocks, stream
    "nrt_dcn_cross_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x0, ws, bs, ss, g, dx0, dws, dbs, partial, B, D, NL, vector, group, slots, warps,
    # blocks, stream
    "nrt_dcn_cross_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # table, ids, mask, out, B, L, D, V, stream
    "nrt_lookup_pool_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # table, rows, vals, S, D, V, stream
    "nrt_scatter_rows_set": [_P, _P, _P, _I, _I, _I, _P],
    # v, out, B, F, D, stream
    "nrt_fm_fwd": [_P, _P, _I, _I, _I, _P],
    # v, g, dv, B, F, D, stream
    "nrt_fm_bwd": [_P, _P, _P, _I, _I, _I, _P],
    # ids, mask, g, grad_table, state, coef, acc, flags, B, L, D, V, P, stream
    "nrt_lookup_pool_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, mask, params (12 pointers), out, ws, B, L, D, F, H, nblk, stream
    "nrt_fused_block_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, mask, dy, params, dx, dflat, wt, partial, ws, B, L, D, F, H, nblk, stream
    "nrt_fused_block_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, mask, params, out, B, L, nblk, stream
    "nrt_fused_block_tiled_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, mask, dy, params, dx, dflat, partial, B, L, nblk, stream
    "nrt_fused_block_tiled_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # qkv, mask, out, N, L, H, hd, heads a block, warps a head, 1 / sqrt(hd), stream
    "nrt_mhsa_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # qkv, mask, dout, dqkv, N, L, H, hd, heads a block, warps a head, 1 / sqrt(hd), stream
    "nrt_mhsa_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # stream: one empty kernel, the floor of a launch
    "nrt_empty": [_P],
}
# C entry point -> argument types; these launch nothing and return a size (floats or bytes)
SIZE_FUNCTIONS = {
    # L, D, F, backward
    "nrt_fused_block_ws_floats": [_I, _I, _I, _I],
    # D, F
    "nrt_fused_block_param_floats": [_I, _I],
    # the tiled route's dynamic shared memory a block, in bytes
    "nrt_fused_block_tiled_fwd_smem_bytes": [],
    "nrt_fused_block_tiled_bwd_smem_bytes": [],
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


def compile_command(nvcc: str, src: Path, obj: Path) -> list:
    return [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]


def nvcc_command(nvcc: str, output: Path, objects) -> list:
    """The link of the compiled ``objects`` into the shared library."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(output), *map(str, objects)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in (*sources(), *sorted(CSRC_DIR.glob("*.cuh"))):     # headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources into the library unless this digest is built;
    returns its path.

    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside it in ``build.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag, srcs = nvcc_path(), f"{os.getpid()}.tmp", sources()
    objects = [lib.parent / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen(compile_command(nvcc, src, obj), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objects)]
    logs = [p.communicate()[0] for p in procs]      # waits for every nvcc
    failed = [(src.name, p.returncode, log) for src, p, log in zip(srcs, procs, logs)
              if p.returncode != 0]
    tmp = lib.with_name(f"{LIB_NAME}.{tag}")
    link = None if failed else subprocess.run(nvcc_command(nvcc, tmp, objects),
                                              capture_output=True, text=True)
    (lib.parent / "build.log").write_text("".join(logs) + (link.stdout + link.stderr
                                                           if link else ""))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        name, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{log[-4000:]}")
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call in the process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for functions, restype in ((SIGNATURES, ctypes.c_int),
                                       (SIZE_FUNCTIONS, ctypes.c_longlong)):
                for name, argtypes in functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
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
