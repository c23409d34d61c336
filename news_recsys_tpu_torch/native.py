"""ctypes bindings for the port's two host C++ libraries, built at first use.

Port of :mod:`news_recsys_tpu.native`, from the port's own copies of the
sources (``news_recsys_tpu_torch/native/*.cpp``, byte-equal to the JAX
package's ``native/*.cpp``; ``tests/test_torch_shared.py`` holds them so):

- ``ann_topk``: exact inner-product top-k on the host, the serving backend
  for a corpus searched on the CPU (:class:`HostTopKSearcher`; the device
  backend is :class:`~news_recsys_tpu_torch.ops.topk.TopKSearcher`);
- ``text_parser``: a one-pass parser of the reference text feature format
  (:func:`parse_text_features_native`).

Each compiles with the system ``g++`` into ``news_recsys_tpu_torch/build/``
under a digest of its source. Where the JAX package returns None and falls
back to Python (no compiler), a failed build raises here: a caller that
wants the Python path asks for it (``PackedDataset.from_text(native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .utils.logging import get_logger

logger = get_logger("native")

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PACKAGE_DIR, "native")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _build_and_load(name: str) -> ctypes.CDLL:
    """``lib<name>_<digest>.so`` built from ``native/<name>.cpp`` (once) and
    loaded; raises ``RuntimeError`` with the compiler's output if the build
    fails."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(SRC_DIR, f"{name}.cpp")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(so_path):
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, src,
                   "-lpthread"]
            logger.info(f"Building native lib: {' '.join(cmd)}")
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or ""
                raise RuntimeError(f"building {src} failed: {e}\n{detail}") from e
            os.replace(tmp, so_path)
        _libs[name] = ctypes.CDLL(so_path)
        return _libs[name]


def load_ann() -> ctypes.CDLL:
    lib = _build_and_load("ann_topk")
    lib.ann_topk_ip.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.ann_topk_ip.restype = None
    lib.ann_l2_normalize.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                     ctypes.c_int64]
    lib.ann_l2_normalize.restype = None
    return lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HostTopKSearcher:
    """Exact inner-product top-k on the host over a corpus snapshot, with
    :class:`~news_recsys_tpu_torch.ops.topk.TopKSearcher`'s interface (numpy
    in and out). Ties go to the lower index; ``k`` above the corpus pads
    with index -1 and score -inf."""

    device = torch.device("cpu")        # where ``search_tensors`` returns its results

    def __init__(self, normalize: bool = False, n_threads: int = 0):
        self.normalize = normalize
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.corpus = None
        self._lib = load_ann()

    def update_embedding(self, embeddings) -> None:
        corpus = np.array(embeddings, dtype=np.float32, order="C")     # a copy we own
        if corpus.ndim != 2:
            raise ValueError(f"the corpus must be (n, d), got shape {corpus.shape}")
        if self.normalize:
            self._lib.ann_l2_normalize(_float_ptr(corpus), corpus.shape[0], corpus.shape[1])
        self.corpus = corpus

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.corpus is None:
            raise RuntimeError("update_embedding must be called before search")
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        n, d = self.corpus.shape
        if q.ndim != 2 or q.shape[1] != d:
            raise ValueError(f"queries of shape {q.shape} for a corpus of width {d}")
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if self.normalize:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = np.ascontiguousarray(q / np.maximum(norms, 1e-12))
        idx = np.empty((q.shape[0], k), dtype=np.int32)
        scores = np.empty((q.shape[0], k), dtype=np.float32)
        self._lib.ann_topk_ip(_float_ptr(self.corpus), n, d, _float_ptr(q), q.shape[0], k,
                              idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                              _float_ptr(scores), self.n_threads)
        return idx, scores

    def search_tensors(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` of a tensor of queries on any device, as CPU tensors
        over the result's arrays (no copy)."""
        idx, scores = self.search(queries.cpu().numpy(), k)
        return torch.from_numpy(idx), torch.from_numpy(scores)


def load_text_parser() -> ctypes.CDLL:
    lib = _build_and_load("text_parser")
    lib.tp_count_rows.argtypes = [ctypes.c_char_p]
    lib.tp_count_rows.restype = ctypes.c_int64
    lib.tp_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.tp_parse.restype = ctypes.c_int64
    return lib


def parse_text_features_native(path: str, cfg, n_labels: int = 1) -> Dict[str, np.ndarray]:
    """The reference text format parsed in C++ into packed arrays: sparse
    features int32, dense float32, array features padded int32 (N, L) with a
    float32 ``<name>_mask``, ``label`` (N, ``n_labels``) float32. The
    features are the config's (sparse, dense, array names), as the reference
    DataReader reads them."""
    lib = load_text_parser()
    n = lib.tp_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)

    f = cfg.features
    specs = ([(name, 0, 0) for name in f.sparse_feature_names]
             + [(name, 1, 0) for name in f.dense_feature_names]
             + [(name, 2, int(f.array_max_length[name])) for name in f.array_feature_names])
    names = [name for name, _, _ in specs]
    kinds = [kind for _, kind, _ in specs]
    max_lens = [L for _, _, L in specs]

    int_bufs, float_bufs = [], []
    out: Dict[str, np.ndarray] = {}
    null_i = ctypes.POINTER(ctypes.c_int32)()
    null_f = ctypes.POINTER(ctypes.c_float)()
    for name, kind, L in zip(names, kinds, max_lens):
        if kind == 0:
            out[name] = np.zeros(n, dtype=np.int32)
            int_bufs.append(out[name].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            float_bufs.append(null_f)
        elif kind == 1:
            out[name] = np.zeros(n, dtype=np.float32)
            int_bufs.append(null_i)
            float_bufs.append(_float_ptr(out[name]))
        else:
            out[name] = np.zeros((n, L), dtype=np.int32)
            out[f"{name}_mask"] = np.zeros((n, L), dtype=np.float32)
            int_bufs.append(out[name].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            float_bufs.append(_float_ptr(out[f"{name}_mask"]))

    labels = np.zeros((n, n_labels), dtype=np.float32)
    nf = len(names)
    rows = lib.tp_parse(
        path.encode(), "\n".join(names).encode(),
        (ctypes.c_int32 * nf)(*kinds), (ctypes.c_int32 * nf)(*max_lens), nf,
        (ctypes.POINTER(ctypes.c_int32) * nf)(*int_bufs),
        (ctypes.POINTER(ctypes.c_float) * nf)(*float_bufs),
        _float_ptr(labels), n_labels)
    if rows < 0:
        raise ValueError(f"Native parse failed with code {rows} for {path}")
    out["label"] = labels
    if rows != n:
        out = {k: v[:rows] for k, v in out.items()}
    return out
