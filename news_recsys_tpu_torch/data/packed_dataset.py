"""Packed dataset + fixed-shape batch iterator.

The port's own copy of :mod:`news_recsys_tpu.data.packed_dataset` (numpy
only; ``tests/test_torch_shared.py`` holds it to the original): all
features live as packed int32/float32 host arrays; batching is pure slicing
of a shuffled permutation; every batch has an identical static shape, with
the final partial batch padded and masked via ``_valid`` weights. The
reference text format loads through ``from_text`` (the port's C++ parser,
:mod:`news_recsys_tpu_torch.native`, or :func:`..text_format.
read_text_features`). Left out: ``encode_dataset``, which the port does not
use.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from ..config import Config
from ..native import parse_text_features_native
from ..utils.logging import get_logger
from .text_format import read_text_features

logger = get_logger("packed_dataset")

Batch = Dict[str, np.ndarray]


class PackedDataset:
    """Dict of equally-sized leading-dim arrays (features + 'label')."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        if not arrays:
            raise ValueError("Empty dataset")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"Inconsistent array lengths: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self.n

    @classmethod
    def load(cls, path: str) -> "PackedDataset":
        with np.load(path) as z:
            arrays = {}
            for k in z.files:
                v = z[k]
                # masks are stored uint8 at rest (feature_extraction._save_npz)
                if k.endswith("_mask") and v.dtype != np.float32:
                    v = v.astype(np.float32)
                arrays[k] = v
            return cls(arrays)

    @staticmethod
    def _sniff_n_labels(path: str) -> int:
        """Label column width from the first non-empty line (the reference
        DataReader infers multi-labels by splitting on spaces,
        ``data_reader.py:111-113``)."""
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line and "\t" in line:
                    return len(line.split("\t")[1].split(" "))
        return 1

    @classmethod
    def from_text(cls, path: str, cfg: Config, native: bool = True) -> "PackedDataset":
        """Parse the reference text format: with the C++ one-pass parser
        (``native``; a failed build raises), else in Python. Multi-value
        labels yield an (N, k) float32 'label' array."""
        if native:
            return cls(parse_text_features_native(path, cfg, n_labels=cls._sniff_n_labels(path)))
        return cls(read_text_features(path, cfg))

    @classmethod
    def open_split(cls, cfg: Config, split: str) -> "PackedDataset":
        """Load ``<out_basedir>/extractored_feature/<split>_features.npz``
        (falling back to the reference ``.txt`` format if present)."""
        base = os.path.join(cfg.paths.out_basedir, "extractored_feature")
        npz = os.path.join(base, f"{split}_features.npz")
        if os.path.exists(npz):
            return cls.load(npz)
        txt = os.path.join(base, f"{split}_features.txt")
        if os.path.exists(txt):
            logger.info(f"Loading reference text format: {txt}")
            return cls.from_text(txt, cfg)
        raise FileNotFoundError(f"No feature file for split '{split}' under {base}")

    def take(self, idx: np.ndarray) -> Batch:
        return {k: v[idx] for k, v in self.arrays.items()}


def iterate_batches(
    ds: PackedDataset,
    batch_size: int,
    shuffle: bool,
    seed: int = 0,
    epoch: int = 0,
    drop_last: Optional[bool] = None,
) -> Iterator[Batch]:
    """Fixed-shape batches. Train (shuffle=True): drop_last. Eval: pad+mask.

    Every batch carries ``_valid`` float32 (B,) — 1 for real rows, 0 for
    padding — so losses/metrics can mask exactly.
    """
    n = len(ds)
    if drop_last is None:
        drop_last = shuffle
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        order = rng.permutation(n)
    else:
        order = np.arange(n)

    if drop_last:
        n_batches = n // batch_size
        for b in range(n_batches):
            idx = order[b * batch_size : (b + 1) * batch_size]
            batch = ds.take(idx)
            batch["_valid"] = np.ones(batch_size, dtype=np.float32)
            yield batch
    else:
        n_batches = (n + batch_size - 1) // batch_size
        for b in range(n_batches):
            idx = order[b * batch_size : (b + 1) * batch_size]
            valid = len(idx)
            if valid < batch_size:
                idx = np.concatenate([idx, np.full(batch_size - valid, idx[-1] if valid else 0)])
            batch = ds.take(idx)
            batch["_valid"] = (np.arange(batch_size) < valid).astype(np.float32)
            yield batch


def num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else (n + batch_size - 1) // batch_size


# ---------------------------------------------------------------------------
# Matrix-packed fast path
# ---------------------------------------------------------------------------


class BatchPacker:
    """Pack all features into one int32 + one float32 matrix for cheap batching.

    A batch is two row-gathers of contiguous matrices, instead of one
    gather per feature, and the dict of per-feature views is re-assembled
    on the device by :func:`unpack_batch` (pure slicing).

    Column layout (static): int features first-come (sparse width 1, array
    width L), float features likewise (dense 1, masks L, label k, _valid 1).
    """

    def __init__(self, ds: PackedDataset):
        self.n = len(ds)
        int_cols, float_cols = [], []
        self.int_layout = []    # (name, start, width, reshape_L or 0)
        self.float_layout = []
        io = fo = 0
        for name in sorted(ds.arrays):
            arr = ds.arrays[name]
            width = 1 if arr.ndim == 1 else int(np.prod(arr.shape[1:]))
            flat = arr.reshape(self.n, width)
            if np.issubdtype(arr.dtype, np.integer):
                int_cols.append(flat.astype(np.int32))
                self.int_layout.append((name, io, width, arr.shape[1] if arr.ndim > 1 else 0))
                io += width
            else:
                float_cols.append(flat.astype(np.float32))
                self.float_layout.append((name, fo, width, arr.shape[1] if arr.ndim > 1 else 0))
                fo += width
        self.int_mat = (np.ascontiguousarray(np.concatenate(int_cols, axis=1))
                        if int_cols else np.zeros((self.n, 0), np.int32))
        self.float_mat = (np.ascontiguousarray(np.concatenate(float_cols, axis=1))
                          if float_cols else np.zeros((self.n, 0), np.float32))

    def layout_key(self):
        """Hashable layout."""
        return (tuple(self.int_layout), tuple(self.float_layout))

    def iterate(self, batch_size: int, shuffle: bool, seed: int = 0, epoch: int = 0,
                drop_last: Optional[bool] = None):
        """Yield (int_mat, float_mat, valid) fixed-shape host batches."""
        n = self.n
        if drop_last is None:
            drop_last = shuffle
        if shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        nb = num_batches(n, batch_size, drop_last)
        ones = np.ones(batch_size, dtype=np.float32)
        for b in range(nb):
            idx = order[b * batch_size : (b + 1) * batch_size]
            valid = len(idx)
            if valid < batch_size:
                idx = np.concatenate([idx, np.full(batch_size - valid, idx[-1] if valid else 0)])
            vmask = ones if valid == batch_size else (np.arange(batch_size) < valid).astype(np.float32)
            yield self.int_mat[idx], self.float_mat[idx], vmask


def unpack_batch(int_mat, float_mat, valid, layout_key) -> Batch:
    """Device-side reconstruction of the feature dict (numpy arrays or tensors)."""
    int_layout, float_layout = layout_key
    batch: Batch = {}
    B = int_mat.shape[0] if int_mat.ndim else 0
    for name, start, width, L in int_layout:
        col = int_mat[:, start : start + width]
        batch[name] = col.reshape(col.shape[0], L) if L else col[:, 0]
    for name, start, width, L in float_layout:
        col = float_mat[:, start : start + width]
        batch[name] = col.reshape(col.shape[0], L) if L else col[:, 0]
    if "label" in batch and getattr(batch["label"], "ndim", 1) == 1:
        batch["label"] = batch["label"][:, None]
    batch["_valid"] = valid
    return batch
