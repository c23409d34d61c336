"""Reference text feature-file format: ``feat:val feat:val ...\\tlabel [label...]``.

The port's own copy of :mod:`news_recsys_tpu.data.text_format` (numpy
only; ``tests/test_torch_shared.py`` holds its files and arrays to the
original's).

Interop layer with the reference's feature files
(``feature_extractor_base.py:199-204``, parsed by ``data_reader.py:59-113``):
array features are comma-joined ("1,2,3"). Used for golden-file parity tests
and for importing features produced by the reference pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..config import Config


def write_text_features(path, feats: Dict[str, np.ndarray], feature_names: Sequence[str]) -> None:
    n = len(next(iter(feats.values())))
    label = feats.get("label")
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            parts = []
            for name in feature_names:
                v = feats[name][i]
                if np.ndim(v) > 0:  # array feature -> comma-joined, no padding
                    mask_key = f"{name}_mask"
                    if mask_key in feats:
                        ln = int(feats[mask_key][i].sum())
                    else:
                        ln = len(v)
                    parts.append(f"{name}:{','.join(str(int(x)) for x in v[:ln])}")
                elif isinstance(v, (np.floating, float)) and not float(v).is_integer():
                    parts.append(f"{name}:{v}")
                else:
                    parts.append(f"{name}:{int(v)}")
            if label is not None:
                lab = label[i]
                lab_str = " ".join(
                    str(int(x)) if float(x).is_integer() else str(float(x))
                    for x in np.atleast_1d(lab)
                )
            else:
                lab_str = "-1"
            f.write(" ".join(parts) + "\t" + lab_str + "\n")


def read_text_features(path, cfg: Config) -> Dict[str, np.ndarray]:
    """Parse reference text format into packed arrays (pad+mask for arrays).

    Mirrors ``data_reader.py:73-113``: sparse -> int32, dense -> float32,
    array -> padded int32 (N, max_len) + float32 mask; multi-label float32.
    """
    sparse = set(cfg.features.sparse_feature_names)
    dense = set(cfg.features.dense_feature_names)
    array = set(cfg.features.array_feature_names)
    max_len = dict(cfg.features.array_max_length)

    cols: Dict[str, List] = {}
    labels: List[List[float]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            feature_part, label_part = line.split("\t")
            for item in feature_part.split(" "):
                name, val = item.split(":", 1)
                if name in array:
                    L = max_len[name]
                    ids = [int(x) for x in val.split(",")] if val else []
                    ln = min(len(ids), L)
                    ids = (ids + [0] * L)[:L]
                    cols.setdefault(name, []).append(ids)
                    cols.setdefault(f"{name}_mask", []).append([1.0] * ln + [0.0] * (L - ln))
                elif name in dense:
                    cols.setdefault(name, []).append(float(val))
                else:  # sparse (or unlisted -> sparse, like the reference skips; we accept ints)
                    cols.setdefault(name, []).append(int(val))
            labels.append([float(x) for x in label_part.split(" ")])

    out: Dict[str, np.ndarray] = {}
    for name, vals in cols.items():
        if name.endswith("_mask"):
            out[name] = np.asarray(vals, dtype=np.float32)
        elif name in dense:
            out[name] = np.asarray(vals, dtype=np.float32)
        elif name in array:
            out[name] = np.asarray(vals, dtype=np.int32)
        else:
            out[name] = np.asarray(vals, dtype=np.int32)
    out["label"] = np.asarray(labels, dtype=np.float32)
    return out
