"""Reference text feature-file format: ``feat:val feat:val ...\\tlabel [label...]``.

The port's own copy of the writer of :mod:`news_recsys_tpu.data.text_format`
(numpy only; ``tests/test_torch_shared.py`` holds its files to the
original's). Left out: ``read_text_features``, which the port does not use.

Interop layer with the reference's feature files
(``feature_extractor_base.py:199-204``, parsed by ``data_reader.py:59-113``):
array features are comma-joined ("1,2,3"). Used for golden-file parity tests
and for importing features produced by the reference pipeline.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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
