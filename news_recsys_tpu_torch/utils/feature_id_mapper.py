"""Bidirectional raw-value <-> embedding-index lookup from saved vocab JSONs.

The port's own copy of :mod:`news_recsys_tpu.utils.feature_id_mapper`
(``tests/test_torch_shared.py`` holds it to the original).

Capability parity with ``src/model/model_utils/FeatureIdMapper.py:5-74``:
string-key tolerant (JSON keys are always strings), returns ``None`` for
unknown features/values. The val->idx JSON uses the reference structure
``{feature: [ {val: idx}, max_idx ]}``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from .logging import get_logger

logger = get_logger("feature_id_mapper")


class FeatureIdMapper:
    def __init__(self, idx2val_path: str, val2idx_path: str):
        self.idx2val_dict = self._load(idx2val_path)
        raw_v2i = self._load(val2idx_path)
        # reference stores [dict, max]; tolerate plain dicts as well
        self.val2idx_dict = {
            k: (v[0] if isinstance(v, list) else v) for k, v in raw_v2i.items()
        }
        logger.info(f"Loaded mappings for features: {list(self.idx2val_dict.keys())}")

    @staticmethod
    def _load(path: str) -> dict:
        if not os.path.exists(path):
            raise FileNotFoundError(f"Dictionary file not found: {path}")
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    @classmethod
    def from_dir(cls, extract_dir: str) -> "FeatureIdMapper":
        return cls(
            os.path.join(extract_dir, "embedding_idx_2_original_val_dict.json"),
            os.path.join(extract_dir, "original_val_2_embedding_idx_dict.json"),
        )

    def get_emb_idx(self, feature_name: str, real_value: Any) -> Optional[int]:
        fmap = self.val2idx_dict.get(feature_name)
        if fmap is None:
            logger.warning(f"Feature '{feature_name}' not found in mapping.")
            return None
        if real_value in fmap:
            return fmap[real_value]
        return fmap.get(str(real_value))

    def get_real_val(self, feature_name: str, emb_idx: int) -> Optional[Any]:
        fmap = self.idx2val_dict.get(feature_name)
        if fmap is None:
            logger.warning(f"Feature '{feature_name}' not found in mapping.")
            return None
        return fmap.get(str(emb_idx), fmap.get(emb_idx))
