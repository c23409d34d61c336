"""Canonical MIND-small model configs, built in code (no YAML needed).

``mind_config`` and the MIND table sizes are the JAX package's own
(:mod:`news_recsys_tpu.zoo`); ``mind_dssm_config`` is ``configs/dssm.yaml``,
the retrieval stage of the serving cascade.
"""

from __future__ import annotations

from news_recsys_tpu.config import Config, config_from_dict
from news_recsys_tpu.zoo import MIND_FEATURES, MIND_TABLE_SIZE, mind_config

__all__ = ["DSSM_HIST_LEN", "MIND_FEATURES", "MIND_TABLE_SIZE", "mind_config",
           "mind_dssm_config"]

DSSM_HIST_LEN = 30


def mind_dssm_config() -> Config:
    """The DSSM two-tower retrieval config of ``configs/dssm.yaml``: 16-wide
    tables, the click history ``hist`` mean-pooled over the item table."""
    return config_from_dict({
        "name": "dssm",
        "paths": {"data_path": "Data/MIND", "out_basedir": "tmp"},
        "features": {
            "feature_names": MIND_FEATURES + ["hist"],
            "sparse_feature_names": MIND_FEATURES,
            "dense_feature_names": [],
            "array_feature_names": ["hist"],
            "item_feature_names": ["item_id", "category", "subcategory"],
            "user_feature_names": ["user_id", "user_click_category", "hist"],
            "array_max_length": {"hist": DSSM_HIST_LEN},
        },
        "embeddings": {
            "embedding_size": {k: 16 for k in MIND_FEATURES},
            "embedding_table_size": dict(MIND_TABLE_SIZE),
            "share_emb_table_features": {"hist": "item_id"},
            "arena_tables": True,
        },
        "dataset": {"batch_size": 512, "num_workers": 0, "pin_memory": False},
        "train_hparams": {"val_freq": 1, "max_epoch": 30, "lr": 1e-3, "min_lr": 5e-6,
                          "lr_milestones": [40000, 200000], "max_step": 300000,
                          "seed": 42},
        "mesh": {"data": -1, "model": 1},
        "dssm_cfg": {"negative_sample_rate": 8, "temperature": 0.1,
                     "hist_augment": True, "logq_correction": True},
    })
