"""Canonical MIND-small model configs, built in code (no YAML needed).

``mind_config`` and the MIND table sizes are the JAX package's own
(:mod:`news_recsys_tpu.zoo`); ``mind_dssm_config`` is ``configs/dssm.yaml``,
the retrieval stage of the serving cascade; ``mind_ranker_config`` is a
ranker of the zoo as the scoreboard trains it.
"""

from __future__ import annotations

from news_recsys_tpu.config import Config, config_from_dict, config_to_dict
from news_recsys_tpu.zoo import MIND_FEATURES, MIND_TABLE_SIZE, mind_config

__all__ = ["DSSM_HIST_LEN", "MIND_FEATURES", "MIND_TABLE_SIZE", "RANKER_RECIPES",
           "mind_config", "mind_dssm_config", "mind_ranker_config"]

# the scoreboard's rankers; "dcn@v2" is DCN with dcn_cfg.version 2, named as
# scripts/fullscale_rankers.py names it
RANKER_RECIPES = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "dcn@v2")
# the shallow models score straight from raw embeddings and start sigmoid-
# saturated from N(0, 1) (artifacts/fm_diagnosis_r05.json)
SHALLOW_INIT_SCALE = 0.03

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


def mind_ranker_config(name: str) -> Config:
    """A ranker of the zoo as ``scripts/fullscale_rankers.py`` trains it for
    the scoreboard (``artifacts/rankers_fullscale_r05.json``) from the
    model's own ``configs/<model>.yaml``: ``rowwise_adagrad`` on the large
    tables, arena tables, batch 512; dims 1 for LR, 16 for FM and DeepFM,
    32/32/16/16/16 otherwise, with ``category`` and ``subcategory`` at 17
    (column 0 wide) for Wide&Deep; ``init_scale`` 0.03 for LR, FM and
    DeepFM; 3 cross layers for DCN (``dcn@v2``: version 2)."""
    if name not in RANKER_RECIPES:
        raise ValueError(f"no scoreboard recipe for {name!r}; known: {RANKER_RECIPES}")
    model = name.split("@")[0]
    raw = config_to_dict(mind_config(model, embedding_optimizer="rowwise_adagrad"))
    raw["paths"].update(data_path="Data/MIND", out_basedir="tmp")
    emb = raw["embeddings"]
    dims = {"lr": 1, "fm": 16, "deepfm": 16}.get(model)
    if dims is not None:
        emb["embedding_size"] = {k: dims for k in MIND_FEATURES}
        emb["init_scale"] = SHALLOW_INIT_SCALE
    if model == "widedeep":
        emb["embedding_size"].update(category=17, subcategory=17)
    else:
        raw.pop("wide_and_deep_cfg")
    if model == "dcn":
        raw["dcn_cfg"] = {"num_layers": 3, "version": 2 if name == "dcn@v2" else 1}
    return config_from_dict(raw)
