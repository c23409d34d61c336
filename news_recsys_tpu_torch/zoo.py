"""Canonical MIND-small model configs, built in code (no YAML needed), and
the attention ranker's synthetic rows.

``mind_config``, ``attention_config``, ``attention_arrays`` and the MIND
table sizes are the port's own copies of the JAX package's
(:mod:`news_recsys_tpu.zoo`; ``tests/test_torch_shared.py`` holds them to
the originals); ``mind_dssm_config`` is ``configs/dssm.yaml``, the retrieval
stage of the serving cascade; ``mind_ranker_config`` is a ranker of the zoo
as the scoreboard trains it; ``mind_nrms_config`` is NRMS at its published
widths (the JAX package has no NRMS).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import Config, config_from_dict, config_to_dict

__all__ = ["ATTENTION_HIST_LEN", "DSSM_HIST_LEN", "MIND_FEATURES", "MIND_TABLE_SIZE",
           "RANKER_RECIPES", "attention_arrays", "attention_config", "mind_config",
           "mind_dssm_config", "mind_nrms_config", "mind_ranker_config"]

MIND_FEATURES = ["user_id", "item_id", "category", "subcategory", "user_click_category"]
MIND_EMB_SIZE = {"user_id": 32, "item_id": 32, "category": 16,
                 "subcategory": 16, "user_click_category": 16}
MIND_TABLE_SIZE = {"user_id": 94058, "item_id": 65239, "category": 18,
                   "subcategory": 270, "user_click_category": 18}

# the scoreboard's rankers, named as scripts/fullscale_rankers.py names them:
# "dcn@v2" is DCN with dcn_cfg.version 2, "attention@adamw" the attention
# ranker with the optimizer configs/attention.yaml ships (all-dense AdamW)
RANKER_RECIPES = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "dcn@v2", "attention",
                  "attention@adamw")
# the shallow models score straight from raw embeddings and start sigmoid-
# saturated from N(0, 1) (artifacts/fm_diagnosis_r05.json)
SHALLOW_INIT_SCALE = 0.03

ATTENTION_HIST_LEN = 30  # configs/attention.yaml array_max_length
ENTITIES_LEN, ENTITIES_TABLE_SIZE, ENTITIES_DIM = 5, 30000, 16


def mind_config(name: str = "dcn", batch_size: int = 512, equal_dims: bool = False,
                mesh_data: int = -1, mesh_model: int = 1,
                param_dtype: str = "float32", compute_dtype: str = "float32",
                embedding_optimizer: str = "adamw",
                embedding_update_period: int = 1,
                arena_tables: bool = True) -> Config:
    emb = {k: 16 for k in MIND_FEATURES} if equal_dims else dict(MIND_EMB_SIZE)
    return config_from_dict({
        "name": name,
        "features": {
            "feature_names": MIND_FEATURES,
            "sparse_feature_names": MIND_FEATURES,
            "item_feature_names": ["item_id", "category", "subcategory"],
            "user_feature_names": ["user_id", "user_click_category"],
        },
        "embeddings": {
            "embedding_size": emb,
            "embedding_table_size": dict(MIND_TABLE_SIZE),
            "arena_tables": arena_tables,
        },
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"val_freq": 1, "max_epoch": 30, "lr": 1e-3, "min_lr": 5e-6,
                          "lr_milestones": [40000, 200000], "max_step": 300000,
                          "embedding_optimizer": embedding_optimizer,
                          "embedding_update_period": embedding_update_period},
        "mesh": {"data": mesh_data, "model": mesh_model,
                 "param_dtype": param_dtype, "compute_dtype": compute_dtype},
        "wide_and_deep_cfg": {"wide_feature_names": ["category", "subcategory"]},
    })


def attention_config(batch_size: int = 512, hist_len: int = ATTENTION_HIST_LEN,
                     embedding_optimizer: str = "rowwise_adagrad") -> Config:
    """The attention sequence ranker's bench config: user history as an
    unpooled array feature sharing the item table."""
    return config_from_dict({
        "name": "attention",
        "features": {
            "feature_names": ["user_id", "item_id", "category", "hist"],
            "sparse_feature_names": ["user_id", "item_id", "category"],
            "array_feature_names": ["hist"],
            "item_feature_names": ["item_id", "category"],
            "user_feature_names": ["user_id", "hist"],
            "array_max_length": {"hist": hist_len},
        },
        "embeddings": {
            "embedding_size": {"user_id": 32, "item_id": 32, "category": 16},
            "embedding_table_size": {k: MIND_TABLE_SIZE[k]
                                     for k in ("user_id", "item_id", "category")},
            "share_emb_table_features": {"hist": "item_id"},
        },
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"lr": 1e-3, "min_lr": 5e-6,
                          "lr_milestones": [40000, 200000], "max_step": 300000,
                          "embedding_optimizer": embedding_optimizer},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 1,
                          "num_heads": 2, "ff_dim": 64},
    })


def attention_arrays(rows: int, hist_len: int = ATTENTION_HIST_LEN,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic rows for :func:`attention_config`, drawn in the JAX
    package's order so that the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, MIND_TABLE_SIZE["item_id"],
                        (rows, hist_len)).astype(np.int32)
    return {
        "user_id": rng.integers(1, MIND_TABLE_SIZE["user_id"], rows).astype(np.int32),
        "item_id": rng.integers(1, MIND_TABLE_SIZE["item_id"], rows).astype(np.int32),
        "category": rng.integers(1, MIND_TABLE_SIZE["category"], rows).astype(np.int32),
        "hist": hist,
        "hist_mask": (hist != 0).astype(np.float32),
        "label": (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1),
    }


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
    DeepFM; 3 cross layers for DCN (``dcn@v2``: version 2). ``attention`` is
    ``configs/attention.yaml``: the click history ``hist`` of 30, unpooled
    over the item table, and the pooled ``entities`` of 5 over a 30,000 x 16
    table (tables that back array features stay out of the arena, so none
    forms); ``attention@adamw`` keeps that file's all-dense ``adamw``."""
    if name not in RANKER_RECIPES:
        raise ValueError(f"no scoreboard recipe for {name!r}; known: {RANKER_RECIPES}")
    model, _, variant = name.partition("@")
    optimizer = "adamw" if variant == "adamw" else "rowwise_adagrad"
    raw = config_to_dict(mind_config(model, embedding_optimizer=optimizer))
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
        raw["dcn_cfg"] = {"num_layers": 3, "version": 2 if variant == "v2" else 1}
    if model == "attention":
        feats = raw["features"]
        feats["feature_names"] = MIND_FEATURES + ["hist", "entities"]
        feats["array_feature_names"] = ["hist", "entities"]
        feats["item_feature_names"] = feats["item_feature_names"] + ["entities"]
        feats["user_feature_names"] = feats["user_feature_names"] + ["hist"]
        feats["array_max_length"] = {"hist": ATTENTION_HIST_LEN, "entities": ENTITIES_LEN}
        emb["embedding_size"]["entities"] = ENTITIES_DIM
        emb["embedding_table_size"]["entities"] = ENTITIES_TABLE_SIZE
        emb["share_emb_table_features"] = {"hist": "item_id"}
        raw["attention_cfg"] = {"hist_feature": "hist", "num_layers": 1, "num_heads": 2,
                                "ff_dim": 64}
    return config_from_dict(raw)


def mind_nrms_config(batch_size: int = 64) -> Config:
    """NRMS (``models/nrms.py``) at the widths of its paper's section 4.1:
    300-d words, 16 heads of 16, an additive-attention query of 200, 4
    negatives a click, Adam (``adamw`` with weight decay 0, over every
    parameter: the all-dense step), batch 64; the MIND lengths of Microsoft
    Recommenders' NRMS settings (``title_size`` 30, ``his_size`` 50,
    ``npratio`` 4); a title table over MIND-small's 65,238 articles (row 0
    pads). Assumed: a 40,000-word vocabulary, a constant lr of 1e-4. Dropout
    0 (the paper: 0.2; the port trains without). The listwise loss: a
    softmax cross-entropy over each row's 1 + ``npratio`` candidates."""
    return config_from_dict({
        "name": "nrms",
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"lr": 1e-4, "min_lr": 1e-4, "lr_milestones": [40000, 200000],
                          "max_step": 300000, "weight_decay": 0.0,
                          "embedding_optimizer": "adamw"},
        "nrms_cfg": {"articles": MIND_TABLE_SIZE["item_id"], "title_len": 30,
                     "history_len": 50, "npratio": 4, "vocab": 40000, "word_dim": 300,
                     "num_heads": 16, "head_dim": 16, "query_dim": 200, "dropout": 0.0},
        "loss": "listwise",
    })
