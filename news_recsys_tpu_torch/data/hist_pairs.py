"""Self-supervised history pairs for two-tower retrieval training.

The port's own copy of :mod:`news_recsys_tpu.data.hist_pairs` (numpy only;
``tests/test_torch_shared.py`` holds it to the original). ``train`` uses
:func:`random_negative_rows` and :func:`concat_datasets` for the rankers, and
:func:`positives_only` and :func:`hist_augmented_pairs` for the DSSM.

Round-4 evidence (``artifacts/rankers_fullscale_r04.json`` category-ceiling
analysis): label-supervised InfoNCE starves at MIND's ~1.35 labels/item
while ItemCF's co-click graph carries ~25 interactions/item — the r04 DSSM
plateaued at HR@10 0.0012 vs ItemCF 0.0058 *with* a mean-pooled ``hist``
feature already in the user tower. The missing piece is not the feature but
the TRAINING SIGNAL: this module turns each user's click history into
leave-one-out retrieval pairs —

    (user features with hist \\ {h_j})  ->  item features of h_j

— the exact co-occurrence structure ItemCF factorizes, expressed as extra
InfoNCE positives for the standard DSSM trainer (which already trains only
on label==1 rows with in-batch negatives). Holding the target OUT of the
input history prevents the degenerate "copy an input embedding" solution,
which eval could never use anyway (retrieval dedups the history,
``DSSM/model.py:205-224``).

The reference trains its DSSM on click pairs only (``DSSM/train.py:33-42``);
augmentation is opt-in via ``dssm_cfg.hist_augment``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import Config
from .packed_dataset import PackedDataset


def positives_only(ds: PackedDataset) -> PackedDataset:
    """Rows with label 1 — the only rows the DSSM loss uses; dropping the
    masked-out negatives shrinks the epoch ~10x at MIND scale."""
    keep = ds.arrays["label"][:, 0] == 1
    return PackedDataset({k: v[keep] for k, v in ds.arrays.items()})


def concat_datasets(a: PackedDataset, b: PackedDataset) -> PackedDataset:
    if set(a.arrays) != set(b.arrays):
        raise ValueError(f"Column mismatch: {sorted(a.arrays)} vs {sorted(b.arrays)}")
    return PackedDataset({k: np.concatenate([a.arrays[k], b.arrays[k]])
                          for k in a.arrays})


def random_negative_rows(cfg: Config, train_ds: PackedDataset,
                         item_ds: PackedDataset, per_positive: int = 4,
                         seed: int = 0) -> PackedDataset:
    """Label-0 rows pairing each positive row's user with uniformly-sampled
    corpus items (exposure debiasing for rankers that will re-score
    RETRIEVAL candidates).

    An impression-trained ranker only ever sees items an upstream system
    chose to display; its scores extrapolate poorly to corpus-level
    candidates and a naive recall->rank cascade DEGRADES HR@10 (measured:
    0.0193 -> 0.0089, artifacts/cascade_eval_r05.json). Mixing in random
    corpus negatives teaches the ranker to push never-displayed items
    below displayed ones — the standard sampled-negative fix.
    """
    rng = np.random.default_rng(seed)
    keep = np.flatnonzero(np.asarray(train_ds.arrays["label"])[:, 0] == 1)
    src = keep.repeat(per_positive)
    n = src.size
    item_ids = np.asarray(item_ds.arrays["item_id"])
    ipos = rng.integers(0, item_ids.size, n)

    item_cols = set(cfg.features.item_feature_names)
    out: Dict[str, np.ndarray] = {}
    for k, v in train_ds.arrays.items():
        base = k[:-5] if k.endswith("_mask") else k
        if k == "label":
            out[k] = np.zeros((n,) + v.shape[1:], np.float32)
        elif base in item_cols and k in item_ds.arrays:
            out[k] = np.asarray(item_ds.arrays[k])[ipos]
        else:
            out[k] = np.asarray(v)[src]
    return PackedDataset(out)


def hist_augmented_pairs(cfg: Config, train_ds: PackedDataset,
                         item_ds: PackedDataset,
                         hist_name: str = "hist") -> PackedDataset:
    """Leave-one-out (user-hist, held-out-item) positive pairs, packed with
    the SAME columns as ``train_ds`` so the standard trainer consumes them.

    Per user, the row with the LONGEST history is canonical (histories grow
    over a user's impressions; the longest is the most complete and using
    one row per user avoids duplicate pairs). For each real history entry
    ``h_j`` (users need >= 2 entries), one output row carries the user's
    features with ``h_j`` deleted from the history (trailing zero-pad keeps
    the fixed width) and the item-side features of ``h_j`` joined from
    ``item_ds``. Labels are all 1.
    """
    if hist_name not in train_ds.arrays:
        raise ValueError(
            f"hist_augment needs a '{hist_name}' column in the train split — "
            f"re-run feature extraction with '{hist_name}' in "
            f"features.feature_names (have: {sorted(train_ds.arrays)})")
    hist = np.asarray(train_ds.arrays[hist_name])
    uids = np.asarray(train_ds.arrays["user_id"])
    lens = (hist != 0).sum(axis=1)

    # canonical row per user: last in (uid, len) order = longest
    order = np.lexsort((lens, uids))
    is_last = np.concatenate([uids[order][1:] != uids[order][:-1], [True]])
    rows = order[is_last]
    rows = rows[lens[rows] >= 2]
    if rows.size == 0:
        raise ValueError("No user has >= 2 history entries; nothing to augment.")

    H = hist[rows]                                     # (U, L)
    U, L = H.shape
    # DEL[j] = positions with j removed; H[:, DEL] enumerates all
    # leave-one-out candidate histories at once
    DEL = np.array([[k for k in range(L) if k != j] for j in range(L)])
    cand = H[:, DEL].reshape(U * L, L - 1)             # (U*L, L-1)
    targets = H.reshape(-1)                            # target j per row
    sel = (H != 0).reshape(-1)                         # real positions only

    # join item-side features by target id
    item_ids = np.asarray(item_ds.arrays["item_id"])
    pos = np.full(int(item_ids.max()) + 2, -1, np.int64)
    pos[item_ids] = np.arange(item_ids.size)
    tgt = targets[sel]
    in_corpus = (tgt < pos.size - 1) & (pos[np.minimum(tgt, pos.size - 1)] >= 0)
    if not in_corpus.all():
        sel_idx = np.flatnonzero(sel)[in_corpus]
        sel = np.zeros_like(sel)
        sel[sel_idx] = True
        tgt = targets[sel]

    hist_aug = np.concatenate(
        [cand[sel], np.zeros((sel.sum(), 1), cand.dtype)], axis=1)  # (R, L)
    src_row = rows.repeat(L)[sel]
    ipos = pos[tgt]
    n = tgt.size

    item_cols = set(cfg.features.item_feature_names)
    out: Dict[str, np.ndarray] = {}
    for k, v in train_ds.arrays.items():
        base = k[:-5] if k.endswith("_mask") else k
        if k == "label":
            out[k] = np.ones((n,) + v.shape[1:], np.float32)
        elif k == hist_name:
            out[k] = hist_aug
        elif k == f"{hist_name}_mask":
            out[k] = (hist_aug != 0).astype(v.dtype)
        elif base in item_cols and k in item_ds.arrays:
            out[k] = np.asarray(item_ds.arrays[k])[ipos]
        else:
            out[k] = v[src_row]
    return PackedDataset(out)
