"""Validation metric engine: AUC / LogLoss / GAUC / NDCG@k / HR@k / MRR@k
for Overall / Warm-start / Cold-start user cohorts. The port's own copy of
:mod:`news_recsys_tpu.training.metrics` (numpy only;
``tests/test_torch_shared.py`` holds it to the original).

Exact functional parity with the reference's per-user Python loop
(``base_model.py:333-492``), re-designed as a vectorized segment computation
(sort by user, then stable by score) — O(n log n) instead of a Python loop
over ~50k users. Semantics preserved:

- per-user AUC appended only for users with both classes present
  (``base_model.py:380-386``); GAUC is the mean of those;
- users with zero positives contribute 0.0 to HR/NDCG/MRR
  (``base_model.py:396-404``); every user contributes to those lists, so
  ``User_Count = #users``;
- top-k ordering is *stable* descending by score (Python ``sorted`` is
  stable), so ties keep dataset order;
- pooled AUC uses the Mann-Whitney rank formula with average ranks on ties
  — identical to sklearn's ``roc_auc_score`` for binary labels;
- LogLoss clips predictions to [1e-15, 1 - 1e-15] (``base_model.py:452-455``);
- warm = user id in the train-user set (``base_model.py:363-366``), cold
  otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Set

import numpy as np

K_DEFAULT = 10


def _average_ranks(values: np.ndarray) -> np.ndarray:
    """1-based average ranks (ascending) with ties averaged, like scipy rankdata."""
    order = np.argsort(values, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(values))
    sorted_vals = values[order]
    # tie-group boundaries in sorted order
    new_group = np.ones(len(values), dtype=bool)
    if len(values) > 1:
        new_group[1:] = sorted_vals[1:] != sorted_vals[:-1]
    group_id = np.cumsum(new_group) - 1
    group_start = np.flatnonzero(new_group)
    counts = np.diff(np.append(group_start, len(values)))
    # average rank of group g = start + (count+1)/2  (1-based)
    avg = group_start + (counts + 1) / 2.0
    return avg[group_id][inv]


def pooled_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank formula; 0.0 if only one class (reference behavior)."""
    labels = np.asarray(labels)
    npos = int(np.sum(labels == 1))
    nneg = len(labels) - npos
    if npos == 0 or nneg == 0:
        return 0.0
    ranks = _average_ranks(np.asarray(scores, dtype=np.float64))
    return float((ranks[labels == 1].sum() - npos * (npos + 1) / 2.0) / (npos * nneg))


def pooled_logloss(labels: np.ndarray, scores: np.ndarray) -> float:
    if len(labels) == 0:
        return 0.0
    eps = 1e-15
    p = np.clip(np.asarray(scores, dtype=np.float64), eps, 1 - eps)
    y = np.asarray(labels, dtype=np.float64)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def _idcg_table(k: int, max_pos: int) -> np.ndarray:
    """idcg[m] = sum_{r=1..min(m,k)} 1/log2(r+1)."""
    gains = 1.0 / np.log2(np.arange(1, k + 1) + 1)
    cum = np.concatenate([[0.0], np.cumsum(gains)])
    m = np.arange(max_pos + 1)
    return cum[np.minimum(m, k)]


def compute_user_metrics(
    user_ids: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    warm_user_set: Optional[Set[int]] = None,
    k: int = K_DEFAULT,
) -> Dict[str, Dict[str, float]]:
    """Full Overall/Warm/Cold metric block over flat (uid, score, label) rows.

    Rows may be in any order; within-user tie order follows row order (the
    reference accumulates rows in dataset order, ``base_model.py:320-331``).
    """
    user_ids = np.asarray(user_ids).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    n = len(user_ids)
    if n == 0:
        empty = {"AUC": 0.0, "LogLoss": 0.0, "GAUC": 0.0, f"NDCG@{k}": 0.0, f"HR@{k}": 0.0, f"MRR@{k}": 0.0}
        return {"Overall": dict(empty),
                "Warm_Start": {**empty, "User_Count": 0},
                "Cold_Start": {**empty, "User_Count": 0}}

    # Stable sort: by uid, then score desc, then original row order.
    order = np.lexsort((np.arange(n), -scores, user_ids))
    uid_s, score_s, label_s = user_ids[order], scores[order], labels[order]

    # Segment structure
    uniq_uids, seg_start, seg_count = np.unique(uid_s, return_index=True, return_counts=True)
    n_users = len(uniq_uids)
    seg_id = np.repeat(np.arange(n_users), seg_count)
    pos_in_seg = np.arange(n) - seg_start[seg_id]

    is_pos = label_s == 1
    npos = np.bincount(seg_id, weights=is_pos.astype(np.float64), minlength=n_users)
    nneg = seg_count - npos

    # ---- top-k metrics (rows already stable-sorted desc by score per user)
    topk_mask = pos_in_seg < k
    topk_pos = topk_mask & is_pos

    hr = np.bincount(seg_id, weights=topk_pos.astype(np.float64), minlength=n_users) > 0
    hr = hr.astype(np.float64)

    dcg_gains = np.where(topk_pos, 1.0 / np.log2(pos_in_seg + 2.0), 0.0)
    dcg = np.bincount(seg_id, weights=dcg_gains, minlength=n_users)
    idcg = _idcg_table(k, int(seg_count.max()))[np.minimum(npos.astype(np.int64), seg_count)]
    ndcg = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-300), 0.0)

    # MRR: rank of first positive within top-k
    first_pos_rank = np.full(n_users, np.inf)
    pos_rows = np.flatnonzero(topk_pos)
    if len(pos_rows):
        # reverse order so earlier rows overwrite later ones
        np.minimum.at(first_pos_rank, seg_id[pos_rows], pos_in_seg[pos_rows] + 1.0)
    mrr = np.where(np.isfinite(first_pos_rank), 1.0 / np.where(np.isfinite(first_pos_rank), first_pos_rank, 1.0), 0.0)

    # Users with no positives: reference records 0.0 for hr/ndcg/mrr
    no_pos = npos == 0
    hr[no_pos] = 0.0
    ndcg[no_pos] = 0.0
    mrr[no_pos] = 0.0

    # ---- per-user AUC (only users with both classes)
    # Average ranks of scores ascending *within user*: rank among the user's
    # rows. Compute from the sorted layout: within a segment rows are desc by
    # score, so ascending rank = seg_count - desc_position, with tie groups
    # averaged.
    both = (npos > 0) & (nneg > 0)
    # tie groups within (uid, score)
    new_group = np.ones(n, dtype=bool)
    new_group[1:] = (uid_s[1:] != uid_s[:-1]) | (score_s[1:] != score_s[:-1])
    tg_id = np.cumsum(new_group) - 1
    tg_start = np.flatnonzero(new_group)
    tg_count = np.diff(np.append(tg_start, n))
    # Descending 1-based rank of a tie group = avg of positions start..end
    tg_desc_avg = (tg_start - seg_start[seg_id[tg_start]]) + (tg_count + 1) / 2.0
    desc_rank = tg_desc_avg[tg_id]
    asc_rank = seg_count[seg_id] + 1.0 - desc_rank
    pos_rank_sum = np.bincount(seg_id, weights=np.where(is_pos, asc_rank, 0.0), minlength=n_users)
    with np.errstate(divide="ignore", invalid="ignore"):
        user_auc = (pos_rank_sum - npos * (npos + 1) / 2.0) / (npos * nneg)

    # ---- cohorts
    if warm_user_set:
        warm_lookup = np.asarray([int(u) in warm_user_set for u in uniq_uids])
    else:
        warm_lookup = np.ones(n_users, dtype=bool)  # no set -> all warm (reference: is_cold stays False)
    warm_rows = warm_lookup[seg_id]

    def cohort(user_mask: np.ndarray, row_mask: np.ndarray, include_count: bool):
        res = {
            "AUC": pooled_auc(label_s[row_mask], score_s[row_mask]) if row_mask.any() else 0.0,
            "LogLoss": pooled_logloss(label_s[row_mask], score_s[row_mask]) if row_mask.any() else 0.0,
            "GAUC": float(np.mean(user_auc[user_mask & both])) if (user_mask & both).any() else 0.0,
            f"NDCG@{k}": float(np.mean(ndcg[user_mask])) if user_mask.any() else 0.0,
            f"HR@{k}": float(np.mean(hr[user_mask])) if user_mask.any() else 0.0,
            f"MRR@{k}": float(np.mean(mrr[user_mask])) if user_mask.any() else 0.0,
        }
        if include_count:
            res["User_Count"] = int(user_mask.sum())
        return res

    all_users = np.ones(n_users, dtype=bool)
    all_rows = np.ones(n, dtype=bool)
    return {
        "Overall": cohort(all_users, all_rows, include_count=False),
        "Warm_Start": cohort(warm_lookup, warm_rows, include_count=True),
        "Cold_Start": cohort(~warm_lookup, ~warm_rows, include_count=True),
    }


def format_validation_block(results: Dict[str, Dict[str, float]], epoch: int, k: int = K_DEFAULT) -> str:
    """Render the exact ``val_log.log`` block format (``base_model.py:494-519``)."""
    return (
        f"\n{'=' * 20} Epoch {epoch} Validation Results {'=' * 20}\n"
        f"Overall:\n"
        f"  AUC:      {results['Overall']['AUC']:.4f}\n"
        f"  LogLoss:  {results['Overall']['LogLoss']:.4f}\n"
        f"  GAUC:     {results['Overall']['GAUC']:.4f}\n"
        f"  NDCG@{k}:  {results['Overall'][f'NDCG@{k}']:.4f}\n"
        f"  HR@{k}:    {results['Overall'][f'HR@{k}']:.4f}\n"
        f"  MRR@{k}:   {results['Overall'][f'MRR@{k}']:.4f}\n"
        f"Warm Start Users ({results['Warm_Start']['User_Count']}):\n"
        f"  AUC:      {results['Warm_Start']['AUC']:.4f}\n"
        f"  LogLoss:  {results['Warm_Start']['LogLoss']:.4f}\n"
        f"  GAUC:     {results['Warm_Start']['GAUC']:.4f}\n"
        f"  NDCG@{k}:  {results['Warm_Start'][f'NDCG@{k}']:.4f}\n"
        f"  HR@{k}:    {results['Warm_Start'][f'HR@{k}']:.4f}\n"
        f"  MRR@{k}:   {results['Warm_Start'][f'MRR@{k}']:.4f}\n"
        f"Cold Start Users ({results['Cold_Start']['User_Count']}):\n"
        f"  AUC:      {results['Cold_Start']['AUC']:.4f}\n"
        f"  LogLoss:  {results['Cold_Start']['LogLoss']:.4f}\n"
        f"  GAUC:     {results['Cold_Start']['GAUC']:.4f}\n"
        f"  NDCG@{k}:  {results['Cold_Start'][f'NDCG@{k}']:.4f}\n"
        f"  HR@{k}:    {results['Cold_Start'][f'HR@{k}']:.4f}\n"
        f"  MRR@{k}:   {results['Cold_Start'][f'MRR@{k}']:.4f}\n"
        f"{'=' * 60}\n"
    )
