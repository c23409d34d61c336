"""The per-user ranking metric engine on the device.

Port of :mod:`news_recsys_tpu.training.metrics_device`: the same block as
the host engine (:mod:`.metrics`), computed by one sort and segment
reductions in torch on the trainer's device, so that a dev split of millions
of rows needs no host pass over its users. Cohorts (Overall / Warm / Cold)
come from a per-row warm mask. Semantics are the host engine's:

- a stable order within a user, descending by score, ties in row order (two
  stable sorts in place of ``lexsort((arange, -scores, uids))``);
- per-user AUC with average ranks on ties, only for users with both classes;
- users with no positive contribute 0 to HR, NDCG and MRR.

The engine gives the same bits on every run. Its per-user sums add integers
(counts, and twice the average ranks, which are half-integers) as
differences of an int64 running sum, which is exact in any order; NDCG, HR
and MRR read each user's top ``k`` rows as a ``(users, k)`` table and reduce
it along ``k``; the cohort means are float64 ``torch.sum``s, which reduce in
a fixed order. No float sum goes through atomics (``index_add_`` on the card
adds in any order). Pooled AUC and LogLoss are finalised on the host in
float64 with :func:`.metrics.pooled_auc` / :func:`.metrics.pooled_logloss`,
as JAX does: at MIND-dev scale the pooled rank sums reach ~1e12.

The streaming train AUC lives here too: :class:`AucHist`, the epoch's binned
(pos, neg) score histograms on the device, which the train steps fill
(:func:`binned_auc_update`) and the trainer reads once an epoch
(:func:`binned_auc_value`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set

import numpy as np
import torch

from .metrics import K_DEFAULT, _idcg_table, compute_user_metrics, pooled_auc, pooled_logloss

AUC_BINS = 4096


@dataclass
class AucHist:
    """Binned (pos, neg) score histograms for the streaming train AUC."""

    pos: torch.Tensor
    neg: torch.Tensor

    @staticmethod
    def zeros(device) -> "AucHist":
        return AucHist(torch.zeros(AUC_BINS, device=device),
                       torch.zeros(AUC_BINS, device=device))


def binned_auc_update(hist: AucHist, probs, labels, weights) -> AucHist:
    """Add a batch to ``hist`` in place (and return it): bin = floor(p * BINS)
    clipped, weighted by ``weights * labels`` and ``weights * (1 - labels)``.
    ``index_add_`` rather than ``torch.bincount``, whose CUDA path reads the
    largest bin back to the host on every call."""
    bins = (probs * AUC_BINS).to(torch.int32).clamp(0, AUC_BINS - 1)
    hist.pos.index_add_(0, bins, weights * labels)
    hist.neg.index_add_(0, bins, weights * (1.0 - labels))
    return hist


def binned_auc_value(hist: AucHist) -> float:
    """AUC estimate: P(score_pos > score_neg) + 0.5 P(equal bin)."""
    cum_neg = torch.cumsum(hist.neg, 0) - hist.neg      # negatives strictly below bin
    wins = torch.sum(hist.pos * (cum_neg + 0.5 * hist.neg))
    total = torch.sum(hist.pos) * torch.sum(hist.neg)
    return float(wins / total) if float(total) > 0 else 0.0


def _segment_sum(x: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sums of the int64 ``x`` over the row ranges ``[starts, ends)``, as
    differences of its running sum: exact, so the same bits every run."""
    run = torch.cumsum(x, 0)
    before = torch.where(starts > 0, run[(starts - 1).clamp(min=0)], 0)
    return run[ends - 1] - before


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> float:
    n = int(mask.sum())
    return float(torch.where(mask, vals, 0.0).sum() / n) if n else 0.0


def _user_metrics(uids: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                  warm_rows: torch.Tensor, k: int) -> Dict[str, Dict[str, float]]:
    n, dev = uids.numel(), uids.device
    by_score = torch.sort(scores, descending=True, stable=True).indices
    order = by_score[torch.sort(uids[by_score], stable=True).indices]
    u, s = uids[order], scores[order]
    is_pos = labels[order] == 1

    new_user = torch.ones(n, dtype=torch.bool, device=dev)
    new_user[1:] = u[1:] != u[:-1]
    starts = torch.nonzero(new_user).squeeze(1)                   # each user's first row
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    count = ends - starts
    seg = torch.cumsum(new_user, 0) - 1                           # each row's user
    npos = _segment_sum(is_pos.long(), starts, ends)
    nneg = count - npos
    user_warm = warm_rows[order][starts]

    # top-k: each user's first k rows (already descending by score)
    j = torch.arange(k, device=dev)
    in_user = j < count[:, None]
    hit = is_pos[torch.where(in_user, starts[:, None] + j, 0)] & in_user     # (users, k)
    gains = torch.from_numpy(1.0 / np.log2(np.arange(1, k + 1) + 1.0)).to(dev)
    idcg = torch.from_numpy(_idcg_table(k, k)).to(dev)[npos.clamp(max=k)]
    hr = hit.any(1)
    dcg = torch.where(hit, gains, 0.0).sum(1)
    ndcg = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-300), 0.0)
    first = torch.where(hit, j, k).amin(1)                      # first positive's place
    mrr = torch.where(hr, 1.0 / (first.double() + 1.0), 0.0)

    # per-user AUC from twice each row's ascending average rank in its user
    new_group = new_user.clone()
    new_group[1:] |= s[1:] != s[:-1]
    g_starts = torch.nonzero(new_group).squeeze(1)
    g_count = torch.cat([g_starts[1:], g_starts.new_tensor([n])]) - g_starts
    gid = torch.cumsum(new_group, 0) - 1
    desc2 = 2 * (g_starts[gid] - starts[seg]) + g_count[gid] + 1
    asc2 = 2 * count[seg] + 2 - desc2
    pos_rank2 = _segment_sum(torch.where(is_pos, asc2, 0), starts, ends)
    both = (npos > 0) & (nneg > 0)
    user_auc = ((pos_rank2 - npos * (npos + 1)).double()
                / (2 * npos * nneg).clamp(min=1).double())

    def cohort(users: torch.Tensor) -> Dict[str, float]:
        return {"GAUC": _masked_mean(user_auc, users & both),
                f"NDCG@{k}": _masked_mean(ndcg, users),
                f"HR@{k}": _masked_mean(hr.double(), users),
                f"MRR@{k}": _masked_mean(mrr, users),
                "User_Count": int(users.sum())}

    return {"Overall": cohort(torch.ones_like(user_warm)),
            "Warm_Start": cohort(user_warm), "Cold_Start": cohort(~user_warm)}


def compute_user_metrics_device(user_ids, scores, labels, warm_user_set: Optional[Set[int]] = None,
                                k: int = K_DEFAULT, device="cuda") -> Dict[str, Dict[str, float]]:
    """:func:`.metrics.compute_user_metrics`'s block, its per-user metrics
    computed on ``device`` (the card unless the caller names another)."""
    user_ids = np.asarray(user_ids).reshape(-1).astype(np.int64)
    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    labels = np.asarray(labels, dtype=np.float32).reshape(-1)
    if len(user_ids) == 0:
        return compute_user_metrics(user_ids, scores, labels, warm_user_set, k)   # the empty block
    if warm_user_set:
        uniq = np.unique(user_ids)
        warm_uniq = np.asarray([int(x) in warm_user_set for x in uniq])
        warm_rows = warm_uniq[np.searchsorted(uniq, user_ids)]
    else:
        warm_rows = np.ones(len(user_ids), dtype=bool)
    device = torch.device(device)
    per_user = _user_metrics(*(torch.from_numpy(a).to(device)
                               for a in (user_ids, scores, labels, warm_rows)), k)
    result = {}
    for name, m in (("Overall", np.ones(len(user_ids), bool)), ("Warm_Start", warm_rows),
                    ("Cold_Start", ~warm_rows)):
        result[name] = {"AUC": pooled_auc(labels[m], scores[m]) if m.any() else 0.0,
                        "LogLoss": pooled_logloss(labels[m], scores[m]) if m.any() else 0.0,
                        **per_user[name]}
    result["Overall"].pop("User_Count")
    return result
