"""The numbers that decide ``correct``, each against its limit in the cell's
file (``limits``).

Training (the first steps, driven in set-up through ``Trainer.train_epoch``
on the trainer and the packed data that the window then times, against the
reference's same steps on the same rows):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, the program's as its optimizer got it (worked out from the
  state after one step: AdamW's first moment, a rowwise table's
  accumulator), over the larger of the reference leaf's norm and the median
  compared leaf's. A rowwise table is compared where its state can hold the
  gradient: where the reference's median row adds at least
  ``READABLE_STEPS`` float32 steps of the accumulator's start to it; others
  are left out, by that rule on the reference's gradient, and printed;
- ``change_gap``: the same of each leaf's change after the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone);
- ``auc_gap``: the largest distance of the train AUC that a checked
  ``train_epoch`` call's carry gives from the reference's binned AUC over its
  own logits of the same rows: an interval, whose ends put each row within
  ``AUC_EDGE`` of a bin's width from an edge on either side of it (0 inside);
- ``feed_rows``: batch rows the program trained on that are no rows of the
  data set, or repeated (exact: 0).

Serving (the sampled requests' answers against the reference cascade):

- ``missing``: requests sent in the window with no answer, or an error, and
  sampled requests with no answer (0);
- ``bad_answers``: users whose list is not ``k`` distinct unclicked items
  of the corpus (0);
- ``score_err``: the largest gap between a served score and the sigmoid of
  the reference's logit of that (user, item);
- ``rank_gap``: the largest amount by which the reference's j-th best
  logit over its candidates lies above the logit of the item served j-th.
"""

from __future__ import annotations

import statistics
from typing import Dict

import numpy as np
import torch

RARE_LEAF = 1e-3
READABLE_STEPS = 100
AUC_EDGE = 0.01


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> tuple:
    names = [n for n in ref if keep is None or n in keep]
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def step_aucs(logits, labels, calls, bins: int, edge: float = AUC_EDGE) -> list:
    """The binned AUC's interval over the steps of each of ``calls``."""
    from reference.train_step import binned_auc

    return [binned_auc(torch.cat([logits[i] for i in c]),
                       torch.cat([labels[i] for i in c]), bins, edge) for c in calls]


def training(prog: dict, ref: dict, labels, train: dict) -> dict:
    """The training numbers, the worst leaves by name, and the leaves left
    out with their readings; ``labels``: each step's (B,) labels."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    floor = statistics.median(ref["grad_norms"].values())
    moving = {n for n, g in ref["grad_norms"].items() if g >= RARE_LEAF * floor}
    step = float(np.spacing(np.float32(train["adagrad_init"])))
    unreadable = {n: {"median_increment": inc, "state_step": step,
                      "program": prog["grad_norms"].get(n), "reference": ref["grad_norms"][n]}
                  for n, inc in ref["increments"].items() if inc < READABLE_STEPS * step}
    compared = [n for n in ref["grad_norms"] if n not in unreadable]
    grads = {n: prog["grad_norms"].get(n, 0.0) for n in compared}
    grad, grad_leaf = _leaf_gap(grads, ref["grad_norms"], compared)
    change, change_leaf = _leaf_gap(prog["change_norms"], ref["change_norms"], moving)
    want = step_aucs(ref["logits"], labels, prog["calls"], train["auc_bins"])
    auc = max(max(lo - a, a - hi, 0.0) for a, (lo, hi) in zip(prog["aucs"], want))
    return {"numbers": {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
                        "auc_gap": auc, "feed_rows": prog["feed_rows"]},
            "worst": {"grad_gap": grad_leaf, "change_gap": change_leaf},
            "aucs": {"program": prog["aucs"], "reference": want},
            "left_out": {"change_gap": sorted(set(ref["grad_norms"]) - moving),
                         "grad_gap": unreadable}}


def row_keys(arrays: Dict[str, np.ndarray], names) -> np.ndarray:
    """A 64-bit key of each row of ``arrays`` over ``names`` (int64
    products wrap, which a key may)."""
    w = np.random.default_rng(0)
    key = np.zeros(len(arrays[names[0]]), dtype=np.int64)
    for n in names:
        col = arrays[n].reshape(len(key), -1).astype(np.int64)
        key = key * 1000003 + col @ w.integers(1, 2 ** 62, col.shape[1], dtype=np.int64)
    return key


def feed_rows(batches, arrays: Dict[str, np.ndarray], names) -> int:
    """Rows of ``batches`` that are no row of ``arrays``, or that repeat."""
    got = row_keys({n: np.concatenate([b[n] for b in batches]) for n in names}, names)
    return int((~np.isin(got, row_keys(arrays, names))).sum() + len(got) - len(np.unique(got)))


def serving(ids: np.ndarray, scores: np.ndarray, hist: np.ndarray, ref: dict,
            n_items: int) -> dict:
    """Serving numbers over users: ``ids`` / ``scores`` (N, k) as served (-1
    where a list is short), ``hist`` (N, L) the clicked ids, ``ref`` the
    reference's ``cand_logits`` and ``extra_logits`` (of ``ids``)."""
    k = ids.shape[1]
    ok = (ids >= 1) & (ids <= n_items)
    dup = np.array([len(set(r)) < k for r in ids])
    clicked = np.array([bool(set(r) & set(h[h > 0])) for r, h in zip(ids, hist)])
    good = ok.all(axis=1) & ~dup & ~clicked
    out = {"bad_answers": int((~good).sum()), "score_err": 0.0, "rank_gap": 0.0}
    if good.any():
        logits = ref["extra_logits"].double().cpu().numpy()[good]
        served = torch.sigmoid(torch.from_numpy(logits)).numpy()
        out["score_err"] = float(np.abs(scores[good] - served).max())
        best = torch.topk(ref["cand_logits"].double(), k, dim=1).values.cpu().numpy()[good]
        out["rank_gap"] = float(max(0.0, (best - logits).max()))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the cell's limits."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
