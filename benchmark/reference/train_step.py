"""The training step of the configuration in plain PyTorch.

Binary cross-entropy on the ranker's logits, the mean over the batch;
gradients by autograd over whole tables. The tables in
``train.rowwise_tables`` take rowwise AdaGrad (one accumulator a row,
``acc += mean(g^2)``, ``p -= lr g / (sqrt(acc) + eps)``; a row with no
gradient is left as it is); every other parameter takes AdamW (optax's
``adamw``: 1-based bias correction, eps after the square root, decoupled
weight decay scaled by the lr). The lr holds at ``train.lr`` for the first
``lr_hold_steps`` steps, the only ones a benchmark run checks.

The epoch's train AUC is the binned statistic the configuration states
(``train.auc_bins``): each row's probability falls in bin
floor(p x bins), and the AUC is P(positive's bin > negative's) + 1/2
P(same bin); :func:`binned_auc` gives the interval that float32 rounding
of p leaves it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .model import Params, ranker_logits


def first_steps(params: Params, config: dict, batches: List[Dict[str, torch.Tensor]]) -> dict:
    """Train a copy of ``params`` on ``batches`` in turn; returns ``losses``
    (one a step), ``logits`` (each step's, before its update),
    ``grad_norms`` (each leaf's first gradient norm), ``increments`` (each
    rowwise table's median ``mean(g^2)`` over the rows the first step
    moves) and ``change_norms`` (each leaf's ``||p_n - p_0||`` after the
    last step)."""
    tr = config["train"]
    adamw = tr["adamw"]
    rowwise = {f"tables.{t}" for t in tr["rowwise_tables"]}
    p = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    acc = {n: torch.full((p[n].shape[0],), tr["adagrad_init"], device=p[n].device)
           for n in rowwise}
    mu = {n: torch.zeros_like(t) for n, t in p.items() if n not in rowwise}
    nu = {n: torch.zeros_like(t) for n, t in p.items() if n not in rowwise}
    losses, logits_seen, grad_norms, increments = [], [], {}, {}
    for step, batch in enumerate(batches):
        if step >= tr["lr_hold_steps"]:
            raise ValueError("the reference holds the lr only for the first lr_hold_steps steps")
        lr, t = tr["lr"], step + 1
        logits = ranker_logits(p, config["ranker"], batch)
        loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, batch["label"])
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
        losses.append(float(loss.detach()))
        logits_seen.append(logits.detach())
        with torch.no_grad():
            for n, w in p.items():
                g = grads[n] if grads[n] is not None else torch.zeros_like(w)
                if step == 0:
                    grad_norms[n] = float(torch.linalg.vector_norm(g.double()))
                if n in rowwise:
                    inc = (g * g).mean(dim=1)
                    if step == 0:
                        increments[n] = float(inc[inc > 0].median()) if (inc > 0).any() else 0.0
                    acc[n] += inc
                    w -= lr * g / (acc[n].sqrt() + tr["adagrad_eps"])[:, None]
                    continue
                mu[n].mul_(adamw["b1"]).add_((1 - adamw["b1"]) * g)
                nu[n].mul_(adamw["b2"]).add_((1 - adamw["b2"]) * g * g)
                mhat = mu[n] / (1 - adamw["b1"] ** t)
                vhat = nu[n] / (1 - adamw["b2"] ** t)
                w -= lr * (mhat / (vhat.sqrt() + adamw["eps"]) + adamw["weight_decay"] * w)
    change = {n: float(torch.linalg.vector_norm((p[n].detach() - params[n]).double()))
              for n in p}
    return {"losses": losses, "logits": logits_seen, "grad_norms": grad_norms,
            "increments": increments, "change_norms": change}


def _auc(pos: torch.Tensor, neg: torch.Tensor) -> float:
    below = torch.cumsum(neg, 0) - neg
    total = pos.sum() * neg.sum()
    return float((pos * (below + 0.5 * neg)).sum() / total) if float(total) > 0 else 0.0


def binned_auc(logits: torch.Tensor, labels: torch.Tensor, bins: int, edge: float) -> tuple:
    """The least and the largest binned train AUC of rows with ``logits``
    and 0/1 ``labels``: a row within ``edge`` of a bin's width from a bin's
    edge may fall on either side of it under float32 rounding, so it is put
    on the side that lowers (raises) the AUC: a positive below (above), a
    negative above (below)."""
    x = torch.sigmoid(logits.float()).double() * bins
    b = x.floor()
    frac = x - b
    y = labels.double()
    out = []
    for sign in (-1, 1):
        # sign -1: positives near their bin's lower edge go down, negatives near the upper go up
        down = (frac < edge) & ((y > 0.5) if sign < 0 else (y < 0.5))
        up = (frac > 1 - edge) & ((y < 0.5) if sign < 0 else (y > 0.5))
        k = (b - down.double() + up.double()).clamp(0, bins - 1).long()
        pos = torch.zeros(bins, dtype=torch.float64, device=k.device).index_add_(0, k, y)
        neg = torch.zeros(bins, dtype=torch.float64, device=k.device).index_add_(0, k, 1.0 - y)
        out.append(_auc(pos, neg))
    return out[0], out[1]
