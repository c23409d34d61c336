"""The recall -> rank cascade in plain PyTorch.

Recall: the DSSM user tower's embedding against every item's (both
L2-normalised), a user's clicked items left out, the ``fetch`` best by inner
product. Rank: the ranker's logit of each (user, candidate) pair, the
candidate's item features joined by its id. Served: the ``k`` candidates of
highest logit, each with its sigmoid.
"""

from __future__ import annotations

from typing import Dict

import torch

from .model import Params, ranker_logits, tower


def corpus(p: Params, recall: dict, items: Dict[str, torch.Tensor], block: int = 8192):
    """(n_items, D) item embeddings of ``items`` (arrays indexed by item id,
    row 0 the padding id) for ids 1..n_items."""
    n = items["item_id"].shape[0] - 1
    return torch.cat([tower(p, recall, "item", {k: v[s:s + block] for k, v in items.items()})
                      for s in range(1, n + 1, block)])


def recall_candidates(p: Params, recall: dict, users: Dict[str, torch.Tensor],
                      item_emb: torch.Tensor, fetch: int) -> torch.Tensor:
    """(N, fetch) item ids (1-based) of each user's best unclicked items;
    ``users["hist"]`` (N, L) holds the clicked ids, 0 as padding."""
    u = tower(p, recall, "user", users)
    scores = u @ item_emb.T                                          # (N, n_items)
    hist = users["hist"].long()
    clicked = torch.zeros_like(scores, dtype=torch.bool)
    clicked.scatter_(1, (hist - 1).clamp(min=0), hist > 0)
    scores = scores.masked_fill(clicked, float("-inf"))
    return torch.topk(scores, fetch, dim=1).indices + 1


def pair_logits(p: Params, model: dict, users: Dict[str, torch.Tensor],
                items: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """(N, M) ranker logits of user row r with item ``ids[r, j]``."""
    N, M = ids.shape
    batch = {n: users[n].repeat_interleave(M, dim=0) for n in model["user_features"]}
    flat = ids.reshape(-1).long()
    batch.update({n: items[n][flat] for n in model["item_features"]})
    return ranker_logits(p, model, batch).reshape(N, M)


def serve(p: Params, config: dict, users: Dict[str, torch.Tensor],
          items: Dict[str, torch.Tensor], item_emb: torch.Tensor, extra=None,
          block: int = 256) -> dict:
    """The cascade's answer for every user row, ``block`` users at a time:
    ``cand`` (N, fetch) recalled ids, ``cand_logits`` their logits,
    ``ids`` / ``scores`` (N, k) the served ids and sigmoid scores, and with
    ``extra`` (N, M) more ids, ``extra_logits`` their logits."""
    fetch, k = config["serve"]["fetch"], config["serve"]["k"]
    out = {"cand": [], "cand_logits": [], "ids": [], "scores": [], "extra_logits": []}
    N = users["hist"].shape[0]
    for s in range(0, N, block):
        u = {n: v[s:s + block] for n, v in users.items()}
        cand = recall_candidates(p, config["recall"], u, item_emb, fetch)
        logits = pair_logits(p, config["ranker"], u, items, cand)
        best, order = torch.topk(logits, k, dim=1)
        out["cand"].append(cand)
        out["cand_logits"].append(logits)
        out["ids"].append(torch.gather(cand, 1, order))
        out["scores"].append(torch.sigmoid(best))
        if extra is not None:
            out["extra_logits"].append(pair_logits(p, config["ranker"], u, items,
                                                   extra[s:s + block]))
    return {k_: torch.cat(v) for k_, v in out.items() if v}
