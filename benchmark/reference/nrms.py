"""NRMS in plain PyTorch, from the equations of Wu et al. (EMNLP-IJCNLP
2019, section 3): the benchmark's copy of ``tests/nrms_reference.py``,
with the parameters' laws, the news encoder computed in blocks of titles,
and the first steps as :mod:`.train_step`'s ``first_steps`` returns them.
Nothing here imports the program under test; float32 with TF32 off (the
control of ``correct`` turns it on around a call).

Parameters by name (the program's names; a weight is (in, out)):
``news.words`` (vocab, word_dim), N(0, init_scale) with row 0 zero;
``news.attn.wqkv`` (word_dim, 3 heads head_dim), ``[Q | K | V]`` with head
k in columns ``k head_dim .. (k + 1) head_dim`` of each third;
``news.pool.w`` (heads head_dim, query), ``.b`` and ``.q`` (query,);
``user.attn.wqkv`` (heads head_dim, 3 heads head_dim); ``user.pool.w``,
``.b``, ``.q``. Every weight but the words U(+-1/sqrt(fan_in)) (``.q``:
fan-in the query's width).

- Each head apart: ``softmax_s((x_t Q_k) . (x_s K_k) / sqrt(head_dim))``
  over the unmasked ``s`` (a masked score is -1e9), times ``x_s V_k``,
  summed; the heads concatenated.
- Additive pooling: ``a_t = q . tanh(h_t W + b)``, softmax over the
  unmasked ``t``, ``sum beta_t h_t``; zero where nothing is unmasked.
- A title's words are its row of the title table (0 pads); a history's
  articles are masked where the id is 0.
- Scores ``u . r_c``; the loss is the mean over rows of the cross-entropy
  of the row's scores against its positive (the label's 1).
- Adam (1-based bias correction, eps after the square root, decoupled
  weight decay scaled by the lr: 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG = -1e9
BLOCK = 8192            # titles encoded at once

Params = Dict[str, torch.Tensor]


def param_specs(config: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every parameter, in
    ``harness.weights.draw``'s laws."""
    m = config["model"]
    D, W, Q = m["word_dim"], m["num_heads"] * m["head_dim"], m["query_dim"]
    out = [("news.words", (m["vocab"], D), "normal", float(m["init_scale"]))]
    for side, n_in in (("news", D), ("user", W)):
        out += [(f"{side}.attn.wqkv", (n_in, 3 * W), "uniform", 1 / math.sqrt(n_in)),
                (f"{side}.pool.w", (W, Q), "uniform", 1 / math.sqrt(W)),
                (f"{side}.pool.b", (Q,), "uniform", 1 / math.sqrt(W)),
                (f"{side}.pool.q", (Q,), "uniform", 1 / math.sqrt(Q))]
    return out


def attention(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, heads: int,
              head_dim: int) -> torch.Tensor:
    """(N, L, Din), mask (N, L) bool -> (N, L, heads head_dim)."""
    width = heads * head_dim
    out = []
    for k in range(heads):
        cols = slice(k * head_dim, (k + 1) * head_dim)
        q = x @ w[:, cols]
        key = x @ w[:, width:][:, cols]
        v = x @ w[:, 2 * width:][:, cols]
        scores = q @ key.transpose(1, 2) / math.sqrt(head_dim)
        scores = scores.masked_fill(~mask[:, None, :], NEG)
        out.append(torch.softmax(scores, dim=-1) @ v)
    return torch.cat(out, dim=-1)


def additive_pool(h: torch.Tensor, mask: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """(N, L, D), mask (N, L) bool -> (N, D)."""
    a = (torch.tanh(h @ w + b) @ q).masked_fill(~mask, NEG)
    pooled = (torch.softmax(a, dim=-1)[..., None] * h).sum(dim=1)
    return torch.where(mask.any(dim=1, keepdim=True), pooled, torch.zeros_like(pooled))


def news_vectors(p: Params, words: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """Titles' word ids (N, L) -> (N, heads head_dim), ``BLOCK`` titles at
    a time."""
    out = []
    for i in range(0, words.shape[0], BLOCK):
        w = words[i:i + BLOCK].long()
        mask = w != 0
        h = attention(p["news.words"][w], p["news.attn.wqkv"], mask, heads, head_dim)
        out.append(additive_pool(h, mask, p["news.pool.w"], p["news.pool.b"], p["news.pool.q"]))
    return torch.cat(out)


def logits(p: Params, model: dict, titles: torch.Tensor, hist: torch.Tensor,
           cand: torch.Tensor) -> torch.Tensor:
    """(B, C) scores of the candidates ``cand`` (B, C) for the users whose
    histories are ``hist`` (B, H), over the title table ``titles``."""
    heads, hd = model["num_heads"], model["head_dim"]
    B, H = hist.shape
    ids = torch.cat([hist, cand], dim=1).long()
    r = news_vectors(p, titles[ids].reshape(-1, titles.shape[1]), heads, hd)
    r = r.view(B, ids.shape[1], -1)
    mask = hist != 0
    h = attention(r[:, :H], p["user.attn.wqkv"], mask, heads, hd)
    u = additive_pool(h, mask, p["user.pool.w"], p["user.pool.b"], p["user.pool.q"])
    return (u[:, None, :] * r[:, H:]).sum(dim=-1)


def loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over rows of -log softmax(scores)[positive]."""
    return F.cross_entropy(scores, labels.argmax(dim=1))


def first_steps(params: Params, config: dict, titles: torch.Tensor,
                batches: List[Dict[str, torch.Tensor]]) -> dict:
    """Train a copy of ``params`` on ``batches`` (``hist``, ``item_id``,
    ``label``) in turn with Adam at ``train.lr``; returns ``losses``,
    ``logits`` (each step's, flattened over the candidates, before its
    update), ``grad_norms`` (each leaf's first gradient norm),
    ``increments`` (none: no rowwise table) and ``change_norms``."""
    tr = config["train"]
    adam = tr["adam"]
    p = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, seen, grad_norms = [], [], {}
    for t, batch in enumerate(batches, start=1):
        scores = logits(p, config["model"], titles, batch["hist"], batch["item_id"])
        value = loss(scores, batch["label"])
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        losses.append(float(value.detach()))
        seen.append(scores.detach().reshape(-1))
        with torch.no_grad():
            for n, w in p.items():
                g = grads[n]
                if t == 1:
                    grad_norms[n] = float(torch.linalg.vector_norm(g.double()))
                mu[n].mul_(adam["b1"]).add_((1 - adam["b1"]) * g)
                nu[n].mul_(adam["b2"]).add_((1 - adam["b2"]) * g * g)
                mhat, vhat = mu[n] / (1 - adam["b1"] ** t), nu[n] / (1 - adam["b2"] ** t)
                w -= tr["lr"] * (mhat / (vhat.sqrt() + adam["eps"]) + adam["weight_decay"] * w)
    change = {n: float(torch.linalg.vector_norm((p[n].detach() - params[n]).double()))
              for n in p}
    return {"losses": losses, "logits": seen, "grad_norms": grad_norms, "increments": {},
            "change_norms": change}
