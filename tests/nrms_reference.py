"""NRMS in plain PyTorch, from the equations of Wu et al. (EMNLP-IJCNLP
2019, section 3) alone: the forward, the listwise loss and Adam, in float32
with TF32 off. Nothing here imports the port or JAX; the tests hold the
port (``news_recsys_tpu_torch/models/nrms.py`` on the all-dense step) to it.

Parameters by name (the port's names; a weight is (in, out)):
``news.words`` (vocab, word_dim); ``news.attn.wqkv`` (word_dim, 3 heads
head_dim), ``[Q | K | V]`` with head k in columns ``k head_dim .. (k + 1)
head_dim`` of each third; ``news.pool.w`` (heads head_dim, query), ``.b``
and ``.q`` (query,); ``user.attn.wqkv`` (heads head_dim, 3 heads head_dim);
``user.pool.w``, ``.b``, ``.q``.

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
  weight decay scaled by the lr, 0 for NRMS).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG = -1e9

Params = Dict[str, torch.Tensor]


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
    """Titles' word ids (N, L) -> (N, heads head_dim)."""
    mask = words != 0
    h = attention(p["news.words"][words.long()], p["news.attn.wqkv"], mask, heads, head_dim)
    return additive_pool(h, mask, p["news.pool.w"], p["news.pool.b"], p["news.pool.q"])


def logits(p: Params, titles: torch.Tensor, hist: torch.Tensor, cand: torch.Tensor,
           heads: int, head_dim: int) -> torch.Tensor:
    """(B, C) scores of the candidates ``cand`` (B, C) for the users whose
    histories are ``hist`` (B, H), over the title table ``titles``."""
    B, H = hist.shape
    ids = torch.cat([hist, cand], dim=1).long()
    r = news_vectors(p, titles[ids].reshape(-1, titles.shape[1]), heads, head_dim)
    r = r.view(B, ids.shape[1], -1)
    mask = hist != 0
    h = attention(r[:, :H], p["user.attn.wqkv"], mask, heads, head_dim)
    u = additive_pool(h, mask, p["user.pool.w"], p["user.pool.b"], p["user.pool.q"])
    return (u[:, None, :] * r[:, H:]).sum(dim=-1)


def loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over rows of -log softmax(scores)[positive]."""
    return F.cross_entropy(scores, labels.argmax(dim=1))


def adam_steps(params: Params, titles: torch.Tensor, batches: List[Dict[str, torch.Tensor]],
               heads: int, head_dim: int, lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0) -> dict:
    """Train a copy of ``params`` on ``batches`` (``hist``, ``item_id``,
    ``label``) in turn; returns ``params`` after, each step's ``losses``
    and ``logits`` (before its update) and the first step's ``grads``."""
    p = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, seen, first = [], [], None
    for t, batch in enumerate(batches, start=1):
        scores = logits(p, titles, batch["hist"], batch["item_id"], heads, head_dim)
        value = loss(scores, batch["label"])
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        losses.append(float(value.detach()))
        seen.append(scores.detach())
        if first is None:
            first = grads
        with torch.no_grad():
            for n, w in p.items():
                g = grads[n]
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g * g)
                mhat, vhat = mu[n] / (1 - b1 ** t), nu[n] / (1 - b2 ** t)
                w -= lr * (mhat / (vhat.sqrt() + eps) + weight_decay * w)
    return {"params": {n: t.detach() for n, t in p.items()}, "losses": losses, "logits": seen,
            "grads": first}
