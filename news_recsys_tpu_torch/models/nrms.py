"""NRMS: Wu et al., "Neural News Recommendation with Multi-Head
Self-Attention" (EMNLP-IJCNLP 2019), MIND's reference neural recommender.
It reads each article's title, where the rankers of :mod:`.rankers` and
:mod:`.seq_ranker` see an article only by its ids.

- News encoder. An article's title is its row of the title table
  ``titles`` (articles x ``title_len`` word ids, 0 pads), a buffer on the
  model's device. Its words ``e_t = E[w_t]`` (the word table ``news.words``,
  vocab x ``word_dim``) go through a multi-head self-attention without
  bias: head k has ``Q_k``, ``K_k``, ``V_k`` of ``word_dim x head_dim``,
  held as one ``(word_dim, 3 heads head_dim)`` matrix ``[Q | K | V]``, head
  k in columns ``k head_dim .. (k + 1) head_dim`` of each third;
  ``alpha = softmax_s((e_t Q_k) . (e_s K_k) / sqrt(head_dim))`` over the
  title's words and ``h_t = concat_k sum_s alpha e_s V_k``. Then additive
  pooling: ``a_t = q . tanh(h_t W + b)``, ``beta = softmax(a)`` over the
  words, ``r = sum_t beta_t h_t``. A title with no word gives ``r = 0``.
- User encoder: the same kind of attention (``heads x head_dim`` on the
  news vectors, no bias) over the history's news vectors, masked at
  padding (article id 0), then an additive pooling of its own: ``u``. An
  empty history gives ``u = 0``.
- Scores: ``u . r_c`` for each candidate ``c`` of a row.

Padding is masked in both attentions and both poolings (the paper does not
say): a masked position's score is -1e9 before the softmax, so beside a
real one it weighs exactly 0. The port trains without dropout (the paper's
0.2): a config that asks for it is refused.

A batch carries the history ``hist`` (B, H) of article ids and the
candidates ``item_id``: (B, C) gives (B, C) logits (a training row of 1 + K
candidates, the positive first, for the listwise loss of
:mod:`..training.dense_step`), (B,) gives (B,) logits (one (user, article)
pair a row, as ``Trainer.predict`` and ``validate`` score). While a step
records its spans (:mod:`..utils.profiling`), the forward records
``train.step.news`` (the title gather, the word lookup, the attention and
the pooling of all B (H + C) slots), ``train.step.user`` and
``train.step.score``, and on ``train.step.news`` the counts
``nrms.titles.slots`` (B (H + C)), ``nrms.titles.real`` (slots that are not
padding) and ``nrms.titles.distinct`` (distinct real articles), the last
two computed when the spans are read.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ops.mhsa import masked_mhsa, masked_softmax
from ..utils.profiling import active, count, span
from .embedding import distinct_real_rows, real_titles

NOTHING = contextlib.nullcontext()


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class SelfAttention(nn.Module):
    """Multi-head self-attention without bias: ``wqkv`` is ``[Q | K | V]``,
    (dim_in, 3 heads head_dim), (in, out) as the port's attention layers;
    its core on the packed ``x @ wqkv`` is :func:`..ops.mhsa.masked_mhsa`
    (a kernel pair on the card, the library chain on the CPU)."""

    def __init__(self, dim_in: int, heads: int, head_dim: int, generator=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.wqkv = _uniform((dim_in, 3 * heads * head_dim), 1.0 / math.sqrt(dim_in), generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(N, L, dim_in), mask (N, L) -> (N, L, heads head_dim)."""
        return masked_mhsa(x @ self.wqkv, mask, self.heads)


class AdditivePool(nn.Module):
    """``a = q . tanh(h W + b)``, ``beta = softmax(a)`` over the unmasked
    positions, ``sum beta h``; zero where nothing is unmasked."""

    def __init__(self, dim: int, query_dim: int, generator=None):
        super().__init__()
        self.w = _uniform((dim, query_dim), 1.0 / math.sqrt(dim), generator)
        self.b = _uniform((query_dim,), 1.0 / math.sqrt(dim), generator)
        self.q = _uniform((query_dim,), 1.0 / math.sqrt(query_dim), generator)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(N, L, D), mask (N, L) -> (N, D)."""
        a = torch.tanh(h @ self.w + self.b) @ self.q
        beta = masked_softmax(a, mask)
        pooled = torch.einsum("nl,nld->nd", beta, h)
        return pooled * mask.any(dim=1, keepdim=True).to(h.dtype)


class NewsEncoder(nn.Module):
    def __init__(self, vocab: int, word_dim: int, heads: int, head_dim: int, query_dim: int,
                 init_scale: float = 1.0, generator=None):
        super().__init__()
        words = torch.empty(vocab, word_dim).normal_(0.0, init_scale, generator=generator)
        words[0] = 0.0
        self.words = nn.Parameter(words)
        self.attn = SelfAttention(word_dim, heads, head_dim, generator)
        self.pool = AdditivePool(heads * head_dim, query_dim, generator)

    def forward(self, words: torch.Tensor) -> torch.Tensor:
        """Titles' word ids (..., L) -> news vectors (..., heads head_dim)."""
        lead, L = words.shape[:-1], words.shape[-1]
        words = words.reshape(-1, L)
        mask = words != 0
        h = self.attn(F.embedding(words, self.words), mask)
        return self.pool(h, mask).view(*lead, -1)


class UserEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, query_dim: int, generator=None):
        super().__init__()
        self.attn = SelfAttention(dim, heads, head_dim, generator)
        self.pool = AdditivePool(heads * head_dim, query_dim, generator)

    def forward(self, news: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The history's news vectors (B, H, D), mask (B, H) -> (B, D)."""
        return self.pool(self.attn(news, mask), mask)


class NRMSRanker(nn.Module):
    """NRMS over the title table ``titles`` (set it with :meth:`set_titles`;
    it is part of the model's state, so checkpoints carry it)."""

    # the JAX package has no NRMS: ``model_info.log`` lists the port's names
    flax_paths = False

    def __init__(self, articles: int, title_len: int, vocab: int, word_dim: int, heads: int,
                 head_dim: int, query_dim: int, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.articles = articles
        self.news = NewsEncoder(vocab, word_dim, heads, head_dim, query_dim, init_scale,
                                generator)
        self.user = UserEncoder(heads * head_dim, heads, head_dim, query_dim, generator)
        self.register_buffer("titles", torch.zeros(articles, title_len, dtype=torch.int32))

    def set_titles(self, table) -> None:
        """Copy the (articles, title_len) word-id table into ``titles``."""
        table = torch.as_tensor(table)
        if tuple(table.shape) != tuple(self.titles.shape):
            raise ValueError(f"a title table of {tuple(table.shape)}; the model holds "
                             f"{tuple(self.titles.shape)}")
        with torch.no_grad():
            self.titles.copy_(table)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        hist = batch["hist"].long()
        cand = batch["item_id"].long()
        single = cand.dim() == 1
        if single:
            cand = cand[:, None]
        H = hist.shape[1]
        ids = torch.cat([hist, cand], dim=1)
        recording = active() and torch.is_grad_enabled()
        with span("train.step.news") if recording else NOTHING:
            if recording:
                count("nrms.titles.slots", ids.numel())
                count("nrms.titles.real", partial(real_titles, ids, self.articles))
                count("nrms.titles.distinct", partial(distinct_real_rows, ids, self.articles))
            r = self.news(self.titles[ids])
        with span("train.step.user") if recording else NOTHING:
            u = self.user(r[:, :H], hist != 0)
        with span("train.step.score") if recording else NOTHING:
            logits = torch.einsum("bd,bcd->bc", u, r[:, H:])
        return logits[:, 0] if single else logits


def build_nrms(cfg: Config, *, seed: int = 0) -> NRMSRanker:
    """The NRMS of ``cfg``'s ``nrms_cfg`` (``articles``, ``title_len``,
    ``vocab``, ``word_dim``, ``num_heads``, ``head_dim``, ``query_dim``,
    ``dropout``), its parameters drawn from ``seed`` (words N(0,
    ``embeddings.init_scale``) with row 0 zero, every other weight
    U(+-1/sqrt(fan_in))), on the CPU, with an empty title table."""
    n = cfg.extra("nrms_cfg")
    if not n:
        raise ValueError("nrms needs an nrms_cfg section (zoo.mind_nrms_config)")
    if float(n.get("dropout", 0.0)) != 0.0:
        raise ValueError(f"the port trains NRMS without dropout; got dropout={n['dropout']}")
    return NRMSRanker(
        articles=int(n["articles"]), title_len=int(n["title_len"]), vocab=int(n["vocab"]),
        word_dim=int(n["word_dim"]), heads=int(n["num_heads"]), head_dim=int(n["head_dim"]),
        query_dim=int(n["query_dim"]), init_scale=cfg.embeddings.init_scale,
        generator=torch.Generator().manual_seed(seed))
