"""NRMS's work counted from its configuration's shapes alone
(``benchmark/configs/mind-nrms.json``'s ``model`` and ``train``), so that
it counts the same work whatever implements it. A matrix product counts
2 M N K; a title of L words at width D, W = heads x head_dim and query Q:

- the Q/K/V projection 2 L D 3W; the scores and the weighted values
  4 heads L^2 head_dim; the additive pooling 2 L W Q + 2 L Q + 2 L W;
- the user encoder the same over the history's H vectors of width W;
- a row's scores 2 C W, C = 1 + npratio candidates.

A training row counts its forward three times (the forward, and the
backward's two products for each of the forward's). The news encoder
runs on every slot of a row, H + C titles, padding included: the shapes
the program runs (``titles_useful_pct`` says how many are real and
distinct). Everything runs in float32 (TF32 off).
"""

from __future__ import annotations


def _dims(config: dict) -> tuple:
    m = config["model"]
    return (m["title_len"], m["word_dim"], m["num_heads"], m["head_dim"], m["query_dim"],
            m["history_len"], 1 + m["npratio"])


def encoder_flops(L: int, D: int, heads: int, hd: int, Q: int) -> int:
    """One sequence of L vectors of width D through attention and pooling."""
    W = heads * hd
    return 2 * L * D * 3 * W + 4 * heads * L * L * hd + 2 * L * W * Q + 2 * L * Q + 2 * L * W


def title_flops(config: dict) -> int:
    L, D, heads, hd, Q, _, _ = _dims(config)
    return encoder_flops(L, D, heads, hd, Q)


def slots(config: dict) -> int:
    """Titles encoded a row."""
    *_, H, C = _dims(config)
    return H + C


def row_flops(config: dict) -> int:
    """A row's forward: its titles, the user encoder, the scores."""
    L, D, heads, hd, Q, H, C = _dims(config)
    W = heads * hd
    return slots(config) * title_flops(config) + encoder_flops(H, W, heads, hd, Q) + 2 * C * W


def news_bytes(config: dict, titles: int) -> int:
    """The news encoder's least bytes for ``titles`` titles: the word rows
    read, the word ids and article ids read, its weights read once, the
    news vectors written (float32, int32)."""
    L, D, heads, hd, Q, _, _ = _dims(config)
    W = heads * hd
    weights = D * 3 * W + W * Q + 2 * Q
    return 4 * (titles * (L * D + L + 1 + W) + weights)


def least_time(config: dict, flops: float, nbytes: float = 0.0) -> float:
    """The larger of the FLOPs at the float32 peak and the bytes at HBM's."""
    peaks = config["peaks"]
    return max(flops / peaks["float32_flops"], nbytes / peaks["hbm_bytes"])
