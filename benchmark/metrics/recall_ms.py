"""``recall_ms.<variant>``: the mean time of ``Recommender.recommend`` a
request (the user tower, the top-k search, the host's history dedup loop),
from the spans of the untraced first part of the traced run's window."""

from __future__ import annotations


def read(ctx, name: str):
    calls = ctx.spans.between("recall", ctx.untraced["t0"], ctx.untraced["t1"])
    return 1e3 * sum(calls) / len(calls) if calls else None
