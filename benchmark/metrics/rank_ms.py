"""``rank_ms.<variant>``: ``CascadeRecommender.recommend``'s self time a
request (the candidate join, the ranker's forward, the order by score and
the sigmoid loop): its span's mean less the recall span's mean, over the
untraced first part of the traced run's window."""

from __future__ import annotations


def read(ctx, name: str):
    t0, t1 = ctx.untraced["t0"], ctx.untraced["t1"]
    casc, recall = ctx.spans.between("cascade", t0, t1), ctx.spans.between("recall", t0, t1)
    if not casc or not recall:
        return None
    return 1e3 * (sum(casc) / len(casc) - sum(recall) / len(recall))
