"""``mfu_pct.train`` and ``mfu_pct.batch``: the whole step's (a training
example's, or a cascade request's) share of the card's peak. Its FLOPs are
counted from the configuration's shapes (:mod:`metrics.shapes`), each units'
at its own peak, and taken at the rate of the untraced first part of the
traced run's window: examples a second, or requests a second as the spans
around ``CascadeRecommender.recommend`` count them."""

from __future__ import annotations

from metrics import shapes


def read(ctx, name: str):
    variant = name.split(".", 1)[1]
    if variant == "train":
        per, rate = shapes.train_flops(ctx.config), ctx.untraced.get("examples_per_s")
    else:
        t0, t1 = ctx.untraced["t0"], ctx.untraced["t1"]
        calls = ctx.spans.between("cascade", t0, t1)
        per = shapes.request_flops(ctx.config, ctx.params["users"])
        rate = len(calls) / (t1 - t0) if calls else None
    if not rate:
        return None
    return 100.0 * shapes.least_time(ctx.config, per) * rate
