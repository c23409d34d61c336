"""``nrms_mfu_pct.train``: an NRMS training row's share of the card's
float32 peak: its FLOPs from shapes (:mod:`metrics.nrms_shapes`, the
forward three times) at the rows a second of the untraced first part of
the traced run's window."""

from __future__ import annotations

from metrics import nrms_shapes


def read(ctx, name: str):
    rate = ctx.untraced.get("examples_per_s")
    if not rate or "model" not in ctx.config:
        return None
    flops = 3 * nrms_shapes.row_flops(ctx.config)
    return 100.0 * nrms_shapes.least_time(ctx.config, flops) * rate
