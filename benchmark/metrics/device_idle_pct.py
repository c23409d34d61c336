"""``device_idle_pct.<variant>``: the share of the profiled window in which
no kernel, copy or memset ran on the card (the union of their intervals in
the ``torch.profiler`` trace, over the window's length on the host clock)."""

from __future__ import annotations


def read(ctx, name: str):
    prof = ctx.profile
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
