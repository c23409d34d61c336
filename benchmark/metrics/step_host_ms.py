"""``step_host_ms.train``: the host's time to issue one ``train_step`` call
(the span the harness wraps around ``Trainer.train_step``, no sync), the
mean over the untraced first part of the traced run's window."""

from __future__ import annotations


def read(ctx, name: str):
    calls = ctx.spans.between("train_step", ctx.untraced["t0"], ctx.untraced["t1"])
    return 1e3 * sum(calls) / len(calls) if calls else None
