"""``titles_useful_pct.train``: the share of the title slots that NRMS's
news encoder runs over that hold a distinct real article: 100 x the sum of
the program's ``nrms.titles.distinct`` counts over the sum of its
``nrms.titles.slots`` counts (batch x (history + candidates) a step),
over the recorded steps. Recorded under the profiler, as ``span_ms``; None
where nothing was counted."""

from __future__ import annotations

from metrics import span_ms


def read(ctx, name: str):
    spans = span_ms.recorded() or []
    slots = sum(s.counts.get("nrms.titles.slots", 0) for s in spans)
    distinct = sum(s.counts.get("nrms.titles.distinct", 0) for s in spans)
    return 100.0 * distinct / slots if slots else None
