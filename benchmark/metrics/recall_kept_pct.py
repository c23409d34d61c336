"""``recall_kept_pct.<variant>``: the share of the ids that recall's top-k
search fetched which its history dedup kept: 100 x the sum of the program's
``recall.kept`` counts over the sum of its ``recall.fetched`` counts (users
times the ``fetch`` asked for), over the recorded requests. Recorded under
the profiler, as ``span_ms``; None where nothing was counted."""

from __future__ import annotations

from metrics import span_ms


def read(ctx, name: str):
    spans = span_ms.recorded() or []
    kept = sum(s.counts.get("recall.kept", 0) for s in spans)
    fetched = sum(s.counts.get("recall.fetched", 0) for s in spans)
    return 100.0 * kept / fetched if fetched else None
