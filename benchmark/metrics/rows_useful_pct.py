"""``rows_useful_pct.<variant>``: the share of the rows that the sparse
step's table updates pass over which they change, over every large table
and recorded step: 100 x the sum of the program's ``rows.distinct.<table>``
counts over the sum of its ``rows.passed.<table>`` counts (a dense-route
update passes over the whole padded table, a row route over its slots).
Recorded under the profiler, as ``span_ms``; None where nothing was counted."""

from __future__ import annotations

from metrics import span_ms


def read(ctx, name: str):
    spans = span_ms.recorded() or []
    sums = {"rows.distinct.": 0, "rows.passed.": 0}
    for s in spans:
        for key, value in s.counts.items():
            for prefix in sums:
                if key.startswith(prefix):
                    sums[prefix] += value
    passed = sums["rows.passed."]
    return 100.0 * sums["rows.distinct."] / passed if passed else None
