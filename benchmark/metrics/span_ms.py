"""``span_ms.<span>``: the program's own span ``<span>``
(``news_recsys_tpu_torch.utils.profiling.span``), its summed time over the
recorded trees over the number of recorded steps (``train.step`` spans, for
``train.*`` names) or requests (``serve.request`` spans, for ``serve.*``
names). The program records only while a profiler session runs, so this is
a reading of the traced part of the window, under the profiler's per-op
cost. None where the program records no such span (a program without the
recorder, or nothing recorded) or its store dropped any."""

from __future__ import annotations

UNITS = {"train": "train.step", "serve": "serve.request"}


def recorded():
    """The program's recorded spans, or None where it has no recorder or its
    store dropped any."""
    try:
        from news_recsys_tpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return None
    rec = program_recorded()
    return None if rec.dropped else rec.spans


def read(ctx, name: str):
    target = name.split(".", 1)[1]
    unit = UNITS.get(target.split(".")[0])
    spans = recorded()
    if unit is None or not spans:
        return None
    n = sum(s.name == unit for s in spans)
    took = [s.end_ns - s.start_ns for s in spans if s.name == target]
    return 1e-6 * sum(took) / n if n and took else None
