"""The readers of the program's own spans and counts (``span_ms``,
``rows_useful_pct``, ``recall_kept_pct``): on a made-up store, and in a
traced run of each cell on the CPU."""

import pytest

from bench_cells import run_small
from harness import spec
from metrics import recall_kept_pct, rows_useful_pct, span_ms

from news_recsys_tpu_torch.utils import profiling

NEW = {"span_ms", "rows_useful_pct", "recall_kept_pct"}


def made_up(monkeypatch, spans, dropped=0):
    monkeypatch.setattr(profiling, "recorded", lambda: profiling.Recorded(spans, dropped))


def rec(name, i, parent, ms, **counts):
    return profiling.SpanRecord(name, i, parent, 0, 1, 0, int(ms * 1e6), counts)


def store():
    """Two steps of 4 and 6 ms (gather 1 + 2 ms), two requests, one epoch."""
    return [rec("train.epoch", 0, None, 20),
            rec("train.step", 1, 0, 4), rec("train.step.gather", 2, 1, 1),
            rec("train.step.table_update", 3, 1, 2, **{
                "rows.distinct.item_id": 50, "rows.passed.item_id": 1000,
                "rows.distinct.user_id": 30, "rows.passed.user_id": 40}),
            rec("train.step", 4, 0, 6), rec("train.step.gather", 5, 4, 2),
            rec("train.step.table_update", 6, 4, 2, **{
                "rows.distinct.item_id": 70, "rows.passed.item_id": 1000}),
            rec("train.batch", 7, 0, 0.5), rec("train.batch", 8, 0, 0.25),
            rec("serve.request", 9, None, 10), rec("serve.recall", 10, 9, 4,
                                                  **{"recall.fetched": 120,
                                                     "recall.kept": 100}),
            rec("serve.request", 11, None, 30), rec("serve.recall", 12, 11, 8,
                                                   **{"recall.fetched": 240,
                                                      "recall.kept": 200}),
            rec("serve.parse", 13, 11, 3)]


def test_readers_on_a_made_up_store(monkeypatch):
    made_up(monkeypatch, store())
    assert span_ms.read(None, "span_ms.train.step") == pytest.approx(5.0)
    assert span_ms.read(None, "span_ms.train.step.gather") == pytest.approx(1.5)
    assert span_ms.read(None, "span_ms.train.batch") == pytest.approx(0.375)
    assert span_ms.read(None, "span_ms.serve.recall") == pytest.approx(6.0)
    assert span_ms.read(None, "span_ms.serve.parse") == pytest.approx(1.5)
    assert span_ms.read(None, "span_ms.serve.reply") is None
    assert span_ms.read(None, "span_ms.other.step") is None
    assert rows_useful_pct.read(None, "rows_useful_pct.train") == pytest.approx(
        100 * 150 / 2040)
    assert recall_kept_pct.read(None, "recall_kept_pct.batch") == pytest.approx(100 * 300 / 360)


@pytest.mark.parametrize("spans,dropped", [([], 0), (store(), 1)])
def test_readers_find_nothing_on_an_empty_or_overflowed_store(monkeypatch, spans, dropped):
    made_up(monkeypatch, spans, dropped)
    assert span_ms.read(None, "span_ms.train.step") is None
    assert span_ms.read(None, "span_ms.serve.recall") is None
    assert rows_useful_pct.read(None, "rows_useful_pct.train") is None
    assert recall_kept_pct.read(None, "recall_kept_pct.batch") is None


def test_readers_find_nothing_in_a_program_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    assert span_ms.read(None, "span_ms.train.step") is None
    assert rows_useful_pct.read(None, "rows_useful_pct.train") is None


@pytest.mark.parametrize("cell", ["attention.train-b512", "attention.serve-1024u"])
def test_traced_run_reports_every_new_metric(monkeypatch, cell):
    """On a card ``Recommender``'s ``auto`` backend searches on the device
    (``serve.recall.search.wait`` waits for it); on the CPU it would take the
    host searcher, so this run asks for the device searcher too."""
    from news_recsys_tpu_torch import serving

    init = serving.Recommender.__init__
    monkeypatch.setattr(serving.Recommender, "__init__",
                        lambda self, *a, **kw: init(self, *a, **{**kw, "backend": "device"}))
    profiling.clear()
    try:
        res = run_small(monkeypatch, cell, seconds=2.0, trace=1)
    finally:
        profiling.clear()
    _, layers = spec.cell_metrics(spec.benchmark(), cell)
    want = {m["name"] for m in layers if m["name"].split(".")[0] in NEW}
    assert len(want) == (10 if cell.startswith("attention.train") else 12)
    assert want <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in want)
    assert res["correct"] is True
