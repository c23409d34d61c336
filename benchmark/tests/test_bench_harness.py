"""The benchmark's files, found by name, against its contract; the imports
of what it runs; the result line's schema."""

import ast
import json
import os
import re

import pytest

from bench_cells import run_small
from harness import cli, spec

BENCH = spec.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "news_recsys_tpu"}


def bench():
    return spec.benchmark()


def test_benchmark_json_keys_and_names():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_files_found_by_name(cell):
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    w = spec.workload(cell)
    assert (w["config"], w["traffic"], w["why"]) == (entry["config"], entry["traffic"],
                                                     entry["why"])
    assert len(entry["why"]) <= 200 and entry["chips"] == 1
    assert hasattr(spec.driver(w["traffic"]), "run")
    conf = next(c for c in b["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    assert spec.config(w["config"])["source"] == conf["source"]
    e2e, layers = spec.cell_metrics(b, cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in [x["name"] for x in e2e]
        assert hasattr(spec.metric_reader(m["name"]), "read")
    assert set(w["limits"]) <= {"loss_gap", "grad_gap", "change_gap", "auc_gap", "feed_rows",
                                "missing", "bad_answers", "score_err", "rank_gap"}


def test_every_config_is_used():
    b = bench()
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["reduced"] == spec.config(c["name"])["reduced"] == []


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``news_recsys_tpu_torch`` is allowed,
    ``news_recsys_tpu`` is not."""
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "torch"}
    for path in _sources("reference"):
        assert _imports(path) <= allowed, (path, _imports(path))


def test_load_generator_imports_no_torch():
    for f in ("http_client.py", "inputs.py", "__init__.py"):
        assert "torch" not in _imports(os.path.join(BENCH, "harness", f)), f


def test_forbidden_modules_are_named_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "news_recsys_tpu_torch_x", sys)
    assert "news_recsys_tpu" not in cli.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "news_recsys_tpu.zoo", sys)
    assert "news_recsys_tpu" in cli.loaded_forbidden()


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--workload", "attention.train-b512", "--seed", "1", "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(monkeypatch, trace):
    res = run_small(monkeypatch, "attention.train-b512", trace=trace)
    json.dumps(res)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] >= 8 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    e2e, layers = spec.cell_metrics(bench(), "attention.train-b512")
    want = [m["name"] for m in (layers if trace else e2e)]
    # the CPU has no device trace: its readers find nothing and are left out
    assert set(res["metrics"]) <= set(want)
    if not trace:
        assert set(res["metrics"]) == set(want)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_trace_reduction_on_a_made_up_trace():
    from harness import trace

    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [k("a", 0, 10), k("b", 5, 10), k("a", 40, 10),
              {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 16, "dur": 20},
              {"ph": "X", "cat": "user_annotation", "name": "recall", "ts": 10, "dur": 50}]
    out = trace.reduce(events, 100e-6)
    assert {n: c for n, (c, _) in out["kernels"].items()} == {"a": 2, "b": 1}
    assert out["kernels"]["a"][1] == pytest.approx(20e-6)
    assert out["busy_s"] == pytest.approx(25e-6) and out["window_s"] == 100e-6
    assert [n for n, _ in out["idle_gaps"]] == ["recall / aten::sort"]
    assert out["idle_gaps"][0][1] == pytest.approx(25e-6)
    assert out["device_ops"][0][0] == "a"
