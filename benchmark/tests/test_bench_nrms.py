"""The NRMS cell ``nrms.train-b64`` on the CPU: the benchmark's reference
against the tests' (``tests/nrms_reference.py``) on seeded weights; a run
of the cell at batch 8 (every width as the configuration states) reads
correct, and reads not correct with half of each history left unencoded
or with padding unmasked; a program without NRMS stops at once; the
launch attribution and the new readers on made-up inputs."""

import os
import sys

import numpy as np
import pytest
import torch

from harness import cli, launches, spec, weights
from metrics import news_roofline, nrms_mfu_pct, nrms_shapes, titles_useful_pct
from reference import nrms as ref
from traffic import train_impressions

from news_recsys_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(spec.ROOT, "tests"))
import nrms_reference as tests_ref  # noqa: E402

CELL = "nrms.train-b64"
CPU = torch.device("cpu")
SMALL = dict(articles=50, users=80, vocab=120, word_dim=20, num_heads=4, head_dim=4,
             query_dim=6, title_len=9, history_len=7, npratio=4, init_scale=1.0)


def small_config() -> dict:
    conf = spec.config("mind-nrms")
    conf["model"] = dict(conf["model"], **SMALL)
    conf["titles"]["mean_words"] = 4
    return conf


def test_benchmark_reference_matches_the_tests_reference():
    conf = small_config()
    params = weights.draw(ref.param_specs(conf), 11, CPU)
    titles = torch.from_numpy(train_impressions.titles(conf, 11))
    g = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        hist = g.integers(1, 50, (6, 7))
        hist[np.arange(7)[None, :] >= g.integers(0, 8, 6)[:, None]] = 0
        label = np.zeros((6, 5), np.float32)
        label[:, 0] = 1
        batches.append({"hist": torch.from_numpy(hist), "label": torch.from_numpy(label),
                        "item_id": torch.from_numpy(g.integers(1, 50, (6, 5)))})
    b = batches[0]
    want = tests_ref.logits(params, titles, b["hist"], b["item_id"], 4, 4)
    assert torch.equal(ref.logits(params, conf["model"], titles, b["hist"], b["item_id"]), want)
    got = ref.first_steps(params, conf, titles, batches)
    out = tests_ref.adam_steps(params, titles, batches, 4, 4, lr=conf["train"]["lr"])
    assert got["losses"] == out["losses"]
    for n, p in out["params"].items():
        assert got["change_norms"][n] == float(torch.linalg.vector_norm((p - params[n]).double()))


def small_run(monkeypatch, trace: int = 0, seconds: float = 1.0) -> dict:
    """The cell at batch 8, 6 steps an epoch."""
    workload, config = spec.workload, spec.config

    def cell(name):
        c = workload(name)
        c["params"].update(steps_per_epoch=6, warmup_steps=4, trace_steps=2)
        return c

    def conf(name):
        c = config(name)
        c["program"]["ranker"] = ["mind_nrms_config", 8]
        c["train"]["batch_size"] = 8
        return c

    monkeypatch.setattr(spec, "workload", cell)
    monkeypatch.setattr(spec, "config", conf)
    args = cli.parse(["--workload", CELL, "--seed", "3000000019", "--seconds", str(seconds),
                      "--trace", str(trace)])
    return cli.run(args, device=CPU)


def test_sound_run_is_correct_and_traced_run_reports_the_span_metrics(monkeypatch):
    profiling.clear()
    try:
        res = small_run(monkeypatch, trace=1)
    finally:
        profiling.clear()
    assert res["correct"] is True, res["checks"]
    _, layers = spec.cell_metrics(spec.benchmark(), CELL)
    cpu_readable = {"span_ms.train.step", "span_ms.train.step.forward",
                    "span_ms.train.step.backward", "span_ms.train.step.adamw",
                    "span_ms.train.batch", "span_ms.train.step.news", "span_ms.train.step.user",
                    "span_ms.train.step.score", "nrms_mfu_pct.train", "titles_useful_pct.train"}
    assert cpu_readable <= {m["name"] for m in layers}
    assert set(res["metrics"]) == cpu_readable          # no device trace on the CPU
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["metrics"]["titles_useful_pct.train"]["value"] < 100


def test_history_half_unencoded_is_not_correct(monkeypatch):
    from news_recsys_tpu_torch.models import nrms

    from tools.calibrate_nrms import halved

    monkeypatch.setattr(nrms.NRMSRanker, "forward", halved(nrms.NRMSRanker.forward))
    res = small_run(monkeypatch)
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]


def test_padding_unmasked_is_not_correct(monkeypatch):
    from news_recsys_tpu_torch.models import nrms

    monkeypatch.setattr(nrms, "masked_softmax", lambda scores, mask: torch.softmax(scores, -1))
    res = small_run(monkeypatch)
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]


def test_a_program_without_nrms_stops_at_once(monkeypatch):
    from news_recsys_tpu_torch import zoo

    monkeypatch.delattr(zoo, "mind_nrms_config")
    with pytest.raises(AttributeError):
        small_run(monkeypatch)


def test_rows_follow_the_law():
    conf = spec.config("mind-nrms")
    law = spec.workload(CELL)["params"]["law"]
    w = train_impressions.world(conf, 12345, law)
    rows = train_impressions.training_rows(w, conf, 640, 12345)
    assert rows["hist"].shape == (640, 50) and rows["item_id"].shape == (640, 5)
    assert rows["label"][:, 0].sum() == 640 and rows["label"][:, 1:].sum() == 0
    assert rows["item_id"].min() >= 1 and rows["item_id"].max() < conf["model"]["articles"]
    n = (rows["hist"] != 0).sum(axis=1)
    assert n.max() <= 50 and (n == 0).any()
    assert ((rows["hist"] != 0) == (np.arange(50)[None, :] < n[:, None])).all()
    table = train_impressions.titles(conf, 12345)
    words = (table[1:] != 0).sum(axis=1)
    assert table.shape == (65239, 30) and (table[0] == 0).all()
    assert words.min() >= 1 and words.max() <= 30 and 10.5 < words.mean() < 11.5
    assert table.max() < conf["model"]["vocab"]


def test_launches_are_attributed_to_the_span_open_at_their_call():
    ev = lambda cat, name, ts, dur, tid=1, **args: {"ph": "X", "cat": cat, "name": name, "ts": ts,
                                                    "dur": dur, "pid": 1, "tid": tid,
                                                    "args": args}
    events = [ev("user_annotation", "train.step.news", 0, 10),
              ev("user_annotation", "train.step.news", 100, 10),
              ev("user_annotation", "train.step.user", 10, 5),
              ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
              ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
              ev("cuda_driver", "cuLaunchKernel", 105, 1, correlation=3),
              ev("cuda_runtime", "cudaLaunchKernel", 106, 1, tid=2, correlation=4),
              ev("kernel", "gemm", 50, 20, tid=7, correlation=1),
              ev("kernel", "softmax", 60, 4, tid=7, correlation=2),
              ev("kernel", "gather", 150, 6, tid=7, correlation=3),
              ev("kernel", "other", 160, 6, tid=7, correlation=4)]
    out = launches.attribute(events, ["train.step.news", "train.step.user", "train.step.score"])
    assert out["train.step.news"] == {"ranges": 2, "kernels": 2, "seconds": pytest.approx(26e-6)}
    assert out["train.step.user"] == {"ranges": 1, "kernels": 1, "seconds": pytest.approx(4e-6)}
    assert "train.step.score" not in out


class Ctx:
    def __init__(self, profile=None, rate=None):
        self.config = spec.config("mind-nrms")
        self.profile, self.untraced = profile, {"examples_per_s": rate} if rate else {}


def test_readers_on_made_up_readings(monkeypatch):
    conf = spec.config("mind-nrms")
    row = nrms_shapes.row_flops(conf)
    assert nrms_shapes.slots(conf) == 55
    assert nrms_shapes.title_flops(conf) == 17_844_960
    assert 1.00e9 < row < 1.01e9
    assert nrms_mfu_pct.read(Ctx(rate=1000.0), "nrms_mfu_pct.train") == pytest.approx(
        100 * 3 * row * 1000 / 67e12)
    assert nrms_mfu_pct.read(Ctx(), "nrms_mfu_pct.train") is None
    once = nrms_shapes.least_time(conf, 3520 * nrms_shapes.title_flops(conf),
                                  nrms_shapes.news_bytes(conf, 3520))
    prof = {"span_kernels": {"train.step.news": {"ranges": 4, "kernels": 80, "seconds": 0.01}}}
    assert news_roofline.read(Ctx(prof), "news_roofline.train") == pytest.approx(
        100 * 4 * once / 0.01)
    assert news_roofline.read(Ctx({"span_kernels": {}}), "news_roofline.train") is None
    rec = lambda i, **c: profiling.SpanRecord("train.step.news", i, None, i, 1, 0, 1, c)
    monkeypatch.setattr(profiling, "recorded", lambda: profiling.Recorded(
        [rec(0, **{"nrms.titles.slots": 3520, "nrms.titles.distinct": 1800}),
         rec(1, **{"nrms.titles.slots": 3520, "nrms.titles.distinct": 1700})], 0))
    assert titles_useful_pct.read(None, "titles_useful_pct.train") == pytest.approx(
        100 * 3500 / 7040)
