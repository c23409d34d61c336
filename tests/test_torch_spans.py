"""The port's spans and counters (``utils/profiling.py``): when a tree
records, what the sparse step, the all-dense step, NRMS's forward, the
epoch loop and a served request record,
the table updates' row counts against numpy, that recording changes no bit
of training, and the spans in ``trace()``'s file.

Imports nothing of the JAX package. The card's test of the recorder (no
device sync from a count) is ``tests/test_torch_cuda.py::
test_recorded_steps_add_no_device_sync``.
"""

import contextlib
import dataclasses
import glob
import gzip
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from news_recsys_tpu_torch import serving, zoo
from news_recsys_tpu_torch.config import config_from_dict
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.embedding import offset_ids
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.trainer import AucHist, PackedDataset, Trainer
from news_recsys_tpu_torch.utils import profiling

torch.set_num_threads(2)

STEP_PARTS = ["train.step.gather", "train.step.forward", "train.step.backward",
              "train.step.adamw", "train.step.rows", "train.step.table_update",
              "train.step.auc"]
B = 64


@pytest.fixture(autouse=True, scope="module")
def profiler_ready():
    """With a card, ``trace()`` traces it too: as ``tests/test_torch_cuda.py::
    profiler_ready`` does, the kernel library is built and one short session
    traces one small kernel before any session of this file, so that no
    session here is the process's long first one, after which later sessions
    lose their kernels."""
    if torch.cuda.is_available():
        from news_recsys_tpu_torch.ops import _build

        _build.library()
        x = torch.zeros(1, device="cuda")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            x.add_(1)
            torch.cuda.synchronize()


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


# -- the recorder --------------------------------------------------------------


def test_profiler_sets_the_flag_the_recorder_reads():
    """The recorder turns on with a profiler session through PyTorch's own
    flag: this fails if PyTorch stops setting it."""
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        with profiling.span("a"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    assert [s.name for s in profiling.recorded().spans] == ["a"]


def test_root_decides_for_its_tree():
    """A tree records by what held at its root's entry, to its end; a count
    lands on the innermost recorded span, summed by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with profiling.span("quiet_root"):
        with torch.profiler.profile(activities=acts):
            with profiling.span("quiet_child"):
                profiling.count("n", 1)
                assert not profiling.active()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    with profiling.span("root"):
        prof.stop()
        with profiling.span("child"):
            profiling.count("n", 2)
            profiling.count("n", 3)
        profiling.count("m", 5)
    rec = profiling.recorded()
    assert rec.dropped == 0
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"root", "child"}
    assert by["child"].parent == by["root"].id and by["child"].root == by["root"].id
    assert by["root"].parent is None and by["root"].root == by["root"].id
    assert by["child"].counts == {"n": 5} and by["root"].counts == {"m": 5}
    assert by["root"].start_ns <= by["child"].start_ns <= by["child"].end_ns <= by["root"].end_ns


def test_a_count_function_runs_only_when_the_spans_are_read():
    """A count given as a function is kept, summed with the span's other
    counts of its name, and called once, by ``recorded()``: where the span
    runs nothing is computed."""
    calls = []

    def later(v):
        def f():
            calls.append(v)
            return torch.tensor([v, 0]).sum()
        return f

    with profiling.recording():
        with profiling.span("root"):
            profiling.count("n", later(3))
            profiling.count("n", 4)
            profiling.count("n", later(5))
            profiling.count("m", 1)
    assert calls == []
    (s,) = profiling.recorded().spans
    assert sorted(calls) == [3, 5] and s.counts == {"n": 12, "m": 1}
    assert all(type(v) is int for v in s.counts.values())
    profiling.recorded()
    assert sorted(calls) == [3, 5]


def test_recording_without_a_profiler_and_the_store_bound(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(2):
            with profiling.span("r"):
                with profiling.span("c"):
                    profiling.count("x", 1)
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["c", "r", "c"]
    assert rec.dropped == 1
    profiling.clear()
    assert profiling.recorded() == ([], 0)


def test_the_store_bounds_the_counts_left_to_it(monkeypatch):
    """At most ``MAX_LATER`` counts wait for ``recorded()`` (each may hold a
    tensor alive); a span past that keeps its host counts and drops, and
    counts, the rest; reading makes room again."""
    monkeypatch.setattr(profiling, "MAX_LATER", 3)
    with profiling.recording():
        for i in range(3):
            with profiling.span("s"):
                profiling.count("later", lambda: 1)
                profiling.count("also", lambda: 2)
                profiling.count("host", i)
    rec = profiling.recorded()
    assert [s.counts for s in rec.spans] == [{"later": 1, "also": 2, "host": 0},
                                             {"host": 1}, {"host": 2}]
    assert rec.dropped == 4
    with profiling.recording():
        with profiling.span("s"):
            profiling.count("later", lambda: 7)
    assert profiling.recorded().spans[-1].counts == {"later": 7}


def test_threads_lose_no_span(monkeypatch):
    """Threads that record at once, more of them than cores, with the
    interpreter switching threads as often as it can: every span is kept
    or counted as dropped, and each tree stays on its thread."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 500)
    threads, each = 2 * (os.cpu_count() or 1) + 2, 40

    def work():
        for _ in range(each):
            with profiling.span("r"):
                with profiling.span("c"):
                    profiling.count("x", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    rec = profiling.recorded()
    assert len(rec.spans) == 500
    kept_counts = sum(len(s.counts) for s in rec.spans)
    assert len(rec.spans) + rec.dropped == 2 * threads * each + threads * each - kept_counts
    roots = {s.id: s for s in rec.spans if s.parent is None}
    for s in rec.spans:
        if s.parent in roots:
            assert roots[s.parent].thread == s.thread


# -- the sparse step and the epoch loop ----------------------------------------


def attention_cfg(**mesh):
    cfg = zoo.attention_config(batch_size=B)
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, **mesh)) if mesh else cfg


def batches(n, seed=5):
    arrays = zoo.attention_arrays(n * B, seed=seed)
    return [{k: torch.from_numpy(v[i * B:(i + 1) * B]) for k, v in arrays.items()}
            for i in range(n)]


def stepper(cfg, seed=0):
    model = build_ranker(cfg, seed=seed, device="cpu")
    return model, tss.make_sparse_train_step(model, cfg), tss.init_sparse_state(model, cfg)


def test_nothing_records_without_a_profiler():
    """Off, a sparse step and a served request record nothing, and every span
    is the one shared context."""
    assert profiling.span("a") is profiling.span("b")
    _, step, state = stepper(attention_cfg())
    step(state, batches(1)[0], AucHist.zeros("cpu"))
    stacks = serving_stacks()
    stacks.recommend(users(4), k=5)
    assert profiling.recorded() == ([], 0)


def test_sparse_step_records_its_seven_parts_in_order():
    _, step, state = stepper(attention_cfg())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batches(1)[0], AucHist.zeros("cpu"))
    spans = profiling.recorded().spans
    (root,) = [s for s in spans if s.name == "train.step"]
    assert root.parent is None and state.step == 1
    parts = children(spans, root)
    assert [s.name for s in parts] == STEP_PARTS
    assert len(spans) == 1 + len(STEP_PARTS)
    for s in parts:
        assert s.root == root.id and s.thread == root.thread
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for a, b in zip(parts, parts[1:]):
        assert a.end_ns <= b.start_ns
    counts = next(s for s in parts if s.name == "train.step.table_update").counts
    assert set(counts) == {f"{k}.{t}" for k in ("rows.passed", "rows.distinct")
                           for t in ("item_id", "user_id")}


@pytest.mark.parametrize("route", ["dense", "sorted", "unique"])
def test_row_counts_match_numpy(monkeypatch, route):
    """Each large table's ``rows.distinct`` is the batch's distinct valid
    ids, on the dense route, the sorted route and the unique-row (bfloat16)
    one, computed only when the spans are read; ``rows.passed`` is the whole
    table on the dense route and the batch's slots elsewhere."""
    monkeypatch.setattr(tss, "DENSE_UPDATE_MIN_SHARE", 0.0 if route == "dense" else 2.0)
    cfg = attention_cfg(param_dtype="bfloat16") if route == "unique" else attention_cfg()
    model, step, state = stepper(cfg)
    batch = batches(1, seed=7)[0]
    batch["hist"][:3, 5:] = 0
    batch["hist"][0, :4] = batch["item_id"][0]            # duplicates across features
    with profiling.recording():
        step(state, batch, AucHist.zeros("cpu"))
    (kept,) = [s for s in profiling._store if s.name == "train.step.table_update"]
    assert all(callable(v) == k.startswith("rows.distinct.") for k, v in kept.counts.items())
    (upd,) = [s for s in profiling.recorded().spans if s.name == "train.step.table_update"]
    for table in ("item_id", "user_id"):
        specs = [s for s in model.schema.specs if s.table == table]
        ids = np.concatenate([offset_ids(s, batch[s.name]).numpy().reshape(-1) for s in specs])
        vocab = int(dict(model.tables)[table][0])
        distinct = len(np.unique(ids[(ids > 0) & (ids < vocab)]))
        assert upd.counts[f"rows.distinct.{table}"] == distinct
        assert upd.counts[f"rows.passed.{table}"] == (
            model.embedder.tables[table].shape[0] if route == "dense" else ids.size)


def test_recording_changes_no_bit_of_training():
    out = []
    for on in (False, True):
        model, step, state = stepper(attention_cfg(), seed=3)
        hist = AucHist.zeros("cpu")
        with profiling.recording() if on else contextlib.nullcontext():
            losses = [step(state, b, hist)[0] for b in batches(3, seed=9)]
        out.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()},
                    hist.pos.clone()))
    assert len(profiling.recorded().spans) == 3 * (1 + len(STEP_PARTS))
    (l0, p0, h0), (l1, p1, h1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert p0.keys() == p1.keys() and all(torch.equal(p0[n], p1[n]) for n in p0)
    assert torch.equal(h0, h1)


def test_epoch_loop_records_its_parts_and_the_flush(tmp_path):
    """``train_epoch`` under a profiler: one ``train.epoch`` root over the
    plan, a ``train.batch`` and a ``train.step`` a step, K-step write-back's
    ``train.flush`` (with the row counts), the sync and the metrics."""
    raw_cfg = zoo.attention_config(batch_size=B)
    cfg = dataclasses.replace(raw_cfg, train_hparams=dataclasses.replace(
        raw_cfg.train_hparams, embedding_update_period=2, chunk_steps=4))
    arrays = zoo.attention_arrays(4 * B, seed=11)
    t = Trainer(cfg, build_ranker(cfg, seed=1, device="cpu"), workdir=str(tmp_path),
                device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t.train_epoch(t.init_state(), PackedDataset(arrays), 0)
    spans = profiling.recorded().spans
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "train.epoch" and {s.root for s in spans} == {root.id}
    names = [s.name for s in children(spans, root)]
    assert names == (["train.epoch.plan"] + ["train.batch", "train.step"] * 2 + ["train.flush"]
                     + ["train.batch", "train.step"] * 2 + ["train.flush"]
                     + ["train.epoch.sync", "train.epoch.metrics"])
    flushes = [s for s in spans if s.name == "train.flush"]
    assert all(s.counts["rows.passed.user_id"] == 2 * B for s in flushes)


DENSE_PARTS = ["train.step.forward", "train.step.backward", "train.step.adamw",
               "train.step.auc"]
NRMS_PARTS = ["train.step.news", "train.step.user", "train.step.score"]


def nrms_stepper(seed=0):
    """A small NRMS on the all-dense step, its title table set: articles
    1-3 have no word."""
    from news_recsys_tpu_torch.config import config_to_dict
    from news_recsys_tpu_torch.training import dense_step

    raw = config_to_dict(zoo.mind_nrms_config(batch_size=8))
    raw["nrms_cfg"].update(articles=40, vocab=50, word_dim=8, num_heads=2, head_dim=4,
                           query_dim=6, title_len=6)
    cfg = config_from_dict(raw)
    model = build_ranker(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    titles = rng.integers(1, 50, (40, 6)).astype(np.int32)
    titles[:4] = 0
    model.set_titles(titles)
    return model, dense_step.make_train_step(model, cfg), dense_step.init_dense_state(model, cfg)


def nrms_batch():
    """8 rows: histories of 10 slots with 0, 3, 10, ... articles (ids repeat
    across rows and slots), 5 candidates, the positive first."""
    hist = (np.arange(80).reshape(8, 10) % 13 + 1).astype(np.int32)
    hist[np.arange(10)[None, :] >= np.array([0, 3, 10, 1, 5, 10, 2, 7])[:, None]] = 0
    cand = (np.arange(40).reshape(8, 5) * 7 % 39 + 1).astype(np.int32)
    label = np.zeros((8, 5), np.float32)
    label[:, 0] = 1.0
    return {"hist": torch.from_numpy(hist), "item_id": torch.from_numpy(cand),
            "label": torch.from_numpy(label)}


def test_dense_step_records_its_four_parts_in_order():
    """The all-dense step (``attention@adamw``) records ``train.step`` and
    its parts under the sparse step's names."""
    cfg = zoo.attention_config(batch_size=B, embedding_optimizer="adamw")
    from news_recsys_tpu_torch.training import dense_step

    model = build_ranker(cfg, seed=0, device="cpu")
    step, state = dense_step.make_train_step(model, cfg), dense_step.init_dense_state(model, cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batches(1)[0], AucHist.zeros("cpu"))
    spans = profiling.recorded().spans
    (root,) = [s for s in spans if s.name == "train.step"]
    assert root.parent is None and state.step == 1
    parts = children(spans, root)
    assert [s.name for s in parts] == DENSE_PARTS and len(spans) == 1 + len(DENSE_PARTS)
    for a, b in zip(parts, parts[1:]):
        assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= root.end_ns


def test_nrms_step_records_news_user_and_score_inside_the_forward():
    """NRMS's forward records ``train.step.news``, ``.user`` and ``.score``
    under ``train.step.forward``, and the listwise loss a second ``.score``
    after them; nothing records while it scores without a step."""
    model, step, state = nrms_stepper()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, nrms_batch(), AucHist.zeros("cpu"))
        with torch.no_grad():
            model(nrms_batch())
    spans = profiling.recorded().spans
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "train.step"
    assert [s.name for s in children(spans, root)] == DENSE_PARTS
    (fwd,) = [s for s in spans if s.name == "train.step.forward"]
    assert [s.name for s in children(spans, fwd)] == NRMS_PARTS + ["train.step.score"]
    assert len(spans) == 1 + len(DENSE_PARTS) + len(NRMS_PARTS) + 1


def test_nrms_title_counts_on_a_fixed_batch():
    """On ``train.step.news``: ``nrms.titles.slots`` is B (H + C), ``.real``
    the slots that are not padding, ``.distinct`` the distinct articles,
    the last two kept as functions until the spans are read."""
    model, step, state = nrms_stepper()
    batch = nrms_batch()
    with profiling.recording():
        step(state, batch, AucHist.zeros("cpu"))
    (kept,) = [s for s in profiling._store if s.name == "train.step.news"]
    assert [k for k, v in kept.counts.items() if callable(v)] == ["nrms.titles.real",
                                                                   "nrms.titles.distinct"]
    (news,) = [s for s in profiling.recorded().spans if s.name == "train.step.news"]
    ids = np.concatenate([batch["hist"].numpy(), batch["item_id"].numpy()], axis=1)
    assert news.counts == {"nrms.titles.slots": 8 * 15,
                           "nrms.titles.real": int((ids > 0).sum()),
                           "nrms.titles.distinct": len(np.unique(ids[ids > 0]))}
    assert news.counts == {"nrms.titles.slots": 120, "nrms.titles.real": 78,
                           "nrms.titles.distinct": 39}


def read_trace(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json*"))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def test_profile_steps_trace_carries_each_span_once(tmp_path, monkeypatch):
    """``Trainer(profile_steps=1)``'s trace holds the program's spans of
    epoch 0, each once: the profiler's own ranges, with no span to add to
    the file (it is written once)."""
    monkeypatch.setattr(profiling, "_add_spans", None)
    cfg = zoo.attention_config(batch_size=B)
    t = Trainer(cfg, build_ranker(cfg, seed=2, device="cpu"), workdir=str(tmp_path),
                device="cpu", profile_steps=1)
    t.fit(PackedDataset(zoo.attention_arrays(3 * B, seed=12)), max_epochs=2)
    events = [e for e in read_trace(str(tmp_path / "profile"))
              if e.get("cat") == "user_annotation"]
    for name in ["train.epoch", "train.step", *STEP_PARTS]:
        want = 1 if name == "train.epoch" else 3
        assert sum(e["name"] == name for e in events) == want, name


# -- serving -------------------------------------------------------------------

N_ITEMS, HIST_LEN, FETCH = 96, 6, 12


def serving_stacks():
    dcfg = config_from_dict({
        "name": "dssm",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["hist"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"],
                     "array_max_length": {"hist": HIST_LEN}},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 16},
                       "embedding_table_size": {"user_id": 64, "item_id": 128, "category": 8},
                       "share_emb_table_features": {"hist": "item_id"}}})
    rcfg = config_from_dict({
        "name": "attention",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["hist"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"],
                     "array_max_length": {"hist": HIST_LEN}},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 8},
                       "embedding_table_size": {"user_id": 64, "item_id": 128, "category": 8},
                       "share_emb_table_features": {"hist": "item_id"}},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 1, "num_heads": 2,
                          "ff_dim": 24}})
    rng = np.random.default_rng(0)
    items = {"item_id": np.arange(1, N_ITEMS + 1, dtype=np.int32),
             "category": rng.integers(1, 8, N_ITEMS).astype(np.int32),
             "label": np.zeros((N_ITEMS, 1), np.float32)}
    recall = serving.Recommender(dcfg, build_dssm(dcfg, seed=0, device="cpu"),
                                 PackedDataset(dict(items)), device="cpu", batch_size=16,
                                 backend="device")
    return serving.CascadeRecommender(recall, rcfg, build_ranker(rcfg, seed=1, device="cpu"),
                                      PackedDataset(dict(items)), fetch=FETCH)


def users(n, seed=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, N_ITEMS + 1, (n, HIST_LEN)).astype(np.int32)
    hist[np.arange(HIST_LEN)[None, :] >= rng.integers(0, HIST_LEN + 1, n)[:, None]] = 0
    return {"user_id": rng.integers(1, 64, n).astype(np.int32), "hist": hist,
            "label": np.zeros((n, 1), np.float32)}


@pytest.fixture(scope="module")
def server():
    casc = serving_stacks()
    srv = serving.serve_http(casc, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def post(url, n, seed):
    batch = users(n, seed)
    hist = [[int(i) for i in row if i] for row in batch["hist"]]
    body = {"users": {"user_id": batch["user_id"].tolist(), "hist": batch["hist"].tolist()},
            "k": FETCH, "histories": hist}
    req = urllib.request.Request(url + "/recommend", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def settled(n, timeout=30.0):
    """The recorded spans, once ``n`` are: the server's thread closes a
    request's ``serve.reply`` and ``serve.request`` after the client has read
    the reply."""
    deadline = time.monotonic() + timeout
    while len(profiling.recorded().spans) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return profiling.recorded().spans


SERVE_TREE = {"serve.request": None, "serve.parse": "serve.request",
              "serve.cascade": "serve.request", "serve.reply": "serve.request",
              "serve.recall": "serve.cascade", "serve.recall.tower": "serve.recall",
              "serve.recall.search": "serve.recall",
              "serve.recall.search.wait": "serve.recall.dedup",
              "serve.recall.dedup": "serve.recall", "serve.cascade.join": "serve.cascade",
              "serve.cascade.rank": "serve.cascade",
              "serve.cascade.rank.wait": "serve.cascade.rank",
              "serve.cascade.order": "serve.cascade", "serve.cascade.lists": "serve.cascade"}


def test_served_request_records_on_the_server_thread(server):
    """A request over ``serve_http`` records one tree on the server's
    thread; ``recall.kept`` is the candidates recall passed on (k = fetch:
    the reply's lists) of ``recall.fetched``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reply = post(server, 5, seed=2)
    spans = settled(len(SERVE_TREE))
    by = {s.name: s for s in spans}
    assert sorted(by) == sorted(SERVE_TREE) and len(spans) == len(SERVE_TREE)
    root = by["serve.request"]
    assert root.parent is None and {s.root for s in spans} == {root.id}
    assert {s.thread for s in spans} == {root.thread} != {threading.get_native_id()}
    for name, parent in SERVE_TREE.items():
        if parent is not None:
            assert by[name].parent == by[parent].id, name
    recall = by["serve.recall"].counts
    assert recall["recall.kept"] == sum(map(len, reply["ids"])) == 5 * FETCH
    longest = max(len([i for i in row if i]) for row in users(5, seed=2)["hist"])
    assert recall["recall.fetched"] == 5 * (FETCH + longest)


def test_cascade_request_records_the_dedup_and_its_wait():
    """A cascade request whose recall fetches the whole corpus (its fetch
    plus the longest history passes it) records ``serve.recall.dedup`` once,
    the copy ``serve.recall.search.wait`` once inside it, and the counts the
    per-item loop counted on this batch: every row fetched the corpus and
    kept all of it but its distinct clicks (one outside the corpus), at most
    the cascade's fetch."""
    casc = serving_stacks()
    casc.fetch = N_ITEMS - 2
    batch = users(7, seed=11)
    hist = [[int(i) for i in row if i] for row in batch["hist"]]
    hist[0].append(N_ITEMS + 40)
    with profiling.recording():
        casc.recommend(batch, k=5, histories=hist)
    spans = profiling.recorded().spans
    by = {s.name: s for s in spans}
    assert [s.name for s in spans].count("serve.recall.dedup") == 1
    assert [s.name for s in spans].count("serve.recall.search.wait") == 1
    assert by["serve.recall.search.wait"].parent == by["serve.recall.dedup"].id
    counts = by["serve.recall"].counts
    assert counts == {"recall.fetched": 7 * N_ITEMS, "recall.kept": 650}
    assert counts["recall.kept"] == sum(min(casc.fetch, N_ITEMS - len(set(h) - {N_ITEMS + 40}))
                                        for h in hist)


def test_trace_writes_each_server_span_once_in_its_window(server, tmp_path):
    """The server thread's spans, which the profiler does not record, are
    added to ``trace()``'s file once each, inside its window, with their
    root and counts."""
    with profiling.trace(str(tmp_path)):
        post(server, 3, seed=3)
        post(server, 2, seed=4)
        settled(2 * len(SERVE_TREE))
    events = read_trace(str(tmp_path))
    mark = next(e for e in events if e.get("name") == profiling.CLOCK_MARK)
    ends = max(e["ts"] + e.get("dur", 0) for e in events if e.get("ph") == "X")
    spans = profiling.recorded().spans
    assert len(spans) == 2 * len(SERVE_TREE)
    for s in spans:
        got = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == s.name
               and e.get("tid") == s.thread]
        assert len(got) == 1, s.name
        assert mark["ts"] <= got[0]["ts"] and got[0]["ts"] + got[0]["dur"] <= ends + 1
        assert got[0]["args"] == {"span": s.id, "root": s.root, **s.counts}
    assert sum("recall.kept" in s.counts for s in spans) == 2
