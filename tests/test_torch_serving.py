"""The port's recall and recall -> rank cascade against the JAX package's.

Both sides serve the same converted parameters, items and requests; the
JAX Pallas kernels run in interpret mode. Answers agree when the ids match
wherever neighbouring scores differ by more than 1e-5, and the scores match
within 1e-5.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from news_recsys_tpu import serving as jserving
from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu_torch import serving as tserving
from news_recsys_tpu_torch.convert import params_from_flax
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.rankers import build_ranker

from tests.test_torch_models import history, jax_init, small_dcn_raw, small_dssm_raw

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, HIST_LEN, FETCH, TOL = 96, 6, 40, 1e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("NRT_PALLAS", "interpret")


def item_arrays(n_items, seed=0):
    rng = np.random.default_rng(seed)
    return {"item_id": np.arange(1, n_items + 1, dtype=np.int32),
            "category": rng.integers(1, 8, n_items).astype(np.int32),
            "label": np.zeros((n_items, 1), np.float32)}


def users(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(1, 64, n).astype(np.int32),
            "hist": history(rng, n, HIST_LEN, N_ITEMS + 1),
            "label": np.zeros((n, 1), np.float32)}


def histories_of(batch):
    return [[int(i) for i in row if i] for row in batch["hist"]]


@pytest.fixture(scope="module")
def stacks():
    """(jax cascade, port cascade) on the same configs and JAX-initialised parameters."""
    dcfg, rcfg = config_from_dict(small_dssm_raw(HIST_LEN)), config_from_dict(small_dcn_raw())
    sample = {**users(8), **{k: v[:8] for k, v in item_arrays(N_ITEMS).items()}}
    jdssm, jranker = jbuild_dssm(dcfg), jbuild_ranker(rcfg, "dcn")
    dparams, rparams = jax_init(jdssm, sample, seed=0), jax_init(jranker, sample, seed=1)
    items = item_arrays(N_ITEMS)
    jrecall = jserving.Recommender(dcfg, jdssm, dparams, PackedDataset(dict(items)),
                                   backend="device", batch_size=16)
    jcasc = jserving.CascadeRecommender(jrecall, rcfg, jranker, rparams,
                                        PackedDataset(dict(items)), fetch=FETCH)
    trecall = tserving.Recommender(dcfg, params_from_flax(dparams, build_dssm(dcfg, device="cpu")),
                                   PackedDataset(dict(items)), device="cpu", batch_size=16)
    tcasc = tserving.CascadeRecommender(trecall, rcfg,
                                        params_from_flax(rparams, build_ranker(rcfg, device="cpu")),
                                        PackedDataset(dict(items)), fetch=FETCH)
    return jcasc, tcasc


def assert_same_answers(got, want, tol=TOL):
    (got_ids, got_scores), (want_ids, want_scores) = got, want
    assert len(got_ids) == len(want_ids)
    for r, w in enumerate(want_scores):
        np.testing.assert_allclose(got_scores[r], w, rtol=0, atol=tol)
        w = np.asarray(w)
        gaps = np.abs(np.diff(w))
        for j in range(len(w)):
            tied = (j > 0 and gaps[j - 1] <= tol) or (j < len(gaps) and gaps[j] <= tol)
            if not tied:
                assert got_ids[r][j] == want_ids[r][j], (r, j)


def test_recall_matches_jax(stacks, pallas_interpret):
    jcasc, tcasc = stacks
    np.testing.assert_allclose(tcasc.recall.corpus, jcasc.recall.corpus, atol=TOL)
    batch = users(16)
    assert_same_answers(tcasc.recall.recommend(batch, k=12, histories=histories_of(batch)),
                        jcasc.recall.recommend(batch, k=12, histories=histories_of(batch)))


def test_cascade_matches_jax(stacks, pallas_interpret):
    jcasc, tcasc = stacks
    batch = users(16, seed=2)
    got = tcasc.recommend(batch, k=10, histories=histories_of(batch))
    assert_same_answers(got, jcasc.recommend(batch, k=10, histories=histories_of(batch)))
    for ids, scores, hist in zip(*got, histories_of(batch)):
        assert len(ids) == 10 and not set(ids) & set(hist)
        assert scores == sorted(scores, reverse=True)


def test_cascade_unknown_candidates_are_never_served(stacks, pallas_interpret):
    """The one intended divergence from the JAX cascade: a recall candidate
    missing from the ranker's item features becomes an invalid slot here,
    where the JAX join table sends it to item row 0 and serves it."""
    jcasc, tcasc = stacks
    items = item_arrays(N_ITEMS)
    keep = (items["item_id"] < 30) | (items["item_id"] >= 60)    # ids 30..59 unknown
    known = {k: v[keep] for k, v in items.items()}
    jpart = jserving.CascadeRecommender(jcasc.recall, jcasc.ranker_cfg, jcasc.ranker_model,
                                        jcasc.ranker_params, PackedDataset(known),
                                        fetch=FETCH)
    tpart = tserving.CascadeRecommender(tcasc.recall, tcasc.ranker_cfg, tcasc.ranker_model,
                                        PackedDataset(known), fetch=FETCH)
    batch = users(16, seed=3)
    jids, _ = jpart.recommend(batch, k=10)
    tids, tscores = tpart.recommend(batch, k=10)
    assert any(30 <= i < 60 for row in jids for i in row)
    assert not any(30 <= i < 60 for row in tids for i in row)
    assert all(len(row) == 10 for row in tids)
    for row, scores in zip(tids, tscores):
        assert scores == sorted(scores, reverse=True)


def test_recall_history_dedup(stacks):
    recall = stacks[1].recall
    batch = users(1, seed=4)
    base, _ = recall.recommend(batch, k=8)
    banned = base[0][:4]
    ids, _ = recall.recommend(batch, k=8, histories=[banned])
    assert not set(ids[0]) & set(banned)
    assert ids[0][:4] == base[0][4:]


K = 8
# name: (users, k, histories from each row's corpus in the search's order)
HISTORY_CASES = {
    "none": (6, K, lambda top: None),
    "all_empty": (6, K, lambda top: [[] for _ in top]),
    "ragged": (6, K, lambda top: [row[1:3 * r:3] for r, row in enumerate(top)]),
    "duplicates": (6, K, lambda top: [row[:3] * 2 + row[:1] for row in top]),
    "outside_the_corpus": (6, K, lambda top: [[0, N_ITEMS + 1, -7, 10**12] + row[2:4]
                                              for row in top]),
    "longer_than_k": (6, K, lambda top: [row[:K + 5] for row in top]),
    "fetch_capped_by_the_corpus": (6, N_ITEMS - 4, lambda top: [row[::7] for row in top]),
    "zero_users": (0, K, lambda top: []),
    "largest_item_id": (6, N_ITEMS - 3, lambda top: [[N_ITEMS, row[0]][:1 + r % 2]
                                                     for r, row in enumerate(top)]),
}


@pytest.mark.parametrize("case", sorted(HISTORY_CASES))
def test_recall_keeps_the_first_k_unseen(stacks, monkeypatch, case):
    """``Recommender.recommend`` against the rule, applied to the search's
    own output: each row's first ``k`` fetched ids, in the search's order,
    that its history lacks, with their scores; ``k`` plus the longest
    history fetched, at most the corpus."""
    recall = stacks[1].recall
    n, k, make = HISTORY_CASES[case]
    searched = []
    search = recall.searcher.search_tensors
    monkeypatch.setattr(recall.searcher, "search_tensors",
                        lambda q, f: searched.append(search(q, f)) or searched[-1])
    batch = users(n, seed=8)
    recall.recommend(batch, k=N_ITEMS)
    top = [recall.item_ids[row].tolist() for row in searched[0][0].numpy()] if n else []
    histories = make(top)
    searched.clear()
    got = recall.recommend(batch, k=k, histories=histories)
    want_ids, want_scores = [], []
    rows = zip(*(t.tolist() for t in searched[0])) if n else ()
    for r, (idx, scores) in enumerate(rows):
        assert len(idx) == min(k + max(map(len, histories or [[]])), N_ITEMS)
        seen = set(histories[r]) if histories else set()
        kept = [(int(recall.item_ids[i]), s) for i, s in zip(idx, scores)
                if recall.item_ids[i] not in seen][:k]
        want_ids.append([i for i, _ in kept])
        want_scores.append([s for _, s in kept])
    assert got == (want_ids, want_scores)
    assert len(searched) == (1 if n else 0)
    if case == "fetch_capped_by_the_corpus":
        assert all(len(row) < k for row in got[0])


def test_bundle_round_trip(stacks, tmp_path):
    tcasc = stacks[1]
    batch = users(8, seed=5)
    want = tcasc.recommend(batch, k=5, histories=histories_of(batch))
    path = tcasc.save(str(tmp_path / "bundle"))
    assert sorted(os.listdir(path)) == ["item_features.npz", "meta.json", "ranker", "recall"]
    assert sorted(os.listdir(os.path.join(path, "ranker"))) == ["config.json", "params.npz"]
    loaded = tserving.CascadeRecommender.load(path, device="cpu")
    assert loaded.recommend(batch, k=5, histories=histories_of(batch)) == want
    recall = tserving.Recommender.load(os.path.join(path, "recall"), device="cpu")
    np.testing.assert_array_equal(recall.corpus, tcasc.recall.corpus)


def test_export_script_converts_jax_bundles(stacks, tmp_path, pallas_interpret):
    jcasc = stacks[0]
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle", os.path.join(REPO, "scripts", "export_torch_bundle.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jpath = jcasc.save(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="export_torch_bundle"):
        tserving.Recommender.load(os.path.join(jpath, "recall"), device="cpu")
    out = script.export(jpath, str(tmp_path / "torch"))
    batch = users(8, seed=6)
    got = tserving.CascadeRecommender.load(out, device="cpu").recommend(batch, k=6)
    assert_same_answers(got, jcasc.recommend(batch, k=6))
    out = script.export(os.path.join(jpath, "recall"), str(tmp_path / "torch_recall"))
    assert_same_answers(tserving.Recommender.load(out, device="cpu").recommend(batch, k=6),
                        jcasc.recall.recommend(batch, k=6))


@pytest.fixture
def server(stacks):
    srv = tserving.serve_http(stacks[1], host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def post(url, body):
    req = urllib.request.Request(url + "/recommend", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_shim(stacks, server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "items": N_ITEMS, "backend": "host",
                      "cascade": True, "ranker": "dcn", "fetch": FETCH}
    batch = users(3, seed=7)
    body = {"users": {"user_id": batch["user_id"].tolist(), "hist": batch["hist"].tolist()},
            "k": 4, "histories": histories_of(batch)}
    code, out = post(server, body)
    assert code == 200
    want = stacks[1].recommend({**batch}, k=4, histories=histories_of(batch))
    assert out["ids"] == want[0]
    np.testing.assert_allclose(out["scores"], want[1], rtol=1e-6)


@pytest.mark.parametrize("users_json,extra,match", [
    ({"user_id": [1, 2]}, {}, "missing user feature 'hist'"),
    ({"user_id": [1, -2], "hist": [[1, 0], [2, 3]]}, {}, "negative ids"),
    ({"user_id": [1, 2], "hist": [[1, 0], [2, 3]]}, {"k": 0}, "k must be positive"),
    ({"user_id": [1, 2], "hist": [[1, 0], [2, 3]]}, {"histories": [[1]]}, "histories"),
    ({"user_id": [1, 2], "hist": [[1, 0], [2]]}, {}, ""),
    ({"user_id": [1, 2], "hist": [[1, 0], [2, 3]]}, {"histories": [["x"], [1]]},
     "histories must hold int64 item ids"),
    ({"user_id": [1, 2], "hist": [[1, 0], [2, 3]]}, {"histories": [[2**70], [1]]},
     "histories must hold int64 item ids"),
    ({"user_id": [1, 2], "hist": [[1, 0], [2, 3]]}, {"histories": [5, [1]]},
     "histories must be lists"),
])
def test_http_shim_rejects_bad_requests(server, users_json, extra, match):
    code, out = post(server, {"users": users_json, **extra})
    assert code == 400 and match in out["error"]


def test_port_imports_no_jax():
    """The port, chip_smoke.py and chip_profile.py load without JAX (nor
    flax, optax or orbax), without pandas, which the card's machine need not
    have, and without any module of the JAX package: the port keeps its own
    copies of the backend-free modules the two share
    (tests/test_torch_shared.py) and reads and writes MIND files on numpy."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import news_recsys_tpu_torch as p, chip_smoke, chip_profile\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pandas', 'news_recsys_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # nor does any file of the port, or a chip script, name such an import
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "chip_profile.py")]
    for root, _, names in os.walk(os.path.join(REPO, "news_recsys_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files.append(os.path.join(REPO, "tests", "test_torch_cuda.py"))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m and m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
                     "news_recsys_tpu")], path


def test_serve_cli_refuses_missing_gpu(stacks, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: serve --device cuda would start serving")
    path = stacks[1].save(str(tmp_path / "bundle"))
    proc = subprocess.run([sys.executable, "-m", "news_recsys_tpu_torch", "serve",
                           "--bundle", path, "--device", "cuda"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA GPU is visible" in proc.stderr


@pytest.mark.parametrize("entry", ["build_ranker", "build_dssm", "Trainer", "TopKSearcher",
                                   "Recommender.load", "CascadeRecommender.load"])
def test_entry_points_default_to_the_card(stacks, tmp_path, entry):
    """With no ``device=`` an entry point runs on the card, and raises where
    there is none: nothing carries on on the CPU unasked."""
    import inspect

    from news_recsys_tpu_torch.ops.topk import TopKSearcher
    from news_recsys_tpu_torch.training.trainer import Trainer

    tcasc = stacks[1]
    fn = {"build_ranker": build_ranker, "build_dssm": build_dssm, "Trainer": Trainer,
          "TopKSearcher": TopKSearcher, "Recommender.load": tserving.Recommender.load,
          "CascadeRecommender.load": tserving.CascadeRecommender.load}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is there to use")
    path = tcasc.save(str(tmp_path / "bundle"))
    calls = {"build_ranker": lambda: build_ranker(tcasc.ranker_cfg),
             "build_dssm": lambda: build_dssm(tcasc.recall.cfg),
             "Trainer": lambda: Trainer(tcasc.ranker_cfg, tcasc.ranker_model,
                                        workdir=str(tmp_path / "work")),
             "TopKSearcher": lambda: TopKSearcher().update_embedding(np.zeros((4, 2), np.float32)),
             "Recommender.load": lambda: tserving.Recommender.load(os.path.join(path, "recall")),
             "CascadeRecommender.load": lambda: tserving.CascadeRecommender.load(path)}
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
        calls[entry]()
    assert next(tcasc.ranker_model.parameters()).device.type == "cpu"
