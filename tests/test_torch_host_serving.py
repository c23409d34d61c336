"""The port's host C++ libraries and what serves through them, on the CPU,
against the JAX package's: the host top-k searcher, the text-format parser
and ``open_split``'s fall-back to it, ``build_cascade`` from a ranker's
training checkpoint, and ``serve``'s ``--backend``, ``--ranker-ckpt``,
``--ranker-config`` and ``--fetch``.

- The searcher and the parser are the same C++ sources built the same way,
  so their outputs equal JAX's bit for bit.
- The cascades serve JAX-initialised weights on both sides, the JAX Pallas
  kernels in interpret mode; answers agree as tests/test_torch_serving.py
  holds them (ids where neighbouring scores differ by more than 1e-5,
  scores within 1e-5).
"""

import importlib.util
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from news_recsys_tpu import config as jconfig
from news_recsys_tpu import native as jnative
from news_recsys_tpu import serving as jserving
from news_recsys_tpu.data.packed_dataset import PackedDataset as JPacked
from news_recsys_tpu.data.text_format import read_text_features as jread_text
from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training.trainer import Trainer as JTrainer
from news_recsys_tpu_torch import config as tconfig
from news_recsys_tpu_torch import native as tnative
from news_recsys_tpu_torch import serving as tserving
from news_recsys_tpu_torch.cli import main as cli
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.data.text_format import read_text_features, write_text_features

from tests.test_torch_cli import workspace  # noqa: F401
from tests.test_torch_models import jax_init, small_dcn_raw, small_dssm_raw
from tests.test_torch_serving import (FETCH, HIST_LEN, N_ITEMS, assert_same_answers,
                                      histories_of, item_arrays, users)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native_libs(tmp_path_factory):
    """The JAX package's host libraries, built into a directory of this
    module's own. The JAX package writes ``native/build/lib*.so`` in place
    (no temporary file and rename), and other test files build the same
    file in parallel workers: a worker that loaded a half-written library
    cached ``None`` for it. Every JAX-native call in this file (the
    searcher, ``parse_text_features_native``, ``read_text_features`` and
    ``open_split``'s text fall-back) goes through the private build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_BUILD_DIR", str(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jnative, "_cache", {})
        assert jnative.load_ann() is not None and jnative.load_text_parser() is not None
        yield


# -- the host searcher ---------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("n,k", [(200, 7), (200, 1), (9, 12)])
def test_host_searcher_equals_jax(n, k, normalize):
    """Indices and scores bit for bit, ``k > n`` padded with -1 / -inf,
    ties (repeated corpus rows) to the lower index."""
    rng = np.random.default_rng(n + k)
    corpus = rng.standard_normal((n, 16)).astype(np.float32)
    corpus[1::5] = corpus[0]                                 # exact ties
    queries = rng.standard_normal((13, 16)).astype(np.float32)
    got, want = tnative.HostTopKSearcher(normalize), jnative.HostTopKSearcher(normalize)
    assert want.available
    for s in (got, want):
        s.update_embedding(corpus)
    (gi, gs), (wi, ws) = got.search(queries, k), want.search(queries, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gs, ws)
    if k > n:
        assert (gi[:, n:] == -1).all() and np.isneginf(gs[:, n:]).all()


def test_host_searcher_finds_the_exact_top_k():
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((300, 8)).astype(np.float32)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    s = tnative.HostTopKSearcher()
    s.update_embedding(corpus)
    idx, scores = s.search(queries, 10)
    want = np.argsort(-(queries.astype(np.float64) @ corpus.T.astype(np.float64)), axis=1)[:, :10]
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(scores, np.take_along_axis(queries @ corpus.T, want, 1), rtol=1e-5)
    with pytest.raises(ValueError):
        s.search(queries[:, :4], 3)
    with pytest.raises(RuntimeError, match="update_embedding"):
        tnative.HostTopKSearcher().search(queries, 3)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler is an error (the JAX package would fall back to Python)."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="building .*ann_topk.cpp failed"):
        tnative.load_ann()


# -- the text format -----------------------------------------------------------

TEXT_RAW = {
    "name": "deep",
    "features": {"sparse_feature_names": ["user_id", "item_id"],
                 "dense_feature_names": ["ctr"],
                 "array_feature_names": ["hist"], "array_max_length": {"hist": 5},
                 "item_feature_names": ["item_id"], "user_feature_names": ["user_id", "hist"]},
    "embeddings": {"embedding_size": {"user_id": 8, "item_id": 8},
                   "embedding_table_size": {"user_id": 100, "item_id": 100},
                   "share_emb_table_features": {"hist": "item_id"}},
}


def text_arrays(n, labels, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 100, (n, 5)).astype(np.int32)
    lens = rng.integers(0, 6, n)
    hist[np.arange(5)[None, :] >= lens[:, None]] = 0
    return {"user_id": rng.integers(1, 100, n).astype(np.int32),
            "item_id": rng.integers(1, 100, n).astype(np.int32),
            "ctr": np.round(rng.random(n), 3).astype(np.float32),
            "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
            "label": rng.integers(0, 2, (n, labels)).astype(np.float32)}


@pytest.mark.parametrize("labels", [1, 3])
def test_text_parsers_equal_jax(tmp_path, labels):
    """The native parser and ``read_text_features`` against the JAX
    package's on a file with every feature kind, empty histories and
    multi-value labels."""
    path = str(tmp_path / "f.txt")
    feats = text_arrays(40, labels)
    write_text_features(path, feats, ["user_id", "item_id", "ctr", "hist"])
    tcfg, jcfg = tconfig.config_from_dict(TEXT_RAW), jconfig.config_from_dict(TEXT_RAW)
    native = tnative.parse_text_features_native(path, tcfg, n_labels=labels)
    want = jnative.parse_text_features_native(path, jcfg, n_labels=labels)
    python = read_text_features(path, tcfg)
    for got in (native, python, jread_text(path, jcfg)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in feats.items():
        np.testing.assert_array_equal(native[k], v, err_msg=k)
    for flag in (True, False):
        ds = PackedDataset.from_text(path, tcfg, native=flag)
        assert sorted(ds.arrays) == sorted(want) and len(ds) == 40


def test_open_split_falls_back_to_the_text_split(workspace):  # noqa: F811
    """``fe --text`` writes ``<split>_features.txt`` beside the ``.npz``;
    with the ``.npz`` gone, ``open_split`` reads the text split, as JAX's
    does, and its arrays equal the ``.npz``'s (the parser fills every
    feature of the config: the item split gains the user features, zeros,
    in both packages)."""
    tmp, cfg_path, _, _ = workspace
    doc = yaml.safe_load(open(cfg_path))
    doc["paths"]["out_basedir"] = str(tmp / "text_out")
    path = tmp / "text.yaml"
    path.write_text(yaml.safe_dump(doc))
    cli(["preprocess", "-c", str(path)])
    cli(["fe", "-c", str(path), "--text"])
    cfg = tconfig.load_config(str(path))
    base = os.path.join(cfg.paths.out_basedir, "extractored_feature")
    for split in ("train", "dev", "item"):
        npz = os.path.join(base, f"{split}_features.npz")
        want = PackedDataset.load(npz).arrays
        os.replace(npz, npz + ".away")
        got = PackedDataset.open_split(cfg, split).arrays
        jgot = JPacked.open_split(jconfig.load_config(str(path)), split).arrays
        assert sorted(got) == sorted(jgot) and set(want) <= set(got), split
        assert split == "item" or set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
            np.testing.assert_array_equal(got[k], jgot[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        PackedDataset.open_split(cfg, "nothing")


# -- build_cascade and serve ---------------------------------------------------

def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX recall bundle and a JAX ranker's epoch checkpoint with its YAML
    config (its item split extracted under its ``out_basedir``), and the
    same as the port's: the bundle through scripts/export_torch_bundle.py,
    the checkpoint through scripts/export_torch_checkpoint.py."""
    tmp = tmp_path_factory.mktemp("served")
    items = item_arrays(N_ITEMS)
    base = tmp / "out" / "extractored_feature"
    base.mkdir(parents=True)
    np.savez(base / "item_features.npz", **items)
    rraw = {**small_dcn_raw(), "paths": {"data_path": str(tmp / "Data"),
                                         "out_basedir": str(tmp / "out")}}
    rpath = tmp / "ranker.yaml"
    rpath.write_text(yaml.safe_dump(rraw))
    dcfg, rcfg = jconfig.config_from_dict(small_dssm_raw(HIST_LEN)), jconfig.load_config(str(rpath))
    sample = {**users(8), **{k: v[:8] for k, v in items.items()}}
    jdssm = jbuild_dssm(dcfg)
    jrecall = jserving.Recommender(dcfg, jdssm, jax_init(jdssm, sample, seed=0),
                                   JPacked(dict(items)), backend="device", batch_size=16)
    jbundle = jrecall.save(str(tmp / "jax_bundle"))
    jt = JTrainer(rcfg, jbuild_ranker(rcfg, "dcn"), workdir=str(tmp / "jax_ranker"),
                  use_mesh=False)
    jt.save_checkpoint(jt.init_state({**sample, "_valid": np.ones(8, np.float32)}, seed=1), 0)
    tbundle = load_script("export_torch_bundle").export(jbundle, str(tmp / "port_bundle"))
    load_script("export_torch_checkpoint").export(
        str(rpath), str(tmp / "jax_ranker"), str(tmp / "port_ranker" / "ckpts" / "epoch_000.pt"))
    return {"tmp": tmp, "ranker_config": str(rpath), "jax_bundle": jbundle,
            "jax_ranker": str(tmp / "jax_ranker"), "port_bundle": tbundle,
            "port_ranker": str(tmp / "port_ranker")}


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("NRT_PALLAS", "interpret")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_build_cascade_matches_jax(served, pallas_interpret, backend):
    jcasc = jserving.build_cascade(served["jax_bundle"], served["jax_ranker"],
                                   served["ranker_config"], fetch=FETCH, backend="device")
    tcasc = tserving.build_cascade(served["port_bundle"], served["port_ranker"],
                                   served["ranker_config"], fetch=FETCH, backend=backend,
                                   device="cpu")
    assert tcasc.recall.backend == backend and tcasc.fetch == FETCH
    batch = users(16, seed=3)
    assert_same_answers(tcasc.recommend(batch, k=10, histories=histories_of(batch)),
                        jcasc.recommend(batch, k=10, histories=histories_of(batch)))


def test_recall_backends_agree_on_the_cpu(served):
    """``host`` and ``device`` search the same corpus: the same ids but for
    exact ties, scores within 1e-6; ``auto`` on the CPU is ``host``."""
    recs = {b: tserving.Recommender.load(served["port_bundle"], device="cpu", backend=b)
            for b in ("auto", "host", "device")}
    assert recs["auto"].backend == "host"
    batch = users(16, seed=4)
    answers = {b: r.recommend(batch, k=12, histories=histories_of(batch))
               for b, r in recs.items()}
    assert_same_answers(answers["host"], answers["device"], tol=1e-6)
    assert answers["auto"] == answers["host"]
    with pytest.raises(ValueError, match="backend"):
        tserving.Recommender.load(served["port_bundle"], device="cpu", backend="gpu")


def test_a_cascade_bundle_with_a_ranker_checkpoint_is_refused(served, tmp_path):
    """The port checks the bundle's kind before it loads anything: a cascade
    bundle brings its ranker, so ``--ranker-ckpt`` with one is an error
    that says so. The JAX package's ``serve`` reads ``--ranker-ckpt`` first
    (``cli.py:281-287``) and fails inside ``Recommender.load`` on the
    cascade bundle instead (ROADMAP queue 3, the reference's open faults)."""
    casc = tserving.build_cascade(served["port_bundle"], served["port_ranker"],
                                  served["ranker_config"], fetch=FETCH, device="cpu")
    path = casc.save(str(tmp_path / "cascade"))
    with pytest.raises(ValueError, match="is a cascade bundle"):
        tserving.build_cascade(path, served["port_ranker"], served["ranker_config"],
                               device="cpu")
    with pytest.raises(ValueError, match="is a cascade bundle"):
        cli(["serve", "--bundle", path, "--ranker-ckpt", served["port_ranker"],
             "--ranker-config", served["ranker_config"], "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ranker-config"):
        cli(["serve", "--bundle", served["port_bundle"], "--ranker-ckpt",
             served["port_ranker"], "--device", "cpu"])
    jpath = str(tmp_path / "jax_cascade")
    jserving.build_cascade(served["jax_bundle"], served["jax_ranker"], served["ranker_config"],
                           fetch=FETCH, backend="device").save(jpath)
    with pytest.raises(FileNotFoundError):
        jserving.build_cascade(jpath, served["jax_ranker"], served["ranker_config"])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_serve_composes_the_cascade_over_http(served, backend):
    """``python -m news_recsys_tpu_torch serve --ranker-ckpt --ranker-config
    --fetch --backend`` on the CPU: ``/healthz`` names the backend, and an
    answer equals the in-process cascade's."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "news_recsys_tpu_torch", "serve", "--bundle",
         served["port_bundle"], "--ranker-ckpt", served["port_ranker"], "--ranker-config",
         served["ranker_config"], "--fetch", str(FETCH), "--backend", backend,
         "--device", "cpu", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("Serving on http://"), line
        url = line.split()[-1]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "items": N_ITEMS, "backend": backend,
                          "cascade": True, "ranker": "dcn", "fetch": FETCH}
        batch = users(4, seed=5)
        body = {"users": {"user_id": batch["user_id"].tolist(), "hist": batch["hist"].tolist()},
                "k": 5, "histories": histories_of(batch)}
        req = urllib.request.Request(url + "/recommend", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    casc = tserving.build_cascade(served["port_bundle"], served["port_ranker"],
                                  served["ranker_config"], fetch=FETCH, backend=backend,
                                  device="cpu")
    want = casc.recommend(batch, k=5, histories=histories_of(batch))
    assert got["ids"] == want[0]
    np.testing.assert_allclose(got["scores"], want[1], rtol=1e-6)
