"""The port's prediction, validation and the cascade with a zoo ranker
against the JAX package's, on the CPU.

Same converted parameters, same dev set (users with several rows each, so
that GAUC and the warm/cold split mean something). Tolerances: 1e-5 on
sigmoid scores and on every validation metric of every cohort (the logits
agree to ~1e-6 at these widths; a metric moves by more only if two scores
within that of each other swap ranks); after two epochs of training with
validation, the states are held to rtol 1e-5 / atol 5e-5 as in
tests/test_torch_trainer.py and the metrics to 1e-4, since the scores then
differ by the training's own float32 drift. Cascade answers as in
tests/test_torch_serving.py.
"""

import importlib.util
import json
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu import serving as jserving
from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch import serving as tserving
from news_recsys_tpu_torch.convert import params_from_flax
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.trainer import Trainer

from tests.test_torch_cuda import train_dataset, zoo_train_cfg
from tests.test_torch_models import jax_init, small_dcn_raw, small_dssm_raw
from tests.test_torch_serving import (FETCH, HIST_LEN, N_ITEMS, REPO, assert_same_answers,
                                      histories_of, item_arrays, users)
from tests.test_torch_training import assert_states_close, jax_params
from tests.test_torch_zoo import ZOO

torch.set_num_threads(2)
TOL = 1e-5
BLOCK_NUMBER = re.compile(r"-?\d+\.\d{4}")


def dev_dataset(cfg, n_users: int = 32, rows: int = 8, seed: int = 0) -> PackedDataset:
    """``rows`` rows for each of ``n_users`` users, 30% positives."""
    ds = train_dataset(cfg, n_users * rows, seed=seed)
    rng = np.random.default_rng(seed + 100)
    uids = rng.choice(np.arange(1, 5000), n_users, replace=False).astype(np.int32)
    arrays = dict(ds.arrays)
    arrays["user_id"] = np.repeat(uids, rows)
    return PackedDataset(arrays)


def warm_users(ds) -> set:
    uids = np.unique(ds.arrays["user_id"])
    return {int(u) for u in uids[::2]}


def both_trainers(cfg, tmp_path, seed=0):
    """(JAX trainer, its params, port trainer on the converted params)."""
    ds = train_dataset(cfg, cfg.dataset.batch_size, seed=seed)
    params = jax_params(cfg, ds, seed=seed)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, cfg.name), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    port = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                   workdir=str(tmp_path / "port"), device="cpu")
    return jt, params, port


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_metrics_close(got, want, tol):
    assert sorted(got) == sorted(want) == ["Cold_Start", "Overall", "Warm_Start"]
    for cohort, w in want.items():
        assert sorted(got[cohort]) == sorted(w), cohort
        for key, value in w.items():
            np.testing.assert_allclose(got[cohort][key], value, rtol=0, atol=tol,
                                       err_msg=f"{cohort} {key}")


def assert_blocks_match(got: str, want: str, tol: float):
    """The same lines and keys; the numbers within ``tol`` (and the 4-digit
    rounding)."""
    assert BLOCK_NUMBER.sub("#", got) == BLOCK_NUMBER.sub("#", want)
    np.testing.assert_allclose([float(x) for x in BLOCK_NUMBER.findall(got)],
                               [float(x) for x in BLOCK_NUMBER.findall(want)],
                               rtol=0, atol=tol + 5e-5)


@pytest.mark.parametrize("batch_size", [None, 48])
def test_predict_matches_jax(tmp_path, batch_size):
    """300 rows: at batch 64 (the config's) and 48 the tail is padded."""
    cfg = zoo_train_cfg("deepfm", arena=False)
    jt, params, port = both_trainers(cfg, tmp_path)
    ds = train_dataset(cfg, 300, seed=5)
    got = port.predict(ds, batch_size=batch_size)
    assert got.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jt.predict(params, ds, batch_size=batch_size),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ZOO + ("dcn",))
def test_validate_matches_jax(monkeypatch, tmp_path, name):
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = zoo_train_cfg(name)
    jt, params, port = both_trainers(cfg, tmp_path)
    dev = dev_dataset(cfg, seed=1)
    warm = warm_users(dev)
    want = jt.validate(types.SimpleNamespace(params=params), dev, epoch=3, warm_user_set=warm)
    got = port.validate(port.init_state(), dev, epoch=3, warm_user_set=warm)
    assert_metrics_close(got, want, TOL)
    assert got["Warm_Start"]["User_Count"] == got["Cold_Start"]["User_Count"] == 16
    assert 0.0 < got["Overall"]["GAUC"] < 1.0
    assert_blocks_match((tmp_path / "port" / "val_log.log").read_text(),
                        (tmp_path / "jax" / "val_log.log").read_text(), TOL)
    (line,) = read_jsonl(port.metrics_path)
    (jline,) = read_jsonl(jt.metrics_path)
    assert list(line) == list(jline) == ["step", "epoch", "val_auc", "val_gauc", "val_ndcg10"]
    np.testing.assert_allclose([line[k] for k in line], [jline[k] for k in jline], atol=TOL)


def test_validate_refuses_another_model(tmp_path):
    cfg = zoo_train_cfg("fm")
    port = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path), device="cpu")
    other = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path / "other"),
                    device="cpu")
    with pytest.raises(ValueError, match="not this trainer's"):
        port.validate(other.init_state(), dev_dataset(cfg), epoch=0)


@pytest.mark.parametrize("val_freq,epochs", [(1, 2), (2, 3)])
def test_fit_validates_every_val_freq_epochs(monkeypatch, tmp_path, val_freq, epochs):
    """``fit(train, dev, warm_user_set)``: a block after epochs 0 and 1 at
    ``val_freq`` 1, after epoch 1 alone at ``val_freq`` 2 over 3 epochs."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = zoo_train_cfg("deepfm", arena=False, val_freq=val_freq)
    ds = train_dataset(cfg, 300, seed=8)
    dev = dev_dataset(cfg, seed=2)
    warm = warm_users(dev)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "deepfm"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    jstate = jax.device_get(jt.fit(ds, dev, warm, max_epochs=epochs))
    params = jax_params(cfg, ds, seed=cfg.train_hparams.seed)
    port = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                   workdir=str(tmp_path / "port"), device="cpu")
    state = port.fit(ds, dev, warm, max_epochs=epochs)
    assert_states_close(state, jstate, cfg, tol=dict(rtol=1e-5, atol=5e-5))
    got, want = (read_jsonl(tmp_path / d / "metrics.jsonl") for d in ("port", "jax"))
    got_val = [m for m in got if "val_auc" in m]
    want_val = [m for m in want if "val_auc" in m]
    validated = [e for e in range(epochs) if (e + 1) % val_freq == 0]
    assert [(m["step"], m["epoch"]) for m in got_val] == [(4 * (e + 1), e) for e in validated]
    assert [(m["step"], m["epoch"]) for m in want_val] == [(4 * (e + 1), e) for e in validated]
    for g, w in zip(got_val, want_val):
        for key in ("val_auc", "val_gauc", "val_ndcg10"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
    assert_blocks_match((tmp_path / "port" / "val_log.log").read_text(),
                        (tmp_path / "jax" / "val_log.log").read_text(), 1e-4)


# -- a cascade with a DeepFM ranker --------------------------------------------


@pytest.fixture(scope="module")
def deepfm_stacks():
    """(JAX cascade, port cascade): the DSSM recall of
    tests/test_torch_serving.py, a DeepFM ranker on 16-wide fields."""
    dcfg = config_from_dict(small_dssm_raw(HIST_LEN))
    rcfg = config_from_dict({**small_dcn_raw(), "name": "deepfm",
                             "embeddings": {**small_dcn_raw()["embeddings"],
                                            "init_scale": 0.03}})
    sample = {**users(8), **{k: v[:8] for k, v in item_arrays(N_ITEMS).items()}}
    jdssm, jranker = jbuild_dssm(dcfg), jbuild_ranker(rcfg, "deepfm")
    dparams, rparams = jax_init(jdssm, sample, seed=0), jax_init(jranker, sample, seed=2)
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


@pytest.mark.parametrize("mode", ["", "interpret"], ids=["xla", "pallas"])
def test_deepfm_cascade_matches_jax(monkeypatch, deepfm_stacks, mode):
    monkeypatch.setenv("NRT_PALLAS", mode)
    jcasc, tcasc = deepfm_stacks
    assert type(tcasc.ranker_model).__name__ == "DeepFMRanker"
    batch = users(16, seed=2)
    got = tcasc.recommend(batch, k=10, histories=histories_of(batch))
    assert_same_answers(got, jcasc.recommend(batch, k=10, histories=histories_of(batch)))
    for ids, scores, hist in zip(*got, histories_of(batch)):
        assert len(ids) == 10 and not set(ids) & set(hist)
        assert scores == sorted(scores, reverse=True)


def test_deepfm_cascade_bundle_and_export(monkeypatch, deepfm_stacks, tmp_path):
    """The port's bundle round trip, and ``scripts/export_torch_bundle.py``
    on the JAX cascade bundle, both serve the same answers."""
    monkeypatch.setenv("NRT_PALLAS", "")
    jcasc, tcasc = deepfm_stacks
    batch = users(8, seed=5)
    want = tcasc.recommend(batch, k=5, histories=histories_of(batch))
    loaded = tserving.CascadeRecommender.load(tcasc.save(str(tmp_path / "bundle")), device="cpu")
    assert type(loaded.ranker_model).__name__ == "DeepFMRanker"
    assert loaded.recommend(batch, k=5, histories=histories_of(batch)) == want
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle", os.path.join(REPO, "scripts", "export_torch_bundle.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.export(jcasc.save(str(tmp_path / "jax")), str(tmp_path / "torch"))
    assert_same_answers(tserving.CascadeRecommender.load(out, device="cpu").recommend(batch, k=6),
                        jcasc.recommend(batch, k=6))
