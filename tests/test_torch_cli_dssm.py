"""The port's DSSM and ItemCF commands end to end on the CPU, on the synth
data of ``tests/test_torch_cli.py``'s workspace: ``preprocess`` and ``fe``
of ``configs/dssm.yaml``'s features (its tables cut to the synth ids), then
``train`` (a ``Retrieval:`` block an epoch, weights-only epoch checkpoints,
``retrieval_eval.json``, a serving bundle), a run cut by ``max_step`` and
resumed (bit for bit the straight run: the negatives are keyed by the
global step), ``predict -m dssm`` on a JAX checkpoint converted by
``scripts/export_torch_checkpoint.py`` (tower embeddings, rounded to 6
places as JAX rounds them, and cosines within 1e-5), and ``itemcf``, whose
``metrics.json`` equals the JAX command's but for its wall times.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from news_recsys_tpu.cli import main as jax_cli
from news_recsys_tpu_torch.cli import main as cli
from news_recsys_tpu_torch.config import load_config
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.training.checkpoint import load_state

from tests.test_torch_checkpoint import assert_equal_bits
from tests.test_torch_cli import REPO, SCORE_TOL, read_jsonl, workspace  # noqa: F401


# -- the DSSM and ItemCF ---------------------------------------------------------


def write_dssm_config(path, tmp, **train):
    """``configs/dssm.yaml`` with its paths in ``tmp`` (the workspace's synth
    data, its own preprocess and fe output), the tables cut to the synth ids
    and batch 64; the features (``hist`` of 30 over the item table) and
    ``dssm_cfg`` (rate 8, ``hist_augment``, ``logq_correction``) as shipped."""
    doc = yaml.safe_load(open(os.path.join(REPO, "configs", "dssm.yaml")))
    doc["paths"] = {"data_path": str(tmp / "Data"), "out_basedir": str(tmp / "dssm_out")}
    doc["embeddings"]["embedding_table_size"] = {
        "user_id": 300, "item_id": 300, "category": 20, "subcategory": 200,
        "user_click_category": 20}
    doc["dataset"]["batch_size"] = 64
    doc["train_hparams"].update(max_epoch=2, ckpt_every_steps=4, **train)
    path.write_text(yaml.safe_dump(doc))
    return str(path)


@pytest.fixture(scope="module")
def dssm_workspace(workspace):
    """(config, the same cut at step 10, the experiment dir of ``train
    --epochs 2``): ``preprocess`` and ``fe`` of the DSSM's features on the
    workspace's synth data."""
    tmp = workspace[0]
    cfg = write_dssm_config(tmp / "dssm.yaml", tmp)
    cut = write_dssm_config(tmp / "dssm_cut.yaml", tmp, max_step=10)
    cli(["preprocess", "-c", cfg])
    cli(["fe", "-c", cfg])
    straight = str(tmp / "dssm_straight")
    cli(["train", "-c", cfg, "--workdir", straight, "--device", "cpu", "--epochs", "2"])
    return cfg, cut, straight


def test_dssm_train_writes_the_retrieval_run(dssm_workspace):
    """``train`` of the DSSM: a ``Retrieval:`` block an epoch, weights-only
    epoch checkpoints, ``retrieval_eval.json`` equal to the last epoch's
    HR@10, and a bundle that ``Recommender.load`` answers from."""
    from news_recsys_tpu_torch.serving import Recommender

    cfg_path, _, straight = dssm_workspace
    names = set(os.listdir(straight))
    assert {"ckpts", "bundle", "retrieval_eval.json", "model_info.log", "train.log",
            "val_log.log", "metrics.jsonl"} <= names
    assert open(os.path.join(straight, "val_log.log")).read().count("Retrieval:") == 2
    res = json.load(open(os.path.join(straight, "retrieval_eval.json")))
    metrics = read_jsonl(os.path.join(straight, "metrics.jsonl"))
    vals = [m for m in metrics if "val_hr_at_10" in m]
    assert set(res) == {"HR@10", "num_queries"} and res["num_queries"] > 0
    assert [m["val_hr_at_10"] for m in vals][-1] == res["HR@10"]
    assert all("train_auc" not in m for m in metrics)
    for epoch in (0, 1):
        blob = load_state(os.path.join(straight, "ckpts", f"epoch_{epoch:03d}.pt"))
        assert blob["kind"] == "weights"
    rec = Recommender.load(os.path.join(straight, "bundle"), device="cpu")
    dev = PackedDataset.open_split(load_config(cfg_path), "dev")
    users = {k: v[:5] for k, v in dev.arrays.items()}
    ids, scores = rec.recommend(users, k=10, histories=[list(h[h > 0]) for h in users["hist"]])
    assert [len(r) for r in ids] == [10] * 5
    assert all(np.all(np.diff(s) <= 0) for s in scores)


def test_dssm_train_resume_equals_the_straight_run(dssm_workspace, tmp_path):
    """The DSSM cut at step 10 (step checkpoints at 4 and 8) and resumed: its
    ``epoch_001.pt`` equals the straight run's bit for bit, the negatives
    being keyed by the global step."""
    cfg_path, cut, straight = dssm_workspace
    workdir = str(tmp_path / "resumed")
    cli(["train", "-c", cut, "--workdir", workdir, "--device", "cpu", "--epochs", "2"])
    cli(["train", "-c", cfg_path, "--workdir", workdir, "--device", "cpu", "--epochs", "2",
         "--resume"])
    trained = [m for m in read_jsonl(os.path.join(workdir, "metrics.jsonl")) if "train_loss" in m]
    straight_steps = [m["steps"] for m in read_jsonl(os.path.join(straight, "metrics.jsonl"))
                      if "train_loss" in m]
    assert [m["steps"] for m in trained] == [10, straight_steps[0] - 8, straight_steps[1]]
    assert_equal_bits(load_state(os.path.join(workdir, "ckpts", "epoch_001.pt")),
                      load_state(os.path.join(straight, "ckpts", "epoch_001.pt")))


def test_dssm_predict_on_an_exported_jax_checkpoint(dssm_workspace, tmp_path):
    """JAX ``train`` and ``predict -m dssm``; its weights-only msgpack
    through ``scripts/export_torch_checkpoint.py``; the port's ``predict``:
    the same rows, embeddings and cosines within SCORE_TOL."""
    cfg_path = dssm_workspace[0]
    jdir = str(tmp_path / "jax_exp")
    jax_cli(["train", "-c", cfg_path, "--workdir", jdir, "--epochs", "1"])
    want_path, got_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jax_cli(["predict", "-c", cfg_path, "-m", "dssm", "--checkpoint", jdir, "--output",
             want_path, "--decode", "--no-mesh"])
    pt = str(tmp_path / "port_exp" / "ckpts" / "epoch_000.pt")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "export_torch_checkpoint.py"),
                           "-c", cfg_path, "--checkpoint", jdir, "--out", pt],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    assert load_state(pt)["kind"] == "weights"
    cli(["predict", "-c", cfg_path, "-m", "dssm", "--checkpoint", str(tmp_path / "port_exp"),
         "--output", got_path, "--decode", "--device", "cpu"])
    got, want = read_jsonl(got_path), read_jsonl(want_path)
    assert len(got) == len(want) > 0
    emb = ("user_embedding", "item_embedding", "score")
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in emb} == \
            {k: v for k, v in w.items() if k not in emb}
    for key in emb:
        np.testing.assert_allclose([g[key] for g in got], [w[key] for w in want],
                                   rtol=0, atol=SCORE_TOL, err_msg=key)


def test_dev_histories_equal_jax(dssm_workspace):
    from news_recsys_tpu.cli import _dev_histories as jax_dev_histories
    from news_recsys_tpu.config import load_config as jax_load_config
    from news_recsys_tpu_torch.cli import _dev_histories

    cfg_path = dssm_workspace[0]
    cfg = load_config(cfg_path)
    labels = PackedDataset.open_split(cfg, "dev").arrays["label"][:, 0]
    for mask in (labels == 1, np.ones(len(labels), bool)):
        got = _dev_histories(cfg, mask)
        assert got == jax_dev_histories(jax_load_config(cfg_path), mask)
        assert len(got) == int(mask.sum()) and any(got) and not all(got)


@pytest.mark.parametrize("flags", [[], ["--max-queries", "20", "--k", "5,10,20"],
                                   ["--max-queries", "0", "--neighbors", "3",
                                    "--max-history", "4"]])
def test_itemcf_writes_the_jax_metrics(dssm_workspace, flags):
    """``itemcf`` writes the JAX command's ``metrics.json`` (the same queries,
    drawn as ``DataFrame.sample`` draws them), but for its wall times."""
    cfg_path = dssm_workspace[0]
    path = os.path.join(load_config(cfg_path).paths.out_basedir, "itemcf", "metrics.json")
    jax_cli(["itemcf", "-c", cfg_path, *flags])
    want = json.load(open(path))
    os.remove(path)
    cli(["itemcf", "-c", cfg_path, *flags])
    got = json.load(open(path))
    timed = {"fit_seconds", "eval_seconds"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert got["queries"] == (20 if "20" in flags else want["queries"]) > 0
