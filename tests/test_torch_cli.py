"""The port's command line end to end on the CPU, at the size of
``tests/test_cli.py``: ``synth`` -> ``preprocess`` -> ``fe`` -> ``train``
(with step checkpoints and ``--resume``) -> ``predict``, all through
``news_recsys_tpu_torch.cli.main`` with ``--device cpu``.

``predict`` equals ``Trainer.predict`` on the same checkpoint bit for bit; a
run cut by ``max_step`` and resumed equals the straight run bit for bit; and
on a checkpoint the JAX package trained, converted by
``scripts/export_torch_checkpoint.py``, the port's ``predict`` writes the
JAX ``predict``'s rows with scores within 1e-5 (float32, other summation
orders). The DSSM and ``itemcf`` commands are in tests/test_torch_cli_dssm.py.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from news_recsys_tpu.cli import main as jax_cli
from news_recsys_tpu_torch.cli import main as cli
from news_recsys_tpu_torch.config import load_config
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.checkpoint import load_state
from news_recsys_tpu_torch.training.trainer import Trainer

from tests.test_torch_checkpoint import assert_equal_bits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS = ["user_id", "item_id", "category", "subcategory", "user_click_category"]
SCORE_TOL = 1e-5

torch.set_num_threads(2)


def write_config(path, tmp, **train):
    cfg = {
        "name": "deep",
        "paths": {"data_path": str(tmp / "Data"), "out_basedir": str(tmp / "tmp")},
        "features": {"feature_names": FEATS, "sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category", "subcategory"],
                     "user_feature_names": ["user_id", "user_click_category"]},
        "embeddings": {"embedding_size": {k: 8 for k in FEATS},
                       "embedding_table_size": {"user_id": 300, "item_id": 300, "category": 20,
                                                "subcategory": 200, "user_click_category": 20}},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 2, "lr": 3e-3, "min_lr": 1e-4,
                          "lr_milestones": [100, 300], "max_step": 5000, "val_freq": 1,
                          **train},
    }
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(tmp dir, config, config with step checkpoints every 4 steps, the
    same cut at step 10): data made by the port's synth, preprocess, fe."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = write_config(tmp / "cfg.yaml", tmp)
    ckpt = write_config(tmp / "ckpt.yaml", tmp, ckpt_every_steps=4)
    cut = write_config(tmp / "cut.yaml", tmp, ckpt_every_steps=4, max_step=10)
    cli(["synth", "--out", str(tmp / "Data"), "--news", "150", "--users", "60",
         "--train-impressions", "300", "--dev-impressions", "80"])
    cli(["preprocess", "-c", cfg])
    cli(["fe", "-c", cfg])
    return tmp, cfg, ckpt, cut


@pytest.fixture(scope="module")
def straight(workspace):
    """The experiment dir of ``train --epochs 2`` with step checkpoints."""
    tmp, _, ckpt, _ = workspace
    workdir = str(tmp / "exp_straight")
    cli(["train", "-c", ckpt, "--workdir", workdir, "--device", "cpu", "--epochs", "2"])
    return workdir


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_writes_the_experiment_dir(workspace, straight):
    tmp, _, ckpt, _ = workspace
    names = set(os.listdir(straight))
    assert {"ckpts", "model_info.log", "train.log", "val_log.log", "metrics.jsonl"} <= names
    assert any(n.startswith("events.out.tfevents.") for n in names)
    assert sorted(os.listdir(os.path.join(straight, "ckpts")))[:2] == ["epoch_000.pt",
                                                                       "epoch_001.pt"]
    steps = len(PackedDataset.open_split(load_config(ckpt), "train")) // 64
    assert sorted(os.listdir(os.path.join(straight, "ckpts", "steps"))) == [
        f"step_{s:09d}.pt" for s in range(4, 2 * steps + 1, 4)]
    assert open(os.path.join(straight, "val_log.log")).read().count("Validation Results") == 2
    metrics = read_jsonl(os.path.join(straight, "metrics.jsonl"))
    assert [m["epoch"] for m in metrics if "train_loss" in m] == [0, 1]
    assert all(np.isfinite(m["val_auc"]) for m in metrics if "val_auc" in m)


def test_predict_equals_trainer_predict(workspace, straight, tmp_path):
    tmp, cfg_path, _, _ = workspace
    out = str(tmp_path / "preds.jsonl")
    cli(["predict", "-c", cfg_path, "--checkpoint", straight, "--split", "dev", "--output", out,
         "--decode", "--device", "cpu", "--no-mesh"])
    rows = read_jsonl(out)
    cfg = load_config(cfg_path)
    dev = PackedDataset.open_split(cfg, "dev")
    assert len(rows) == len(dev)
    assert isinstance(rows[0]["category"], str)          # decoded to the raw value
    trainer = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path / "t"),
                      device="cpu")
    trainer.load_checkpoint(trainer.init_state(),
                            os.path.join(straight, "ckpts", "epoch_001.pt"))
    want = trainer.predict(dev)
    np.testing.assert_array_equal(np.array([r["score"] for r in rows], np.float32), want)
    # an explicit npz and no decode: ids stay ids
    cli(["predict", "-c", cfg_path, "--checkpoint", os.path.join(straight, "ckpts",
                                                                 "epoch_000.pt"),
         "--input", os.path.join(cfg.paths.out_basedir, "extractored_feature",
                                 "dev_features.npz"), "--output", out, "--device", "cpu"])
    rows = read_jsonl(out)
    assert [r["item_id"] for r in rows] == dev.arrays["item_id"].tolist()
    assert isinstance(rows[0]["category"], int)


def test_train_resume_continues_the_cut_run(workspace, straight):
    """``train`` cut at step 10 (step checkpoints at 4 and 8), then ``train
    --resume`` into the same dir with the uncut config: it resumes at step
    8, and its last epoch checkpoint equals the straight run's bit for bit."""
    tmp, _, ckpt, cut = workspace
    workdir = str(tmp / "exp_resumed")
    cli(["train", "-c", cut, "--workdir", workdir, "--device", "cpu", "--epochs", "2"])
    first = read_jsonl(os.path.join(workdir, "metrics.jsonl"))
    assert [(m["step"], m["steps"]) for m in first if "train_loss" in m] == [(10, 10)]
    cli(["train", "-c", ckpt, "--workdir", workdir, "--device", "cpu", "--epochs", "2",
         "--resume"])
    steps = len(PackedDataset.open_split(load_config(ckpt), "train")) // 64
    resumed = read_jsonl(os.path.join(workdir, "metrics.jsonl"))[len(first):]
    assert [(m["epoch"], m["steps"]) for m in resumed if "train_loss" in m] == [
        (0, steps - 8), (1, steps)]
    assert_equal_bits(load_state(os.path.join(workdir, "ckpts", "epoch_001.pt")),
                      load_state(os.path.join(straight, "ckpts", "epoch_001.pt")))


def test_predict_on_an_exported_jax_checkpoint(workspace, tmp_path):
    """JAX ``train`` + ``predict``; the checkpoint through
    ``scripts/export_torch_checkpoint.py``; the port's ``predict``: the same
    rows, scores within SCORE_TOL."""
    tmp, cfg_path, _, _ = workspace
    jdir = str(tmp_path / "jax_exp")
    jax_cli(["train", "-c", cfg_path, "--workdir", jdir, "--epochs", "1"])
    want_path, got_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jax_cli(["predict", "-c", cfg_path, "--checkpoint", jdir, "--output", want_path,
             "--decode", "--no-mesh"])
    pt = str(tmp_path / "port_exp" / "ckpts" / "epoch_000.pt")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "export_torch_checkpoint.py"),
                           "-c", cfg_path, "--checkpoint", jdir, "--out", pt],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == pt
    cli(["predict", "-c", cfg_path, "--checkpoint", str(tmp_path / "port_exp"), "--output",
         got_path, "--decode", "--device", "cpu"])
    got, want = read_jsonl(got_path), read_jsonl(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want],
                               rtol=0, atol=SCORE_TOL)
    # the port reads no msgpack: it names the script instead
    for target in (jdir, glob.glob(os.path.join(jdir, "ckpts", "epoch_*.msgpack"))[0]):
        with pytest.raises(SystemExit, match="export_torch_checkpoint.py"):
            cli(["predict", "-c", cfg_path, "--checkpoint", target, "--device", "cpu"])


def test_train_mixes_random_negatives(workspace, tmp_path):
    """``rank_cfg.random_neg_per_positive`` adds that many label-0 rows a
    positive to the train split (``data/hist_pairs.py``), as the JAX
    package's ``train`` does."""
    tmp, cfg_path, _, _ = workspace
    doc = yaml.safe_load(open(cfg_path))
    doc["rank_cfg"] = {"random_neg_per_positive": 2}
    path = tmp_path / "rneg.yaml"
    path.write_text(yaml.safe_dump(doc))
    workdir = str(tmp_path / "exp")
    cli(["train", "-c", str(path), "--workdir", workdir, "--device", "cpu", "--epochs", "1"])
    train = PackedDataset.open_split(load_config(str(path)), "train")
    rows = len(train) + 2 * int(train.arrays["label"].sum())
    (trained,) = [m for m in read_jsonl(os.path.join(workdir, "metrics.jsonl"))
                  if "train_loss" in m]
    assert trained["steps"] == rows // 64 > len(train) // 64


@pytest.mark.parametrize("train,mesh", [
    ({"embedding_optimizer": "sparse_adamw"}, {}),
    ({"embedding_optimizer": "rowwise_adagrad", "embedding_update_period": 4}, {}),
    ({"embedding_optimizer": "rowwise_adagrad"},
     {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}),
], ids=["sparse_adamw", "K4", "bf16"])
def test_train_runs_each_optimizer_variant(workspace, tmp_path, train, mesh):
    """``train`` of a config on each of the sparse step's optimizer
    settings (the user and item tables made large enough for the rowwise
    path): its epoch checkpoint carries the variant's state (Adam's (V, D)
    moments; the apply counter, nothing pending; bfloat16 tables), and
    ``predict`` reads it back."""
    tmp, cfg_path, _, _ = workspace
    doc = yaml.safe_load(open(cfg_path))
    doc["embeddings"]["embedding_table_size"].update(user_id=5000, item_id=5000)
    doc["train_hparams"].update(train)
    doc["mesh"] = mesh
    path = tmp_path / "variant.yaml"
    path.write_text(yaml.safe_dump(doc))
    workdir = str(tmp_path / "exp")
    cli(["train", "-c", str(path), "--workdir", workdir, "--device", "cpu", "--epochs", "1"])
    (trained,) = [m for m in read_jsonl(os.path.join(workdir, "metrics.jsonl"))
                  if "train_loss" in m]
    assert np.isfinite(trained["train_loss"])
    blob = load_state(os.path.join(workdir, "ckpts", "epoch_000.pt"))
    assert blob["kind"] == "sparse" and blob["step"] == trained["steps"]
    tables = {k: t for k, t in blob["model"].items() if k.startswith("embedder.tables.")}
    large = {"embedder.tables.user_id", "embedder.tables.item_id"}
    if "sparse_adamw" in train.values():
        assert blob["emb_acc"] == {} and sorted(blob["emb_mu"]) == ["item_id", "user_id"]
        assert blob["emb_nu"]["user_id"].shape == tables["embedder.tables.user_id"].shape
    if train.get("embedding_update_period") == 4:
        assert blob["applies"] == -(-trained["steps"] // 4)
    want = torch.bfloat16 if mesh else torch.float32
    assert all(t.dtype == (want if k in large else torch.float32) for k, t in tables.items())
    out = str(tmp_path / "preds.jsonl")
    cli(["predict", "-c", str(path), "--checkpoint", workdir, "--split", "dev", "--output", out,
         "--device", "cpu", "--no-mesh"])
    scores = [r["score"] for r in read_jsonl(out)]
    assert len(scores) == len(PackedDataset.open_split(load_config(str(path)), "dev"))
    assert np.isfinite(scores).all()


def test_missing_card_is_an_error(workspace, straight, tmp_path):
    """``--device cuda`` (the default) with no card exits non-zero; nothing
    runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda would run")
    _, cfg_path, _, _ = workspace
    for argv in (["train", "-c", cfg_path, "--workdir", str(tmp_path / "w")],
                 ["train", "-c", cfg_path, "-m", "dssm", "--workdir", str(tmp_path / "w")],
                 ["predict", "-c", cfg_path, "--checkpoint", straight, "--output",
                  str(tmp_path / "p.jsonl")]):
        proc = subprocess.run([sys.executable, "-m", "news_recsys_tpu_torch", *argv],
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA GPU is visible" in proc.stderr
    assert not os.path.exists(tmp_path / "w") and not os.path.exists(tmp_path / "p.jsonl")
