"""The port's ``Trainer`` and its sparse step at full MIND width, against
the JAX package's, on the CPU.

Same parameters (JAX init, converted), same data, same epoch permutation.
Tolerances: rtol = atol = 1e-5 on the states and the loss after three
steps (float32, other summation orders, see tests/test_torch_training.py).
After the two epochs (8 steps) the states are held to rtol 1e-5 and atol
5e-5: Adam divides each step by ``|g| + 1e-8``, so a weight whose gradient
cancels to near 1e-8 moves by a share of the lr on a tiny difference in
that gradient, and the error grows with the steps; the JAX package's own
two routes differ by up to 7.2e-6 on the tower after these 8 steps. The binned train AUC
to 2e-3: a probability within ~1e-7 of one of its 4,096 bin edges may land
in the next bin on the other side, which moves the estimate by about one
pair in the histogram's (positives x negatives).
"""

import json

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu.zoo import MIND_FEATURES, MIND_TABLE_SIZE
from news_recsys_tpu_torch.convert import params_from_flax
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.trainer import Trainer
from news_recsys_tpu_torch.zoo import mind_config

from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_training import (MODES, TOL, assert_states_close, jax_params, jax_train,
                                       port_state, port_train, step_indices)

torch.set_num_threads(2)


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", MODES)
def test_trainer_fit_matches_jax(monkeypatch, tmp_path, mode):
    """Two epochs of 4 steps (300 rows, batch 64: the tail is dropped)."""
    monkeypatch.setenv("NRT_PALLAS", mode)
    cfg = train_cfg(False)
    ds = train_dataset(cfg, 300, seed=8)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    jstate = jax.device_get(jt.fit(ds, max_epochs=2))
    params = jax_params(cfg, ds, seed=cfg.train_hparams.seed)     # the JAX trainer's init
    trainer = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                      workdir=str(tmp_path / "port"), device="cpu")
    state = trainer.fit(ds, max_epochs=2)
    assert trainer.global_step == jt.global_step == state.step == 8
    assert_states_close(state, jstate, cfg, tol=dict(rtol=1e-5, atol=5e-5))
    got, want = (read_metrics(tmp_path / d / "metrics.jsonl") for d in ("port", "jax"))
    assert [(m["step"], m["epoch"], m["steps"]) for m in got] == [(4, 0, 4), (8, 1, 4)]
    assert [(m["step"], m["epoch"], m["steps"]) for m in want] == [(4, 0, 4), (8, 1, 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], **TOL)
        np.testing.assert_allclose(g["train_auc"], w["train_auc"], atol=2e-3)
    log = (tmp_path / "port" / "train.log").read_text()
    assert log.count("Training Metrics:") == 2 and "  train_auc: " in log


def test_three_steps_at_full_mind_width(monkeypatch):
    """``mind_config("dcn", embedding_optimizer="rowwise_adagrad")``, batch
    512: arena_d32 159,360 x 32 (user 94,058 + item 65,239), three small
    AdamW tables, 1,024 arena slots a step; JAX on its XLA route."""
    cfg = mind_config("dcn", embedding_optimizer="rowwise_adagrad")
    rng = np.random.default_rng(9)
    n = 3 * cfg.dataset.batch_size
    arrays = {f: rng.integers(1, MIND_TABLE_SIZE[f], n).astype(np.int32) for f in MIND_FEATURES}
    arrays["label"] = (rng.random(n) < 0.1).astype(np.float32).reshape(-1, 1)
    ds = PackedDataset(arrays)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=0)
    idx = step_indices(ds, cfg, 3)
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state = port_state(cfg, params)
    assert state.model.embedder.tables["arena_d32"].shape == (159360, 32)
    state, _, loss = port_train(cfg, state, packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)
