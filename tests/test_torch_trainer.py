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

from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset, iterate_batches
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu.zoo import MIND_FEATURES, MIND_TABLE_SIZE
from news_recsys_tpu_torch.convert import (dense_state_from_jax, params_from_flax,
                                           sparse_state_from_jax)
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.trainer import Trainer
from news_recsys_tpu_torch.zoo import mind_config

from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_dense_training import assert_dense_states_close
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


# the sparse step, and the all-dense one (embedding_optimizer "adamw")
STEPS = {"sparse": lambda: train_cfg(False),
         "dense": lambda: train_cfg(False, embedding_optimizer="adamw")}


def jax_trainer_and_state(cfg, ds, workdir):
    """The JAX trainer and its initial state, and the same state converted
    into a port ``Trainer`` on the CPU."""
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(workdir / "jax"),
                          use_mesh=False)
    jstate = jt.init_state(next(iterate_batches(ds, cfg.dataset.batch_size, shuffle=False)))
    trainer = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(workdir / "port"),
                      device="cpu")
    convert = sparse_state_from_jax if trainer.sparse_embeddings else dense_state_from_jax
    return jt, jstate, trainer, convert(jax.device_get(jstate), trainer.model, cfg)


def assert_close_to_jax(state, jstate, cfg, tol=TOL):
    if cfg.train_hparams.embedding_optimizer == "adamw":
        assert_dense_states_close(state, jax.device_get(jstate), tol=tol)
    else:
        assert_states_close(state, jax.device_get(jstate), cfg, tol=tol)


@pytest.mark.parametrize("skip", [0, 1, 3, 9])
@pytest.mark.parametrize("step", list(STEPS))
def test_train_epoch_skip_steps_matches_jax(monkeypatch, tmp_path, step, skip):
    """``train_epoch(skip_steps=k)`` leaves out the first k batches of the
    epoch's permutation, as the JAX trainer's does (300 rows, batch 64: 4
    batches; 9 skips them all), from a JAX state converted into the port."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = STEPS[step]()
    ds = train_dataset(cfg, 300, seed=10)
    jt, jstate, trainer, state = jax_trainer_and_state(cfg, ds, tmp_path)
    jstate, jm = jt.train_epoch(jstate, ds, 1, skip_steps=skip)
    state, m = trainer.train_epoch(state, ds, 1, skip_steps=skip)
    assert m["steps"] == jm["steps"] == max(0, 4 - skip)
    assert trainer.global_step == jt.global_step == state.step == m["steps"]
    assert_close_to_jax(state, jstate, cfg)
    if m["steps"]:
        np.testing.assert_allclose(m["train_loss"], jm["train_loss"], **TOL)


@pytest.mark.parametrize("step", list(STEPS))
def test_fit_continues_from_a_given_state(monkeypatch, tmp_path, step):
    """``fit(state=s)`` trains ``s`` (here a JAX state after 3 steps,
    converted) and not a fresh ``init_state()``: it ends where JAX's
    ``fit(state=s)`` ends."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = STEPS[step]()
    ds = train_dataset(cfg, 300, seed=11)
    jt, jstate, trainer, _ = jax_trainer_and_state(cfg, ds, tmp_path)
    jstate, _ = jt.train_epoch(jstate, ds, 0, skip_steps=1)
    convert = sparse_state_from_jax if trainer.sparse_embeddings else dense_state_from_jax
    state = convert(jax.device_get(jstate), trainer.model, cfg)
    assert state.step == 3
    want = jax.device_get(jt.fit(ds, state=jstate, max_epochs=1))
    got = trainer.fit(ds, state=state, max_epochs=1)
    assert got is state and got.step == 7
    assert_close_to_jax(got, want, cfg)
    other = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path / "other"),
                    device="cpu")
    with pytest.raises(ValueError, match="not this trainer's"):
        other.fit(ds, state=state, max_epochs=1)

