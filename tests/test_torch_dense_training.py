"""The port's all-dense AdamW training step (``embedding_optimizer="adamw"``)
and its ``Trainer`` path against the JAX package's, on the CPU.

Both sides start from the same parameters (JAX init, converted) and train on
the same packed batches: JAX through ``make_train_step`` (optax ``adamw``
over the whole tree), the port through ``training.dense_step`` (one
``torch.optim.AdamW`` over every parameter, tables included). The port's
pooled array features go through ``fused_lookup_pool``, whose backward on
the CPU is ``pool_bwd_plain``.

Tolerances: rtol = atol = 1e-5 on parameters, moments and the loss after 1-3
float32 steps (other summation orders; optax and torch round AdamW's step
differently); after ``Trainer.fit``'s 8 steps rtol 1e-5, atol 5e-5, as in
tests/test_torch_trainer.py (Adam divides by ``|g| + 1e-8``, which amplifies
rounding where a gradient cancels); the binned train AUC 2e-3 (a
probability at a bin edge may land in the next bin).
"""

import json

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch import zoo as tzoo
from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
from news_recsys_tpu_torch.convert import (dense_state_from_jax, dense_state_to_jax,
                                           flatten_dense_state, params_from_flax)
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
from news_recsys_tpu_torch.training import dense_step as tds
from news_recsys_tpu_torch.training.trainer import AucHist, Trainer

from tests.test_torch_attention import attention_batch
from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_models import jax_init
from tests.test_torch_training import TOL, port_batches, step_indices
from tests.test_torch_validation import warm_users

torch.set_num_threads(2)


def dcn_cfg(**train):
    """tests/test_torch_cuda.py's narrow DCN with a pooled ``hist``, on adamw."""
    return train_cfg(False, embedding_optimizer="adamw", **train)


def attention_adamw_cfg(batch_size=64):
    """The shipped ``configs/attention.yaml`` recipe at full width."""
    raw = config_to_dict(tzoo.mind_ranker_config("attention@adamw"))
    raw["dataset"]["batch_size"] = batch_size
    return config_from_dict(raw)


def dataset_for(cfg, n, seed):
    if cfg.name == "attention":
        return PackedDataset(attention_batch(cfg, n, seed))
    return train_dataset(cfg, n, seed)


def jax_state(cfg, params):
    model = jbuild_ranker(cfg, cfg.name)
    return model, jtrainer.TrainState.create(apply_fn=model.apply, params=params,
                                             tx=jtrainer.make_optimizer(cfg))


def jax_dense_train(cfg, state_or_params, packer, idx):
    """``make_train_step`` over the rows ``idx`` (steps, B); returns the
    state (numpy leaves), the AUC histogram and the last loss."""
    model, state = jax_state(cfg, state_or_params) if isinstance(state_or_params, dict) \
        else (jbuild_ranker(cfg, cfg.name), state_or_params)
    step = jtrainer.make_train_step(model, None)
    hist = jtrainer.AucHist.zeros()
    ones = np.ones(idx.shape[1], np.float32)
    for rows in idx:
        batch = unpack_batch(packer.int_mat[rows], packer.float_mat[rows], ones,
                             packer.layout_key())
        state, hist, loss = step(state, hist, batch)
    return jax.device_get(state), jax.device_get(hist), float(loss)


def port_dense_train(cfg, state, packer, idx):
    step = tds.make_train_step(state.model, cfg)
    hist = AucHist.zeros("cpu")
    loss = None
    for batch in port_batches(packer, idx):
        loss, _ = step(state, batch, hist)
    return state, hist, float(loss)


def port_dense_state(cfg, params):
    return tds.init_dense_state(params_from_flax(params, build_ranker(cfg, device="cpu")), cfg)


def assert_dense_states_close(port, jstate, tol=TOL):
    got, want = dense_state_to_jax(port), flatten_dense_state(jstate)
    assert sorted(got["params"]) == sorted(want["params"])
    for path, w in want["params"].items():
        np.testing.assert_allclose(got["params"][path], w, err_msg=path, **tol)
    for key in ("mu", "nu"):
        assert sorted(got["opt"][key]) == sorted(want["opt"][key])
        for path, w in want["opt"][key].items():
            np.testing.assert_allclose(got["opt"][key][path], w, err_msg=f"{key} {path}", **tol)
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    assert int(got["step"]) == int(want["step"])


CONFIGS = {"dcn": dcn_cfg, "attention@adamw": attention_adamw_cfg}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_dense_steps_match_jax(monkeypatch, which, steps):
    """DCN with a pooled history, and the attention ranker of
    ``configs/attention.yaml`` at full width (user 94,080 x 32, item
    65,280 x 32, entities 30,080 x 16, all under AdamW)."""
    monkeypatch.setenv("NRT_PALLAS", "")
    monkeypatch.setenv("NRT_FUSED_ATTN", "off")
    cfg = CONFIGS[which]()
    bs = cfg.dataset.batch_size
    ds = dataset_for(cfg, steps * bs, seed=3)
    packer = BatchPacker(ds)
    params = jax_init(jbuild_ranker(cfg, cfg.name), ds.take(np.arange(bs)))
    idx = step_indices(ds, cfg, steps)
    jstate, jhist, jloss = jax_dense_train(cfg, params, packer, idx)
    state, hist, loss = port_dense_train(cfg, port_dense_state(cfg, params), packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_dense_states_close(state, jstate)
    assert state.step == steps
    assert len(state.opt.param_groups) == 1
    assert len(state.opt.param_groups[0]["params"]) == len(list(state.model.parameters()))
    np.testing.assert_allclose((hist.pos + hist.neg).sum().item(),
                               float(np.asarray(jhist.pos).sum() + np.asarray(jhist.neg).sum()))


def test_dense_step_trains_the_pooled_table_through_the_pool(monkeypatch):
    """The pooled ``entities`` reach ``fused_lookup_pool`` and its backward:
    after a step the touched entity rows moved."""
    cfg = attention_adamw_cfg()
    calls = []
    import news_recsys_tpu_torch.models.embedding as emb

    def counted(*args):
        calls.append(args[1].shape)
        return fused_lookup_pool(*args)

    monkeypatch.setattr(emb, "fused_lookup_pool", counted)
    model = build_ranker(cfg, seed=1, device="cpu")
    before = model.embedder.tables["entities"].detach().clone()
    ds = dataset_for(cfg, 64, seed=5)
    packer = BatchPacker(ds)
    state = tds.init_dense_state(model, cfg)
    port_dense_train(cfg, state, packer, step_indices(ds, cfg, 1))
    assert calls == [(64, 5)]
    moved = (model.embedder.tables["entities"].detach() != before).any(dim=1)
    touched = np.unique(ds.arrays["entities"])
    assert moved[torch.from_numpy(touched[touched > 0]).long()].all()


def test_jax_dense_state_continues_in_the_port(monkeypatch):
    """JAX trains 2 steps; the port takes its state through ``convert`` and
    trains 2 more; the result equals JAX's 4 steps. And the state round-trips."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = dcn_cfg()
    ds = dataset_for(cfg, 256, seed=5)
    packer = BatchPacker(ds)
    params = jax_init(jbuild_ranker(cfg, "dcn"), ds.take(np.arange(64)), seed=2)
    idx = step_indices(ds, cfg, 4)
    s2, _, _ = jax_dense_train(cfg, params, packer, idx[:2])
    state = dense_state_from_jax(s2, build_ranker(cfg, device="cpu"), cfg)
    got, want = dense_state_to_jax(state), flatten_dense_state(s2)
    for k, v in want["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    for key in ("mu", "nu"):
        for k, v in want["opt"][key].items():
            np.testing.assert_array_equal(got["opt"][key][k], v, err_msg=k)
    assert int(got["opt"]["count"]) == int(got["step"]) == 2
    again = dense_state_to_jax(dense_state_from_jax(got, build_ranker(cfg, device="cpu"), cfg))
    for k, v in got["opt"]["nu"].items():
        np.testing.assert_array_equal(again["opt"]["nu"][k], v, err_msg=k)
    _, s2_live = jax_state(cfg, params)
    s2_live = s2_live.replace(step=s2.step, params=s2.params, opt_state=s2.opt_state)
    s4, _, jloss = jax_dense_train(cfg, s2_live, packer, idx[2:])
    state, _, loss = port_dense_train(cfg, state, packer, idx[2:])
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_dense_states_close(state, s4)


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("which", list(CONFIGS))
def test_trainer_fit_on_the_dense_path_matches_jax(monkeypatch, tmp_path, which):
    """Two epochs of 4 steps (300 rows, batch 64: the tail is dropped), with
    a validation after each, on ``Trainer``'s dense path."""
    monkeypatch.setenv("NRT_PALLAS", "")
    monkeypatch.setenv("NRT_FUSED_ATTN", "off")
    cfg = CONFIGS[which]()
    ds = dataset_for(cfg, 300, seed=8)
    dev = dataset_for(cfg, 96, seed=9)
    warm = warm_users(ds)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, cfg.name), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    assert not jt.sparse_embeddings
    jstate = jax.device_get(jt.fit(ds, dev, warm, max_epochs=2))
    params = jax_init(jbuild_ranker(cfg, cfg.name), ds.take(np.arange(64)),
                      seed=cfg.train_hparams.seed)                  # the JAX trainer's init
    trainer = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                      workdir=str(tmp_path / "port"), device="cpu")
    assert not trainer.sparse_embeddings
    state = trainer.fit(ds, dev, warm, max_epochs=2)
    assert isinstance(state, tds.DenseTrainState)
    assert trainer.global_step == jt.global_step == state.step == 8
    assert_dense_states_close(state, jstate, tol=dict(rtol=1e-5, atol=5e-5))
    got, want = (read_metrics(tmp_path / d / "metrics.jsonl") for d in ("port", "jax"))
    got_train, want_train = ([m for m in ms if "train_loss" in m] for ms in (got, want))
    assert [(m["step"], m["epoch"], m["steps"]) for m in got_train] == [(4, 0, 4), (8, 1, 4)]
    for g, w in zip(got_train, want_train):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], **TOL)
        np.testing.assert_allclose(g["train_auc"], w["train_auc"], atol=2e-3)
    got_val, want_val = ([m for m in ms if "val_auc" in m] for ms in (got, want))
    assert len(got_val) == len(want_val) == 2
    for g, w in zip(got_val, want_val):
        for key in ("val_auc", "val_gauc", "val_ndcg10"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
    # predict and validate work on the dense state
    scores = trainer.predict(dev)
    assert scores.shape == (96,) and np.isfinite(scores).all()
    results = trainer.validate(state, dev, 2, warm)
    np.testing.assert_allclose(results["Overall"]["AUC"], got_val[-1]["val_auc"], atol=1e-12)


def test_dense_step_refuses_the_rowwise_optimizer():
    cfg = train_cfg(False)                       # rowwise_adagrad
    model = build_ranker(cfg, device="cpu")
    with pytest.raises(ValueError, match="sparse step"):
        tds.make_train_step(model, cfg)
    with pytest.raises(ValueError, match="sparse step"):
        tds.init_dense_state(model, cfg)
    with pytest.raises(ValueError, match="sparse step"):
        tds.init_dense_state(model, train_cfg(False, embedding_optimizer="sparse_adamw"))


def test_dense_state_after_sparse_state_requires_grad_again():
    """``init_sparse_state`` freezes the large tables; ``init_dense_state``
    on the same model makes every parameter train again."""
    from news_recsys_tpu_torch.training.sparse_step import init_sparse_state

    model = build_ranker(train_cfg(False), device="cpu")
    init_sparse_state(model, train_cfg(False))
    assert not model.embedder.tables["user_id"].requires_grad
    tds.init_dense_state(model, dcn_cfg())
    assert all(p.requires_grad for p in model.parameters())
