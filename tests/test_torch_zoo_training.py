"""The port's sparse training step on each ranker of the zoo against the JAX
package's ``make_sparse_chunk_fn`` (K = 1), on the CPU.

Both sides start from the same parameters (JAX init, converted) and train
on the same packed batches; the helpers and the comparison of states are
those of tests/test_torch_training.py. Tolerances: rtol = atol = 1e-5 on
the states after one step; rtol 1e-5 and atol 5e-5 after DeepFM's 8 steps,
for the reason tests/test_torch_trainer.py gives (Adam divides by
``|g| + 1e-8``, so the differences grow with the steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.config import config_from_dict, config_to_dict
from news_recsys_tpu.data.packed_dataset import BatchPacker
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch.convert import (flatten_sparse_state, sparse_state_from_jax,
                                           sparse_state_to_jax)
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import sparse_step as tss

from tests.test_torch_cuda import train_dataset, zoo_train_cfg
from tests.test_torch_training import (MODES, TOL, assert_states_close, jax_params, jax_train,
                                       port_state, port_train, step_indices)
from tests.test_torch_zoo import ZOO

torch.set_num_threads(2)


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "tables"])
@pytest.mark.parametrize("name", ZOO)
def test_one_sparse_step_matches_jax(monkeypatch, name, arena):
    """Arena on: LR's scatter runs on a table of width 1 (``arena_d1``),
    Wide&Deep's small tables are 9 wide, DeepFM's ``bias`` joins AdamW.
    Arena off: two large tables of their own widths (the joint dedup) and a
    pooled click history."""
    cfg = zoo_train_cfg(name, arena)
    ds = train_dataset(cfg, 128, seed=3)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=0)
    idx = step_indices(ds, cfg, 1)
    jstate, jhist, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state, hist, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)
    np.testing.assert_array_equal(hist.pos.numpy() + hist.neg.numpy(),
                                  np.asarray(jhist.pos) + np.asarray(jhist.neg))


@pytest.mark.parametrize("mode", MODES)
def test_deepfm_eight_steps_match_jax(monkeypatch, mode):
    """JAX on its XLA route and on its Pallas route (FM and the row scatter
    interpreted)."""
    cfg = zoo_train_cfg("deepfm", arena=False)
    ds = train_dataset(cfg, 512, seed=4)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=1)
    idx = step_indices(ds, cfg, 8)
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch, mode)
    state, _, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg, tol=dict(rtol=1e-5, atol=5e-5))


@pytest.mark.parametrize("name", ZOO)
def test_sparse_state_round_trip(monkeypatch, name):
    """A JAX state after one step, into the port and back, bit for bit;
    then the port's 2nd step equals JAX's."""
    cfg = zoo_train_cfg(name)
    ds = train_dataset(cfg, 128, seed=6)
    packer = BatchPacker(ds)
    idx = step_indices(ds, cfg, 2)
    s1, _, _ = jax_train(cfg, jax_params(cfg, ds, seed=3), packer, idx[:1], monkeypatch)
    want = flatten_sparse_state(s1)
    state = sparse_state_from_jax(s1, build_ranker(cfg, device="cpu"), cfg)
    got = sparse_state_to_jax(state)
    for section in ("params", "emb_mu"):
        assert sorted(got[section]) == sorted(want[section])
        for k, v in want[section].items():
            np.testing.assert_array_equal(got[section][k], v, err_msg=k)
    for key in ("mu", "nu"):
        assert sorted(got["dense_opt"][key]) == sorted(want["dense_opt"][key])
        for k, v in want["dense_opt"][key].items():
            np.testing.assert_array_equal(got["dense_opt"][key][k], v, err_msg=k)
    assert int(got["dense_opt"]["count"]) == int(got["step"]) == 1
    s2, _, jloss = jax_train(cfg, s1, packer, idx[1:], monkeypatch)
    state, _, loss = port_train(cfg, state, packer, idx[1:])
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, s2, cfg)


def all_large_lr_cfg():
    """LR over the user and item ids alone: every table is large, so AdamW
    has nothing to step."""
    raw = config_to_dict(zoo_train_cfg("lr"))
    feats = raw["features"]
    for key in ("feature_names", "sparse_feature_names", "item_feature_names"):
        feats[key] = [f for f in feats[key] if f in ("user_id", "item_id")]
    for key in ("embedding_size", "embedding_table_size"):
        raw["embeddings"][key] = {f: raw["embeddings"][key][f] for f in ("user_id", "item_id")}
    raw.pop("wide_and_deep_cfg")
    return config_from_dict(raw)


def test_lr_with_only_large_tables_trains_as_jax(monkeypatch):
    cfg = all_large_lr_cfg()
    tables = build_ranker(cfg, device="cpu").tables
    assert all(v >= tss.SMALL_VOCAB_THRESHOLD for v, _ in tables.values())
    ds = train_dataset(cfg, 192, seed=7)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=2)
    idx = step_indices(ds, cfg, 3)
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state = port_state(cfg, params)
    assert state.dense_opt is None and tss.dense_parameters(state.model) == []
    state, _, loss = port_train(cfg, state, packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)
    again = sparse_state_from_jax(sparse_state_to_jax(state), build_ranker(cfg, device="cpu"), cfg)
    assert again.step == 3 and again.dense_opt is None


def test_jax_sparse_step_steps_an_empty_dense_tree():
    """What the port's ``dense_opt = None`` stands for: optax's AdamW counts
    its updates of an empty dense tree, and nothing else changes."""
    cfg = all_large_lr_cfg()
    ds = train_dataset(cfg, 64, seed=8)
    model = jbuild_ranker(cfg, "lr")
    params = jax_params(cfg, ds, seed=0)
    state = jss.init_sparse_state(params, cfg, jss.make_dense_tx(cfg), model.tables)
    packer = BatchPacker(ds)
    run = jss.make_sparse_chunk_fn(model, packer.layout_key(), 64, cfg)
    state, _, _ = run(state, jtrainer.AucHist.zeros(), packer.int_mat, packer.float_mat,
                      jnp.asarray(step_indices(ds, cfg, 1)))
    assert int(flatten_sparse_state(state)["dense_opt"]["count"]) == 1
    assert flatten_sparse_state(state)["dense_opt"]["mu"] == {}
