"""The port's DSSM retrieval training and evaluation against the JAX
package's, on the CPU.

JAX draws each step's in-batch negatives inside the step from
``fold_in(key, step)``; the port takes them as a ``(rate, B)`` argument. So
these tests rebuild JAX's permutations from the same key, outside the JAX
package (:func:`jax_perms`: ``fold_in``, ``split``, ``permutation``, as
``news_recsys_tpu/models/dssm.py:98-100`` draws them), and hand them to the
port. Both sides start from the same parameters (JAX init, converted by
``news_recsys_tpu_torch.convert``) and train on the same packed batches.
The JAX fused lookup + pool runs its XLA route (``NRT_PALLAS=""``), and for
one step its Pallas kernel in interpret mode.

Tolerances: rtol 1e-6 on the losses (float32, other summation orders);
after 1-3 steps rtol 1e-5 / atol 5e-5 on the loss, every parameter and
both AdamW moments (Adam divides by ``|g| + 1e-8``, which amplifies
rounding where a gradient cancels, as in
tests/test_torch_dense_training.py); eight steps the same, each from JAX's
state before it (:data:`ROUNDING_NU`); 1e-5 on the encodings; HR@10 exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu import config as jconfig
from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from news_recsys_tpu.models import dssm as jdssm
from news_recsys_tpu.training import retrieval as jretrieval
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch import config as tconfig
from news_recsys_tpu_torch.convert import (dense_state_from_jax, dense_state_to_jax,
                                           flatten_dense_state, params_from_flax,
                                           sparse_state_from_jax)
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset as TPackedDataset
from news_recsys_tpu_torch.models import dssm as tdssm
from news_recsys_tpu_torch.training import retrieval as tretrieval
from news_recsys_tpu_torch.training.checkpoint import load_state
from news_recsys_tpu_torch.training.dense_step import init_dense_state

from tests.test_torch_dense_training import assert_dense_states_close
from tests.test_torch_models import history, jax_init
from tests.test_torch_training import assert_states_close, port_batches, step_indices

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=5e-5)
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
KEY_SEED = 43            # the JAX trainer's negatives key: train_hparams.seed + 1
FEATS = ["user_id", "item_id", "category"]


def dssm_raw(optimizer="adamw", large=False, batch_size=32, hist_len=5, rate=3,
             loss="infonce", logq=False):
    """A narrow DSSM (D 8) whose user tower pools a click history of
    ``hist_len`` over the item table; with ``large`` the user and item
    tables (5,000 and 4,500 ids) are large enough for the rowwise step."""
    sizes = ({"user_id": 5000, "item_id": 4500, "category": 10} if large
             else {"user_id": 300, "item_id": 400, "category": 10})
    return {
        "name": "dssm",
        "features": {"sparse_feature_names": FEATS, "array_feature_names": ["hist"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"],
                     "array_max_length": {"hist": hist_len}},
        "embeddings": {"embedding_size": {k: 8 for k in FEATS},
                       "embedding_table_size": sizes,
                       "share_emb_table_features": {"hist": "item_id"}},
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"lr": 1e-3, "min_lr": 1e-4, "lr_milestones": [2, 6],
                          "max_step": 10000, "max_epoch": 2, "seed": KEY_SEED - 1,
                          "embedding_optimizer": optimizer},
        "dssm_cfg": {"negative_sample_rate": rate, "temperature": 0.1, "loss": loss,
                     "logq_correction": logq},
    }


def configs(raw):
    return jconfig.config_from_dict(raw), tconfig.config_from_dict(raw)


def dssm_arrays(raw, n, seed, hist_len=None):
    """Rows of ``raw``'s features: a ragged ``hist`` (empty ones included),
    some items repeated within a batch, about 60% clicked rows."""
    rng = np.random.default_rng(seed)
    sizes = raw["embeddings"]["embedding_table_size"]
    L = hist_len or raw["features"]["array_max_length"]["hist"]
    hist = history(rng, n, L, sizes["item_id"])
    hist[:2] = 0                                           # all-empty histories
    items = rng.integers(1, sizes["item_id"], n).astype(np.int32)
    items[1::7] = items[0]
    return {"user_id": rng.integers(1, sizes["user_id"], n).astype(np.int32),
            "item_id": items,
            "category": rng.integers(1, sizes["category"], n).astype(np.int32),
            "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
            "label": (rng.random(n) < 0.6).astype(np.float32).reshape(-1, 1)}


def jax_perms(step, B, rate, seed=KEY_SEED):
    """(rate, B): the permutations JAX's step ``step`` draws from the key
    ``PRNGKey(seed)``."""
    sub = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    return np.stack([np.asarray(jax.random.permutation(k, B))
                     for k in jax.random.split(sub, rate)])


def jax_draws(steps, B, rate) -> tretrieval.NegativeDraws:
    perms = np.stack([jax_perms(s, B, rate) for s in range(steps)]).astype(np.int32)
    return tretrieval.NegativeDraws(torch.from_numpy(perms), 0)


def loss_args(raw):
    d = raw["dssm_cfg"]
    return d["temperature"], d["loss"], 1.0


# -- the losses ----------------------------------------------------------------


def embeddings(rng, B, D, rate):
    u, i = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    neg = rng.standard_normal((B, rate, D)).astype(np.float32)
    mask = (rng.random(B) < 0.7).astype(np.float32)
    mask[:3] = 0.0
    return u, i, neg, mask


@pytest.mark.parametrize("logq", [False, True])
def test_info_nce_loss_matches_jax(logq):
    rng = np.random.default_rng(0)
    u, i, neg, mask = embeddings(rng, 48, 8, 3)
    lq = (np.log(rng.random(48)).astype(np.float32), np.log(rng.random((48, 3))).astype(np.float32))
    kw = dict(log_q_pos=lq[0], log_q_neg=lq[1]) if logq else {}
    for m in (None, mask):
        want = jdssm.info_nce_loss(u, i, neg, 0.1, m, **kw)
        got = tdssm.info_nce_loss(*map(torch.from_numpy, (u, i, neg)), 0.1,
                                  None if m is None else torch.from_numpy(m),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_triplet_loss_matches_jax():
    rng = np.random.default_rng(1)
    u, i, neg, mask = embeddings(rng, 48, 8, 3)
    for m in (None, mask):
        want = jdssm.triplet_loss(u, i, neg, 1.0, m)
        got = tdssm.triplet_loss(*map(torch.from_numpy, (u, i, neg)), 1.0,
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_masked_rows_count_in_the_mean():
    """The mean runs over all B rows, masked ones included (JAX's
    ``jnp.mean``), not over the mask's sum."""
    rng = np.random.default_rng(2)
    u, i, neg, _ = embeddings(rng, 8, 4, 2)
    mask = np.zeros(8, np.float32)
    mask[0] = 1.0
    t = [torch.from_numpy(a) for a in (u, i, neg)]
    one = tdssm.info_nce_loss(t[0][:1], t[1][:1], t[2][:1], 0.1)
    np.testing.assert_allclose(float(tdssm.info_nce_loss(*t, 0.1, torch.from_numpy(mask))),
                               float(one) / 8, rtol=1e-6)


@pytest.mark.parametrize("case", ["infonce", "logq", "triplet"])
def test_dssm_loss_from_embeddings_matches_jax(case):
    """JAX's permutations of ``rng``, handed to the port: the negatives come
    from the un-normalised item embeddings, and with logQ each negative's
    log q is read at its permuted id."""
    rng = np.random.default_rng(3)
    B, D, rate, V = 40, 8, 3, 60
    u, i, _, _ = embeddings(rng, B, D, rate)
    i *= rng.uniform(0.2, 5.0, (B, 1)).astype(np.float32)     # norms that differ by row
    batch = {"label": (rng.random((B, 1)) < 0.6).astype(np.float32),
             "_valid": np.r_[np.ones(B - 4), np.zeros(4)].astype(np.float32),
             "item_id": rng.integers(1, V, B).astype(np.int32)}
    logq = np.log(rng.dirichlet(np.ones(V))).astype(np.float32) if case == "logq" else None
    loss_type = "triplet" if case == "triplet" else "infonce"
    key = jax.random.PRNGKey(11)
    want = jdssm.dssm_loss_from_embeddings(key, u, i, batch, rate, 0.1, loss_type, 1.0,
                                           logq_table=None if logq is None else jnp.asarray(logq))
    keys = jax.random.split(key, rate)
    perms = np.stack([np.asarray(jax.random.permutation(k, B)) for k in keys])
    got = tdssm.dssm_loss_from_embeddings(
        torch.from_numpy(perms), torch.from_numpy(u), torch.from_numpy(i),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0.1, loss_type, 1.0,
        logq_table=None if logq is None else torch.from_numpy(logq))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_negative_permutations_are_keyed_by_step():
    """A step's permutations depend on (seed, step) alone: an epoch's carry
    drawn from a later step holds the same rows."""
    whole = tretrieval.draw_negatives(7, 0, 5, 16, 3, "cpu")
    later = tretrieval.draw_negatives(7, 3, 2, 16, 3, "cpu")
    for s in (3, 4):
        np.testing.assert_array_equal(whole.at(s).numpy(), later.at(s).numpy())
        np.testing.assert_array_equal(later.at(s).numpy(),
                                      tdssm.draw_negative_permutations(7, s, 16, 3))
    assert sorted(whole.at(0)[1].tolist()) == list(range(16))
    assert not np.array_equal(whole.at(0).numpy(), whole.at(1).numpy())


class Rows:
    def __init__(self, **arrays):
        self.arrays = arrays


def test_item_log_q_equals_jax():
    rng = np.random.default_rng(4)
    ids = np.r_[rng.integers(0, 50, 300), [55, 70]].astype(np.int32)   # 70 is past the vocab
    for ds in (Rows(item_id=ids), Rows(item_id=ids[:0])):
        got, want = tdssm.item_log_q(ds, 60), jdssm.item_log_q(ds, 60)
        assert got.dtype == np.float32 and got.shape == (60,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hist", ["empty", "ragged"])
def test_dedup_hit_rate_equals_jax(hist):
    rng = np.random.default_rng(5)
    q, fetch = 64, 20
    retrieved = np.stack([rng.permutation(40)[:fetch] for _ in range(q)]) + 1
    targets = np.where(rng.random(q) < 0.5, retrieved[np.arange(q), rng.integers(0, fetch, q)],
                       rng.integers(1, 41, q))
    histories = ([[] for _ in range(q)] if hist == "empty" else
                 [list(rng.choice(retrieved[r], rng.integers(0, 6), replace=False))
                  for r in range(q)])
    for k in (1, 5, 10):
        got = tretrieval.dedup_hit_rate(retrieved, targets, histories, k)
        assert got == jretrieval.dedup_hit_rate(retrieved, targets, histories, k)
    assert tretrieval.dedup_hit_rate(retrieved[:0], targets[:0], [], 10) == 0.0


def test_format_retrieval_block_equals_jax():
    res = {"HR@10": 0.123456, "HR@50": 0.5, "num_queries": 321}
    for epoch in (0, 7):
        assert tretrieval.format_retrieval_block(res, epoch) == \
            jretrieval.format_retrieval_block(res, epoch)
    assert tretrieval.format_retrieval_block({}, 1) == jretrieval.format_retrieval_block({}, 1)


# -- training steps ------------------------------------------------------------


def setup(raw, steps, seed=3, n=None):
    """(JAX cfg, port cfg, JAX model, params, packer, step indices, logq table)."""
    jcfg, cfg = configs(raw)
    bs = raw["dataset"]["batch_size"]
    ds = PackedDataset(dssm_arrays(raw, n or steps * bs, seed))
    jmodel = jdssm.build_dssm(jcfg)
    params = jax_init(jmodel, ds.take(np.arange(bs)))
    logq = (jdssm.item_log_q(ds, raw["embeddings"]["embedding_table_size"]["item_id"])
            if raw["dssm_cfg"]["logq_correction"] else None)
    return jcfg, cfg, jmodel, params, BatchPacker(ds), step_indices(ds, cfg, steps), logq


def jax_batches(packer, idx):
    ones = np.ones(idx.shape[1], np.float32)
    for rows in idx:
        yield unpack_batch(packer.int_mat[rows], packer.float_mat[rows], ones,
                           packer.layout_key())


def jax_dense_dssm(raw, jcfg, jmodel, params, packer, idx, logq):
    state = jtrainer.TrainState.create(apply_fn=jmodel.apply, params=params,
                                       tx=jtrainer.make_optimizer(jcfg))
    d = raw["dssm_cfg"]
    step = jretrieval.make_dssm_train_step(
        jmodel, d["negative_sample_rate"], d["temperature"], d["loss"], 1.0,
        logq_table=None if logq is None else jnp.asarray(logq))
    rng = jax.random.PRNGKey(KEY_SEED)
    losses = []
    for batch in jax_batches(packer, idx):
        state, rng, loss = step(state, rng, batch)
        losses.append(float(loss))
    return jax.device_get(state), losses


def port_run(step, state, packer, idx, rate):
    draws = jax_draws(len(idx), idx.shape[1], rate)
    return [float(step(state, batch, draws)[0]) for batch in port_batches(packer, idx)]


DENSE_CASES = {"infonce": dict(), "logq": dict(logq=True), "triplet": dict(loss="triplet")}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_dssm_steps_match_jax(monkeypatch, case, steps):
    """The all-dense AdamW step (``make_dssm_train_step``): ``hist`` pooled
    through ``fused_lookup_pool`` and its backward's plain version, the item
    table's gradient the sum of its ``item_id`` gather and the pool."""
    monkeypatch.setenv("NRT_PALLAS", "")
    raw = dssm_raw(**DENSE_CASES[case])
    jcfg, cfg, jmodel, params, packer, idx, logq = setup(raw, steps)
    jstate, jlosses = jax_dense_dssm(raw, jcfg, jmodel, params, packer, idx, logq)
    state = init_dense_state(params_from_flax(params, tdssm.build_dssm(cfg, device="cpu")), cfg)
    step = tretrieval.make_dssm_train_step(state.model, cfg, *loss_args(raw),
                                           logq_table=None if logq is None
                                           else torch.from_numpy(logq))
    losses = port_run(step, state, packer, idx, raw["dssm_cfg"]["negative_sample_rate"])
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    assert_dense_states_close(state, jstate, tol=STEP_TOL)
    assert state.step == steps


# A second moment under this after a step (AdamW's b2 0.999) means the
# element's gradient was under ~1e-7 in every step so far: a sum that
# cancelled to within ~10x the two sides' rounding differences (1e-8 here),
# where Adam's update, lr * g / (|g| + 1e-8), may differ by up to ~lr.
ROUNDING_NU = 1e-17


def test_eight_dense_dssm_steps_match_jax_step_by_step(monkeypatch):
    """Eight steps of configs/dssm.yaml's logQ recipe, each from JAX's state
    before it (converted): the loss, every parameter and both AdamW moments
    after each step within STEP_TOL, the step count exact. Parameters whose
    second moment is positive and under ROUNDING_NU are left out of the
    parameter check (their moments are still held), a few a step at most: at
    this seed an item row's gradient
    component cancels to ~1e-7 at step 4, and Adam turns that noise into a
    move of ~7e-4 on one side or the other."""
    monkeypatch.setenv("NRT_PALLAS", "")
    raw = dssm_raw(logq=True)
    jcfg, cfg, jmodel, params, packer, idx, logq = setup(raw, 8)
    d = raw["dssm_cfg"]
    jstep = jretrieval.make_dssm_train_step(jmodel, d["negative_sample_rate"],
                                            d["temperature"], d["loss"], 1.0,
                                            logq_table=jnp.asarray(logq))
    jstate = jtrainer.TrainState.create(apply_fn=jmodel.apply, params=params,
                                        tx=jtrainer.make_optimizer(jcfg))
    rng, draws = jax.random.PRNGKey(KEY_SEED), jax_draws(8, idx.shape[1], 3)
    exempt = 0
    for t, (jbatch, batch) in enumerate(zip(jax_batches(packer, idx),
                                            port_batches(packer, idx))):
        before = jax.device_get(jstate)
        jstate, rng, jloss = jstep(jstate, rng, jbatch)
        state = dense_state_from_jax(before, tdssm.build_dssm(cfg, device="cpu"), cfg)
        step = tretrieval.make_dssm_train_step(state.model, cfg, *loss_args(raw),
                                               logq_table=torch.from_numpy(logq))
        loss, _ = step(state, batch, draws)
        np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
        got, want = dense_state_to_jax(state), flatten_dense_state(jax.device_get(jstate))
        for key in ("mu", "nu"):
            for path, w in want["opt"][key].items():
                np.testing.assert_allclose(got["opt"][key][path], w,
                                           err_msg=f"step {t} {key} {path}", **STEP_TOL)
        for path, w in want["params"].items():
            nu = want["opt"]["nu"][path]
            held = (nu == 0) | (nu >= ROUNDING_NU)       # untouched rows only decay
            exempt += int((~held).sum())
            np.testing.assert_allclose(got["params"][path][held], w[held],
                                       err_msg=f"step {t} {path}", **STEP_TOL)
        assert state.step == t + 1 == int(got["opt"]["count"]) == int(want["opt"]["count"])
    assert exempt <= 8 * 4, exempt


def test_dense_dssm_step_matches_the_pallas_pool(monkeypatch):
    """One step against JAX with its Pallas pool run in interpret mode."""
    monkeypatch.setenv("NRT_PALLAS", "interpret")
    raw = dssm_raw(logq=True)
    jcfg, cfg, jmodel, params, packer, idx, logq = setup(raw, 1, seed=6)
    jstate, jlosses = jax_dense_dssm(raw, jcfg, jmodel, params, packer, idx, logq)
    state = dense_state_from_jax(jax.device_get(jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=jtrainer.make_optimizer(jcfg))),
        tdssm.build_dssm(cfg, device="cpu"), cfg)
    step = tretrieval.make_dssm_train_step(state.model, cfg, *loss_args(raw),
                                           logq_table=torch.from_numpy(logq))
    losses = port_run(step, state, packer, idx, 3)
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    assert_dense_states_close(state, jstate, tol=STEP_TOL)


@pytest.mark.parametrize("case", ["infonce", "logq"])
def test_rowwise_dssm_steps_match_jax(monkeypatch, case):
    """Three ``rowwise_adagrad`` steps against ``make_dssm_sparse_chunk_fn``
    (chunks of one step): the user and item tables (``item_id`` and the
    unpooled ``hist`` rows of one table, each row entry collected once),
    the AdaGrad accumulators, the towers, ``category`` and AdamW's state."""
    monkeypatch.setenv("NRT_PALLAS", "")
    raw = dssm_raw("rowwise_adagrad", large=True, logq=case == "logq")
    jcfg, cfg, jmodel, params, packer, idx, logq = setup(raw, 3)
    d = raw["dssm_cfg"]
    run = jretrieval.make_dssm_sparse_chunk_fn(
        jmodel, packer.layout_key(), idx.shape[1], jcfg, d["negative_sample_rate"],
        d["temperature"], d["loss"], 1.0, logq_table=None if logq is None else jnp.asarray(logq))
    jstate = jss.init_sparse_state(params, jcfg, jss.make_dense_tx(jcfg), jmodel.tables)
    state = sparse_state_from_jax(jax.device_get(jstate), tdssm.build_dssm(cfg, device="cpu"),
                                  cfg)
    rng, jlosses = jax.random.PRNGKey(KEY_SEED), []
    for s in range(len(idx)):
        jstate, rng, loss = run(jstate, rng, packer.int_mat, packer.float_mat,
                                jnp.asarray(idx[s:s + 1]))
        jlosses.append(float(loss))
    step = tretrieval.make_dssm_sparse_train_step(state.model, cfg, *loss_args(raw),
                                                  logq_table=None if logq is None
                                                  else torch.from_numpy(logq))
    losses = port_run(step, state, packer, idx, d["negative_sample_rate"])
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    assert_states_close(state, jax.device_get(jstate), jcfg, tol=STEP_TOL)
    assert sorted(state.emb_acc) == ["item_id", "user_id"]


@pytest.mark.parametrize("train", [{"embedding_optimizer": "rowwise_adagrad",
                                    "embedding_update_period": 4}], ids=["K>1"])
def test_unported_dssm_optimizers_raise(train):
    """K-step write-back: the JAX package's DSSM refuses it with this message."""
    raw = dssm_raw(large=True)
    raw["train_hparams"].update(train)
    cfg = tconfig.config_from_dict(raw)
    model = tdssm.build_dssm(cfg, device="cpu")
    match = r"implemented for the ranking path only"
    with pytest.raises(NotImplementedError, match=match):
        tretrieval.make_dssm_sparse_train_step(model, cfg, 0.1)
    with pytest.raises(NotImplementedError, match=match):
        tretrieval.DSSMTrainer(cfg, model, device="cpu")


# -- evaluation and the trainer ------------------------------------------------


def eval_sets(raw, seed, n_items=60, n_queries=96):
    """(item corpus, query rows, targets, histories): a corpus of 60 items,
    so that HR@10 of random towers is well above 0; histories of 0-4 corpus
    items (some empty), the targets never among them."""
    rng = np.random.default_rng(seed)
    items = {"item_id": np.arange(1, n_items + 1, dtype=np.int32),
             "category": rng.integers(1, 10, n_items).astype(np.int32),
             "label": np.full((n_items, 1), -1, np.float32)}
    q = dssm_arrays(raw, n_queries, seed + 1)
    q["item_id"] = rng.integers(1, n_items + 1, n_queries).astype(np.int32)
    q["label"][:] = 1.0
    histories = [[int(x) for x in rng.choice(np.setdiff1d(np.arange(1, n_items + 1), [t]),
                                             rng.integers(0, 5), replace=False)]
                 for t in q["item_id"]]
    return items, q, q["item_id"], histories


def test_evaluate_retrieval_equals_jax(tmp_path):
    raw = dssm_raw(batch_size=32)
    raw["dataset"]["eval_batch_size"] = 40
    jcfg, cfg = configs(raw)
    items, query, targets, histories = eval_sets(raw, 8)
    jmodel = jdssm.build_dssm(jcfg)
    params = jax_init(jmodel, query)
    jt = jretrieval.DSSMTrainer(jcfg, jmodel, workdir=str(tmp_path / "jax"), use_mesh=False)
    want = jretrieval.evaluate_retrieval(jt, params, PackedDataset(items), PackedDataset(query),
                                         targets, histories, k=10)
    trainer = tretrieval.DSSMTrainer(cfg, params_from_flax(params, tdssm.build_dssm(
        cfg, device="cpu")), workdir=str(tmp_path / "port"), device="cpu")
    item_ds, query_ds = TPackedDataset(items), TPackedDataset(query)
    got = tretrieval.evaluate_retrieval(trainer, item_ds, query_ds, targets, histories, k=10)
    assert got == want and 0.0 < got["HR@10"] < 1.0
    np.testing.assert_allclose(trainer.encode_item_corpus(item_ds),
                               jt.encode_item_corpus(params, PackedDataset(items)), **ENC_TOL)
    np.testing.assert_allclose(trainer.encode_users(query_ds),
                               jt.encode_users(params, PackedDataset(query)), **ENC_TOL)


@pytest.mark.parametrize("optimizer", ["adamw", "rowwise_adagrad"])
def test_dssm_trainer_fit_writes_the_retrieval_run(tmp_path, optimizer):
    """``DSSMTrainer.fit`` for two epochs with logQ: no ``train_auc``, a
    ``Retrieval:`` block and ``val_hr_at_10`` each epoch, weights-only epoch
    checkpoints that ``load_params`` reads back, and the same HR@10 as
    ``evaluate_retrieval`` on the final model."""
    raw = dssm_raw(optimizer, large=optimizer != "adamw", logq=True)
    raw["train_hparams"]["val_freq"] = 1
    _, cfg = configs(raw)
    ds = TPackedDataset(dssm_arrays(raw, 4 * 32 + 5, 9))
    items, query, targets, histories = eval_sets(raw, 10)
    item_ds, query_ds = TPackedDataset(items), TPackedDataset(query)
    trainer = tretrieval.DSSMTrainer(cfg, tdssm.build_dssm(cfg, seed=1, device="cpu"),
                                     workdir=str(tmp_path), device="cpu")
    trainer.set_eval_data(item_ds, histories=histories, k=10)
    state = trainer.fit(ds, dev_ds=query_ds)
    assert state.step == trainer.global_step == 8
    assert trainer._logq_table.shape == (raw["embeddings"]["embedding_table_size"]["item_id"],)
    assert open(trainer.val_log_path).read().count("Retrieval:") == 2
    train_log = open(trainer.train_log_path).read()
    assert "train_loss" in train_log and "train_auc" not in train_log
    lines = [json.loads(x) for x in open(trainer.metrics_path)]
    epochs = [m for m in lines if "train_loss" in m]
    assert [(m["epoch"], m["steps"]) for m in epochs] == [(0, 4), (1, 4)]
    assert all(set(m) == {"step", "epoch", "train_loss", "examples_per_sec", "steps"}
               for m in epochs)
    vals = [m for m in lines if "val_hr_at_10" in m]
    assert len(vals) == 2 and all(m["val_num_queries"] == len(targets) for m in vals)
    final = tretrieval.evaluate_retrieval(trainer, item_ds, query_ds, targets, histories)
    assert vals[-1]["val_hr_at_10"] == final["HR@10"]
    blob = load_state(os.path.join(trainer.ckpt_dir, "epoch_001.pt"))
    assert blob["kind"] == "weights" and set(blob) == {"kind", "model"}
    fresh = tretrieval.DSSMTrainer(cfg, tdssm.build_dssm(cfg, seed=2, device="cpu"),
                                   workdir=str(tmp_path / "fresh"), device="cpu")
    fresh.load_params(fresh.init_state(), os.path.join(trainer.ckpt_dir, "epoch_001.pt"))
    for (n, a), b in zip(fresh.model.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(a, b), n
    with open(os.path.join(str(tmp_path), "model_info.log")) as f:
        assert "params/user_fc/Linear_0/Dense_0/kernel" in f.read()


def test_dssm_trainer_defaults_to_the_card(tmp_path):
    """``DSSMTrainer`` runs on the card unless asked for the CPU, and raises
    where there is no card: nothing carries on on the CPU unasked."""
    import inspect

    assert inspect.signature(tretrieval.DSSMTrainer).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        _, cfg = configs(dssm_raw())
        model = tdssm.build_dssm(cfg, device="cpu")
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
            tretrieval.DSSMTrainer(cfg, model, workdir=str(tmp_path))


def test_dssm_scatter_layouts_match_the_pallas_scatter():
    """``chip_smoke.py``'s rowwise DSSM scatter shapes
    (``scatter_layouts.dssm_scatter_layouts``): each large table gets every
    joint slot of a batch (``user_id``; ``item_id`` and the unpooled
    ``hist``), and the plain scatter of them equals JAX's Pallas kernel
    interpreted, bit for bit."""
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from news_recsys_tpu_torch.training.scatter_layouts import (dssm_scatter_layouts,
                                                                scatter_layout_stats)
    from tests.test_torch_kernel_plans import pallas_scatter

    raw = dssm_raw("rowwise_adagrad", large=True, batch_size=64)
    _, cfg = configs(raw)
    layouts = dssm_scatter_layouts(cfg, dssm_arrays(raw, 64, 12), 12)
    assert sorted(layouts) == ["item_id", "user_id"]
    for name, (table, rows, vals) in layouts.items():
        assert rows.shape == (64 + 64 + 64 * 5,) and table.shape[1] == 8
        assert scatter_layout_stats(rows, table.shape[0])["out_of_range"] == 0
        got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                                 torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy(), pallas_scatter(table, rows, vals),
                                      err_msg=name)
