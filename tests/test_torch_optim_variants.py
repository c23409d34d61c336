"""The port's ``sparse_adamw`` and its dense full-table AdaGrad route
against the JAX package's, on the CPU.

Both sides start from the same parameters (JAX init, converted by
``news_recsys_tpu_torch.convert``) and train on the same packed batches,
with the helpers of tests/test_torch_training.py. JAX runs its XLA route
(``NRT_PALLAS=""``) and, where named, its Pallas route
(``NRT_PALLAS=interpret``: the row scatter interpreted for the table and
both moments). Tables are compared on their addressable rows.

Tolerances: rtol 1e-5 / atol 5e-5 on the states after float32 steps, as
the AdaGrad steps are held (Adam divides by ``|g| + 1e-8``, which amplifies
rounding where a gradient cancels); rtol = atol = 1e-5 on one update of
the rowwise functions alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.data.packed_dataset import BatchPacker
from news_recsys_tpu.ops.scatter_rows import scatter_rows_set as jscatter
from news_recsys_tpu.training import retrieval as jretrieval
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu_torch.convert import sparse_state_from_jax
from news_recsys_tpu_torch.models import dssm as tdssm
from news_recsys_tpu_torch.models.embedding import padded_vocab
from news_recsys_tpu_torch.training import retrieval as tretrieval
from news_recsys_tpu_torch.training import sparse_step as tss

from tests.test_torch_attention import attention_dataset
from tests.test_torch_cuda import train_cfg, train_dataset, zoo_train_cfg
from tests.test_torch_retrieval import KEY_SEED, dssm_raw, loss_args, port_run, setup
from tests.test_torch_training import (TOL, assert_states_close, dedup_inputs, jax_params,
                                       jax_train, port_state, port_train, step_indices)

torch.set_num_threads(2)
STEP_TOL = dict(rtol=1e-5, atol=5e-5)


# -- the rowwise functions -----------------------------------------------------


def adam_inputs(seed: int, V: int = 640, D: int = 16):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    mu = (0.01 * rng.standard_normal((V, D))).astype(np.float32)
    nu = rng.uniform(0.0, 1e-3, (V, D)).astype(np.float32)
    ids, g = dedup_inputs(rng, 200, 600, D)
    return table, mu, nu, ids, g


@pytest.mark.parametrize("mode", ["", "interpret"])
def test_rowwise_adam_update_matches_jax(mode):
    """One update on the sorted layout, JAX's table, ``mu`` and ``nu``
    written by ``.at[].set`` or by its Pallas scatter in interpret mode;
    the port's by ``scatter_rows_set`` (its plain version on the CPU).
    Untouched rows stay as they were."""
    table, mu, nu, ids, g = adam_inputs(0)
    V = table.shape[0]
    rows, grads = tss._dedup_rows(torch.from_numpy(ids), torch.from_numpy(g), V - 1,
                                  max_id=599)
    args = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    scatter = ((lambda t, r, v: jscatter(t, r, v, use_pallas=True, interpret=True))
               if mode else jss._default_scatter)
    want = jss.rowwise_adam_update(jnp.asarray(table), jnp.asarray(mu), jnp.asarray(nu),
                                   jnp.asarray(rows.numpy()), jnp.asarray(grads.numpy()),
                                   t=jnp.int32(3), scatter=scatter, **args)
    got = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    out = tss.rowwise_adam_update(*got, rows, grads, t=3, **args)
    assert all(o is g for o, g in zip(out, got))                  # in place
    for name, a, w in zip(("table", "mu", "nu"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **TOL)
    untouched = np.setdiff1d(np.arange(V), rows.numpy())
    for a, before in zip(got, (table, mu, nu)):
        np.testing.assert_array_equal(a.numpy()[untouched], before[untouched])


def test_dense_rowwise_adagrad_update_matches_jax():
    """The dense full-table route on float32: ids with duplicates, padding
    and ids past ``max_id`` (which add nothing). Rows left untouched keep
    their bits. The bfloat16 table: tests/test_torch_bf16.py."""
    rng = np.random.default_rng(2)
    V, D = 640, 16
    table = rng.standard_normal((V, D)).astype(np.float32)
    acc = rng.uniform(0.1, 2.0, V).astype(np.float32)
    ids, g = dedup_inputs(rng, 300, 600, D)
    want_t, want_acc = jss.dense_rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(g), 0.05,
        max_id=599)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    out = tss.dense_rowwise_adagrad_update(t, a, torch.from_numpy(ids), torch.from_numpy(g),
                                           0.05, max_id=599)
    assert out[0] is t and out[1] is a
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_acc), **TOL)
    touched = np.unique(ids[(ids > 0) & (ids <= 599)])
    untouched = np.setdiff1d(np.arange(V), touched)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_dense_route_equals_the_sorted_route():
    """The port's two AdaGrad routes on one batch: the same tables on every
    row the sorted route writes with a real gradient, and the dense route
    gives the same bits when run again."""
    rng = np.random.default_rng(3)
    V, D = 640, 16
    table = rng.standard_normal((V, D)).astype(np.float32)
    acc = rng.uniform(0.1, 2.0, V).astype(np.float32)
    ids, g = dedup_inputs(rng, 2000, 600, D)
    ids, g = torch.from_numpy(ids), torch.from_numpy(g)
    runs = []
    for _ in range(2):
        t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
        tss.dense_rowwise_adagrad_update(t, a, ids, g, 0.05, max_id=599)
        runs.append((t, a))
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    rows, grads = tss._dedup_rows(ids, g, V - 1, max_id=599)
    tss.rowwise_adagrad_update(t, a, rows, grads, 0.05)
    np.testing.assert_allclose(runs[0][0][:600].numpy(), t[:600].numpy(), **TOL)
    np.testing.assert_allclose(runs[0][1][:600].numpy(), a[:600].numpy(), **TOL)


def test_segment_sum_is_index_add_on_the_cpu():
    """The dedup's duplicate sum (embedding's backward) adds in slot order on
    the CPU: the bits of ``index_add_``, which the port used before."""
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.standard_normal((3000, 8)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 700, 3000)))
    want = torch.zeros(3000, 8).index_add_(0, seg, vals)
    assert torch.equal(tss.segment_sum(vals, seg, 3000), want)
    skipped = tss.segment_sum(vals, seg, 3000, skip=int(seg[0]))
    assert not skipped[int(seg[0])].any() and torch.equal(skipped[1 + int(seg[0]):],
                                                          want[1 + int(seg[0]):])


# -- the step --------------------------------------------------------------------


def zoo_case(name: str):
    """(cfg, dataset) of a ranker on ``sparse_adamw``: DCN with its
    arena, DCN with two tables (the joint dedup) and a pooled history,
    DeepFM, and the scoreboard's attention ranker at batch 64."""
    if name.startswith("dcn"):
        cfg = train_cfg(name == "dcn-arena", embedding_optimizer="sparse_adamw")
        return cfg, train_dataset(cfg, 192, seed=11)
    if name == "deepfm":
        cfg = zoo_train_cfg("deepfm", arena=False, embedding_optimizer="sparse_adamw")
        return cfg, train_dataset(cfg, 192, seed=12)
    from news_recsys_tpu_torch import zoo as tzoo
    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    raw = config_to_dict(tzoo.mind_ranker_config("attention"))
    raw["dataset"]["batch_size"] = 64
    raw["train_hparams"]["embedding_optimizer"] = "sparse_adamw"
    cfg = config_from_dict(raw)
    return cfg, attention_dataset(cfg, 2, seed=13)


@pytest.mark.parametrize("name,mode", [("dcn-arena", ""), ("dcn-arena", "interpret"),
                                       ("dcn-tables", ""), ("deepfm", "interpret"),
                                       ("attention", "")])
def test_sparse_adamw_steps_match_jax(monkeypatch, name, mode):
    """Two ``sparse_adamw`` steps: the tables, both (V, D) moments of every
    large table, the dense parameters and AdamW's state."""
    monkeypatch.setenv("NRT_FUSED_ATTN", "off")
    cfg, ds = zoo_case(name)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=0)
    idx = step_indices(ds, cfg, 2)
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch, mode)
    state, _, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    assert state.emb_acc == {} and sorted(state.emb_mu) == sorted(state.emb_nu)
    assert all(m.shape == state.model.embedder.tables[t].shape for t, m in state.emb_nu.items())
    np.testing.assert_allclose(loss, jloss, **STEP_TOL)
    assert_states_close(state, jstate, cfg, tol=STEP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_adamw_dssm_steps_match_jax(monkeypatch, dtype):
    """Three rowwise DSSM steps on ``sparse_adamw`` against
    ``make_dssm_sparse_chunk_fn``. With ``mesh.param_dtype: bfloat16`` the
    DSSM's tables stay float32 in both packages (its embedder takes no
    table dtype), and both take the unique-row layout that setting gates."""
    monkeypatch.setenv("NRT_PALLAS", "")
    raw = dssm_raw("sparse_adamw", large=True)
    raw["mesh"] = {"param_dtype": dtype}
    jcfg, cfg, jmodel, params, packer, idx, _ = setup(raw, 3)
    d = raw["dssm_cfg"]
    run = jretrieval.make_dssm_sparse_chunk_fn(jmodel, packer.layout_key(), idx.shape[1], jcfg,
                                               d["negative_sample_rate"], d["temperature"],
                                               d["loss"], 1.0)
    jstate = jss.init_sparse_state(params, jcfg, jss.make_dense_tx(jcfg), jmodel.tables)
    state = sparse_state_from_jax(jax.device_get(jstate), tdssm.build_dssm(cfg, device="cpu"),
                                  cfg)
    assert all(t.dtype == torch.float32 for t in state.model.embedder.tables.values())
    rng, jlosses = jax.random.PRNGKey(KEY_SEED), []
    for s in range(len(idx)):
        jstate, rng, loss = run(jstate, rng, packer.int_mat, packer.float_mat,
                                jnp.asarray(idx[s:s + 1]))
        jlosses.append(float(loss))
    step = tretrieval.make_dssm_sparse_train_step(state.model, cfg, *loss_args(raw))
    losses = port_run(step, state, packer, idx, d["negative_sample_rate"])
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    assert_states_close(state, jax.device_get(jstate), jcfg, tol=STEP_TOL)
    assert sorted(state.emb_mu) == ["item_id", "user_id"] and state.emb_acc == {}


def test_unique_rows_are_jax_first_occurrence_slots():
    """The unique-row layout puts each distinct id on the slot of its first
    occurrence, as the JAX package's sort-free dedup does; an arena's
    members go in the order of their id offsets."""
    rng = np.random.default_rng(5)
    ids, g = dedup_inputs(rng, 300, 500, 8, above=False)
    spare = padded_vocab(500) - 1
    want_rows, want_g, _ = jss._dedup_rows_matmul(jnp.asarray(ids), jnp.asarray(g), spare)
    got = tss._unique_rows({"t": [(torch.from_numpy(ids), torch.from_numpy(g))]},
                           {"t": (500, 8)}, {"t": spare})["t"]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_rows))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    # two arena members handed over in reverse offset order
    a, b = (dedup_inputs(rng, 100, 500, 8, above=False) for _ in range(2))
    b = (b[0] + 600, b[1])
    entries = [(torch.from_numpy(b[0]), torch.from_numpy(b[1]), 599),
               (torch.from_numpy(a[0]), torch.from_numpy(a[1]), 0)]
    got = tss._unique_rows({"arena": entries}, {"arena": (1200, 8)},
                           {"arena": padded_vocab(1200) - 1})["arena"]
    per = [jss._dedup_rows_matmul(jnp.asarray(i), jnp.asarray(gr), padded_vocab(1200) - 1)
           for i, gr in (a, b)]
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.concatenate([np.asarray(p[0]) for p in per]))
