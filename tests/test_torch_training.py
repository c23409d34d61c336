"""The port's sparse training step against the JAX package's, on the CPU.

Both sides start from the same parameters (JAX init, converted by
``news_recsys_tpu_torch.convert``) and train on the same packed batches.
JAX runs both of its scatter routes: its XLA route (``NRT_PALLAS=""``: MXU
dedup, ``.at[].set``) and its Pallas route (``NRT_PALLAS=interpret``:
sorted dedup, the Pallas row scatter and cross stack interpreted). The
port's tables are compared on their addressable rows (``[:vocab]``): the
routes send zero-gradient filler slots to different padding rows above the
vocab, which no lookup reads.

Tolerances: rtol = atol = 1e-5 on states after a few float32 steps (the
two sides sum duplicate gradients, the batch and the cross stack's
backward in other orders, and optax and torch round AdamW's steps
differently); 1e-6 on the dedup's summed gradients; exact equality where
nothing is summed. The cross stack's gradients at unit-scale inputs are sums
over the batch of terms up to ~500 that cancel to order 1 in places, so
they are held to rtol 1e-5 and an atol of 1e-5 of the largest value
(normwise), not elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.config import table_specs
from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.ops import dcn_kernel as jdcn
from news_recsys_tpu.training import schedule as jschedule
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch.convert import (flatten_sparse_state, params_from_flax,
                                           sparse_state_from_jax, sparse_state_to_jax)
from news_recsys_tpu_torch.models.embedding import padded_vocab
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.dcn_kernel import cross_bwd_plain, dcn_cross_stack
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.metrics_device import (AucHist, binned_auc_update,
                                                           binned_auc_value)
from news_recsys_tpu_torch.training.schedule import hold_cosine_floor
from news_recsys_tpu_torch.training.trainer import Trainer

from tests.test_torch_cuda import cross_inputs, train_cfg, train_dataset
from tests.test_torch_models import jax_init

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ["", "interpret"]          # JAX's XLA route, its Pallas route


# -- configs and data --------------------------------------------------------


def jax_params(cfg, ds: PackedDataset, seed: int):
    """The JAX trainer's init: ``model.init`` on the first rows of ``ds``."""
    bs = cfg.dataset.batch_size
    return jax_init(jbuild_ranker(cfg, cfg.name), ds.take(np.arange(bs)), seed=seed)


def step_indices(ds, cfg, steps: int, seed: int = 0) -> np.ndarray:
    bs = cfg.dataset.batch_size
    return np.random.default_rng(seed).permutation(len(ds))[: steps * bs].reshape(
        steps, bs).astype(np.int32)


def jax_train(cfg, params_or_state, packer, idx, monkeypatch, mode=""):
    """``make_sparse_chunk_fn`` over the rows ``idx`` (steps, B); returns the
    state (numpy leaves), the AUC histogram and the last loss."""
    monkeypatch.setenv("NRT_PALLAS", mode)
    model = jbuild_ranker(cfg, cfg.name)
    state = params_or_state
    if not hasattr(state, "dense_opt"):
        state = jss.init_sparse_state(params_or_state, cfg, jss.make_dense_tx(cfg),
                                      model.tables)
    run = jss.make_sparse_chunk_fn(model, packer.layout_key(), idx.shape[1], cfg)
    state, hist, loss = run(state, jtrainer.AucHist.zeros(), packer.int_mat, packer.float_mat,
                            jnp.asarray(idx))
    return jax.device_get(state), jax.device_get(hist), float(loss)


def port_batches(packer, idx):
    ones = torch.ones(idx.shape[1])
    for rows in idx:
        yield unpack_batch(torch.from_numpy(packer.int_mat[rows]),
                           torch.from_numpy(packer.float_mat[rows]), ones, packer.layout_key())


def port_train(cfg, state, packer, idx):
    """The port's step over the rows ``idx``; returns (state, hist, last loss)."""
    step = tss.make_sparse_train_step(state.model, cfg)
    hist = AucHist.zeros("cpu")
    loss = None
    for batch in port_batches(packer, idx):
        loss, _ = step(state, batch, hist)
    return state, hist, float(loss)


def port_state(cfg, params):
    return tss.init_sparse_state(params_from_flax(params, build_ranker(cfg, device="cpu")), cfg)


def assert_states_close(port, jax_state, cfg, tol=TOL):
    """Parameters (large tables on their addressable rows), the rowwise
    optimizer's state (AdaGrad accumulators, or Adam's two moments), AdamW
    moments and counts, and the step."""
    got, want = sparse_state_to_jax(port), flatten_sparse_state(jax_state)
    vocab = {f"embedder/{t}": v for t, (v, d) in table_specs(cfg).items()
             if v >= tss.SMALL_VOCAB_THRESHOLD}
    assert sorted(got["params"]) == sorted(want["params"])
    for path, w in want["params"].items():
        n = vocab.get(path)
        np.testing.assert_allclose(got["params"][path][:n], w[:n], err_msg=path, **tol)
    for section in ("emb_mu", "emb_nu"):
        assert sorted(got[section]) == sorted(want[section]), section
        for t, w in want[section].items():
            n = vocab[f"embedder/{t}"]
            np.testing.assert_allclose(got[section][t][:n], w[:n], err_msg=f"{section} {t}",
                                       **tol)
    for key in ("mu", "nu"):
        for path, w in want["dense_opt"][key].items():
            np.testing.assert_allclose(got["dense_opt"][key][path], w,
                                       err_msg=f"{key} {path}", **tol)
    assert int(got["dense_opt"]["count"]) == int(want["dense_opt"]["count"])
    assert int(got["step"]) == int(want["step"])


# -- the cross stack's gradient ----------------------------------------------


def assert_close_to_scale(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,D,NL", [(64, 112, 3), (32, 24, 2)])
def test_cross_stack_grad_matches_jax_vjp(monkeypatch, mode, B, D, NL):
    monkeypatch.setenv("NRT_PALLAS", mode)
    x0, ws, bs = cross_inputs(B, D, NL)
    g = np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)
    out, vjp = jax.vjp(jdcn.dcn_cross_stack, x0, ws, bs)
    want = [np.asarray(a) for a in vjp(g)]

    args = [torch.from_numpy(a).requires_grad_() for a in (x0, ws, bs)]
    got_out = dcn_cross_stack(*args)
    got_out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **TOL)
    for name, a, w in zip(("dx0", "dws", "dbs"), args, want):
        assert_close_to_scale(a.grad.numpy(), w, name)

    # the transliteration on JAX's own residuals
    _, (xs, ss) = jdcn._cross_xla(x0, ws, bs)
    plain = cross_bwd_plain(*map(torch.from_numpy, (x0, ws, np.array(xs), np.array(ss), g)))
    for name, p, w in zip(("dx0", "dws", "dbs"), plain, want):
        assert_close_to_scale(p.numpy(), w, name)


# -- schedule and AUC --------------------------------------------------------


def test_hold_cosine_floor_matches_jax():
    lr, min_lr, (m0, m1) = 1e-3, 5e-6, (40000, 200000)
    port, ref = hold_cosine_floor(lr, min_lr, (m0, m1)), jschedule.hold_cosine_floor(
        lr, min_lr, (m0, m1))
    for step in (0, m0 - 1, m0, m0 + 1, 77777, (m0 + m1) // 2, m1 - 1, m1, m1 + 5, 10 ** 7):
        # JAX evaluates in float32, the port in double
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=step)
    assert port(0) == lr and port(m1) == min_lr


def test_binned_auc_matches_jax():
    rng = np.random.default_rng(0)
    probs = rng.random(1000).astype(np.float32)
    probs[:3] = (0.0, 1.0, 0.5)                        # both ends and a bin edge
    labels = (rng.random(1000) < 0.4).astype(np.float32)
    weights = rng.random(1000).astype(np.float32)
    weights[10:20] = 0.0
    jhist = jtrainer.binned_auc_update(jtrainer.AucHist.zeros(), probs, labels, weights)
    hist = AucHist.zeros("cpu")
    for part in np.array_split(np.arange(1000), 3):    # streamed in three batches
        binned_auc_update(hist, *(torch.from_numpy(a[part]) for a in (probs, labels, weights)))
    np.testing.assert_allclose(hist.pos.numpy(), np.asarray(jhist.pos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hist.neg.numpy(), np.asarray(jhist.neg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(binned_auc_value(hist), float(jtrainer.binned_auc_value(jhist)),
                               rtol=1e-6)
    assert binned_auc_value(AucHist.zeros("cpu")) == 0.0


# -- dedup and the rowwise update --------------------------------------------


def dedup_inputs(rng, n, vocab, d, above=True):
    """Ids with duplicates, padding and (``above``) ids past ``vocab - 1``."""
    ids = rng.integers(1, vocab, n).astype(np.int32)
    ids[5:15] = ids[0]                                  # ten duplicates of one id
    ids[20:25] = 0                                      # padding
    if above:
        ids[30:33] = (vocab, vocab + 7, 2 ** 20)        # past max_id
    return ids, rng.standard_normal((n, d)).astype(np.float32)


def test_dedup_rows_matches_jax():
    rng = np.random.default_rng(0)
    ids, g = dedup_inputs(rng, 300, 500, 8)
    spare = padded_vocab(500) - 1
    want_rows, want_g, _ = jss._dedup_rows(jnp.asarray(ids), jnp.asarray(g), spare,
                                           layout="sorted", max_id=499)
    rows, grads = tss._dedup_rows(torch.from_numpy(ids), torch.from_numpy(g), spare, max_id=499)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_allclose(grads.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    assert rows.dtype == torch.int32 and (np.diff(rows.numpy()) >= 0).all()
    assert (rows.numpy() == spare).sum() == 8          # 5 padding + 3 past max_id
    assert not grads[rows == spare].any()


def test_joint_dedup_matches_jax():
    """Two tables of different widths in one joint id space; the last
    table's ids past the joint ``max_id`` drop on both sides (ids past a
    table's own vocab that stay inside the joint space: see the next test)."""
    rng = np.random.default_rng(1)
    vocab = {"item_id": (4500, 8), "user_id": (5000, 16)}
    spare = {t: padded_vocab(v) - 1 for t, (v, d) in vocab.items()}
    per_table = {}
    for i, (t, (v, d)) in enumerate(sorted(vocab.items())):
        per_table[t] = [dedup_inputs(rng, 200, v, d, above=False) for _ in range(1 + i)]
    per_table["user_id"][0][0][30:32] = (5000 + 9, 2 ** 20)
    want = jss._joint_dedup({t: [tuple(map(jnp.asarray, p)) for p in ps]
                             for t, ps in per_table.items()}, vocab, spare, layout="sorted")
    got = tss._joint_dedup({t: [tuple(map(torch.from_numpy, p)) for p in ps]
                            for t, ps in per_table.items()}, vocab, spare)
    assert sorted(got) == sorted(want)
    for t in want:
        np.testing.assert_array_equal(got[t][0].numpy(), np.asarray(want[t][0]), err_msg=t)
        np.testing.assert_allclose(got[t][1].numpy(), np.asarray(want[t][1]), rtol=1e-6,
                                   atol=1e-6, err_msg=t)


def test_joint_dedup_keeps_ids_in_their_own_table():
    """The one intended divergence from the JAX package: there, an item id
    above the item vocab shifts into the user table's range of the joint id
    space and updates a user row with the item's gradient. The port drops
    it, as the single-table dedup drops ids past ``max_id``."""
    vocab = {"item_id": (4500, 8), "user_id": (5000, 8)}
    spare = {t: padded_vocab(v) - 1 for t, (v, d) in vocab.items()}
    ids = {"item_id": np.array([7, 4500 + 1 + 42], np.int32), "user_id": np.array([3], np.int32)}
    g = {t: np.ones((len(v), 8), np.float32) for t, v in ids.items()}
    want = jss._joint_dedup({t: [(jnp.asarray(ids[t]), jnp.asarray(g[t]))] for t in ids},
                            vocab, spare, layout="sorted")
    got = tss._joint_dedup({t: [(torch.from_numpy(ids[t]), torch.from_numpy(g[t]))]
                            for t in ids}, vocab, spare)
    touched = {t: sorted(set(np.asarray(r)[np.asarray(gr).any(axis=1)].tolist()))
               for t, (r, gr) in want.items()}
    assert touched == {"item_id": [7], "user_id": [3, 42]}          # JAX: user row 42 too
    touched = {t: sorted(set(r.numpy()[gr.numpy().any(axis=1)].tolist()))
               for t, (r, gr) in got.items()}
    assert touched == {"item_id": [7], "user_id": [3]}


def test_rowwise_adagrad_update_matches_jax():
    rng = np.random.default_rng(2)
    V, D = 640, 16
    table = rng.standard_normal((V, D)).astype(np.float32)
    acc = rng.uniform(0.1, 2.0, V).astype(np.float32)
    ids, g = dedup_inputs(rng, 200, 600, D)
    rows, grads = tss._dedup_rows(torch.from_numpy(ids), torch.from_numpy(g), V - 1,
                                  max_id=599)
    want_t, want_acc = jss.rowwise_adagrad_update(jnp.asarray(table), jnp.asarray(acc),
                                                  jnp.asarray(rows.numpy()),
                                                  jnp.asarray(grads.numpy()), 0.05)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    out = tss.rowwise_adagrad_update(t, a, rows, grads, 0.05)
    assert out[0] is t and out[1] is a                   # in place
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_acc), **TOL)
    untouched = np.setdiff1d(np.arange(V), rows.numpy())
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


# -- the step ------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arena", [True, False], ids=["arena", "tables"])
def test_one_sparse_step_matches_jax(monkeypatch, mode, arena):
    cfg = train_cfg(arena)
    ds = train_dataset(cfg, 256, seed=3)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=0)
    idx = step_indices(ds, cfg, 1)
    jstate, jhist, jloss = jax_train(cfg, params, packer, idx, monkeypatch, mode)
    state, hist, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)
    np.testing.assert_array_equal(hist.pos.numpy() + hist.neg.numpy(),
                                  np.asarray(jhist.pos) + np.asarray(jhist.neg))


def route_case(monkeypatch, share):
    """4,096 arena slots a step (batch 2,048), two steps: JAX takes
    ``dense_rowwise_adagrad_update``; the port the route that
    ``DENSE_UPDATE_MIN_SHARE`` = ``share`` gives."""
    monkeypatch.setattr(tss, "DENSE_UPDATE_MIN_SHARE", share)
    cfg = train_cfg(True, batch_size=2048)
    ds = train_dataset(cfg, 4096, seed=4)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=1)
    idx = step_indices(ds, cfg, 2)
    assert 2 * cfg.dataset.batch_size >= jss.DENSE_UPDATE_MIN_SLOTS
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state, _, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)


def test_sorted_route_matches_jax_dense_route(monkeypatch):
    """The port's sorted route, forced, against JAX's dense route."""
    route_case(monkeypatch, float("inf"))


def test_dense_route_matches_jax_dense_route(monkeypatch):
    """The port's dense route, which it takes here by default (4,096 slots
    of the arena's 9,600 rows, above ``DENSE_UPDATE_MIN_SHARE``)."""
    assert 4096 >= tss.DENSE_UPDATE_MIN_SHARE * 9600
    route_case(monkeypatch, tss.DENSE_UPDATE_MIN_SHARE)


def test_jax_state_continues_in_the_port(monkeypatch):
    """JAX trains 2 steps; the port takes its state through ``convert`` and
    trains 2 more; the result equals JAX's 4 steps."""
    cfg = train_cfg(False)
    ds = train_dataset(cfg, 256, seed=5)
    packer = BatchPacker(ds)
    params = jax_params(cfg, ds, seed=2)
    idx = step_indices(ds, cfg, 4)
    s2, _, _ = jax_train(cfg, params, packer, idx[:2], monkeypatch)
    state = sparse_state_from_jax(s2, build_ranker(cfg, device="cpu"), cfg)
    s4, _, jloss = jax_train(cfg, s2, packer, idx[2:], monkeypatch)
    state, _, loss = port_train(cfg, state, packer, idx[2:])
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, s4, cfg)


def test_sparse_state_round_trip(monkeypatch):
    cfg = train_cfg(True)
    ds = train_dataset(cfg, 128, seed=6)
    packer = BatchPacker(ds)
    s1, _, _ = jax_train(cfg, jax_params(cfg, ds, seed=3), packer, step_indices(ds, cfg, 1),
                         monkeypatch)
    want = flatten_sparse_state(s1)
    got = sparse_state_to_jax(sparse_state_from_jax(s1, build_ranker(cfg, device="cpu"), cfg))
    assert sorted(got) == sorted(want)
    for section in ("params", "emb_mu"):
        assert sorted(got[section]) == sorted(want[section])
        for k, v in want[section].items():
            np.testing.assert_array_equal(got[section][k], v, err_msg=k)
    for key in ("mu", "nu"):
        for k, v in want["dense_opt"][key].items():
            np.testing.assert_array_equal(got["dense_opt"][key][k], v, err_msg=k)
    assert int(got["dense_opt"]["count"]) == int(want["dense_opt"]["count"]) == 1
    assert int(got["step"]) == 1
    again = sparse_state_to_jax(sparse_state_from_jax(got, build_ranker(cfg, device="cpu"), cfg))
    for k, v in got["params"].items():
        np.testing.assert_array_equal(again["params"][k], v, err_msg=k)


# -- the options the port does not run -----------------------------------------


def test_unported_runtime_raises(tmp_path):
    """What raised here until the runtime was ported (ROADMAP item 2f, a
    dataset above ``device_resident_bytes``) now trains on the slab path:
    no refusal, and the resident path's bits."""
    cfg = train_cfg(True)
    ds = train_dataset(cfg, 128, seed=7)
    states = []
    for budget in (1024, cfg.train_hparams.device_resident_bytes):
        trainer = Trainer(train_cfg(True, device_resident_bytes=budget),
                          build_ranker(cfg, device="cpu"), workdir=str(tmp_path / str(budget)),
                          device="cpu")
        states.append(trainer.fit(ds, max_epochs=1))
        assert (trainer._packer(ds)[1] is None) == (budget == 1024)
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            states[1].model.state_dict().values()):
        assert torch.equal(a, b), name
