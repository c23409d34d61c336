"""K-step lazy write-back (``embedding_update_period`` > 1) of the port
against the JAX package's ``make_sparse_chunk_fn``, and the sparse
checkpoints of the optimizer variants, on the CPU.

The port's ``Trainer.fit`` cuts an epoch where the JAX trainer's scanned
chunks end (``chunk_steps``, the epoch's end, the next ``ckpt_every_steps``
boundary) and flushes there; the JAX side here runs ``make_sparse_chunk_fn``
over the same chunks of the trainers' own permutation. On K-aligned chunks
the two agree within rtol 1e-5 / atol 5e-5 (the float32 step tolerance);
on a chunk that is not a multiple of K they differ by design, because the
JAX package re-derives its apply counter as ``step // K`` at a chunk's
entry and the port keeps its own (named below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.data.packed_dataset import BatchPacker
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch.config import config_from_dict
from news_recsys_tpu_torch.convert import (flatten_sparse_state, sparse_state_from_jax,
                                           sparse_state_to_jax)
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.checkpoint import (load_state, load_state_dict, save_state,
                                                      state_dict)
from news_recsys_tpu_torch.training.trainer import AucHist, Trainer

from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_training import (assert_states_close, jax_params, port_batches,
                                       port_state)

torch.set_num_threads(2)
STEP_TOL = dict(rtol=1e-5, atol=5e-5)
K = 4


def lazy_cfg(optimizer: str, **train):
    return train_cfg(True, embedding_optimizer=optimizer, embedding_update_period=K, **train)


def epoch_order(cfg, ds, epoch: int = 0) -> np.ndarray:
    """(steps, B): the batches of an epoch in the trainers' permutation."""
    bs = cfg.dataset.batch_size
    rng = np.random.default_rng(np.random.SeedSequence([cfg.dataset.shuffle_seed, epoch]))
    nb = len(ds) // bs
    return rng.permutation(len(ds))[: nb * bs].reshape(nb, bs).astype(np.int32)


def jax_chunks(cfg, params, ds, chunks, monkeypatch, mode=""):
    """``make_sparse_chunk_fn`` over consecutive chunks of ``chunks`` steps of
    epoch 0; returns the state (numpy leaves)."""
    monkeypatch.setenv("NRT_PALLAS", mode)
    packer = BatchPacker(ds)
    idx = epoch_order(cfg, ds)
    model = jbuild_ranker(cfg, cfg.name)
    state = jss.init_sparse_state(params, cfg, jss.make_dense_tx(cfg), model.tables)
    run = jss.make_sparse_chunk_fn(model, packer.layout_key(), idx.shape[1], cfg)
    hist, pos = jtrainer.AucHist.zeros(), 0
    for c in chunks:
        state, hist, _ = run(state, hist, packer.int_mat, packer.float_mat,
                             jnp.asarray(idx[pos:pos + c]))
        pos += c
    assert pos == len(idx)
    return jax.device_get(state)


def port_fit(cfg, params, ds, workdir, **fit):
    state = port_state(cfg, params)
    trainer = Trainer(cfg, state.model, workdir=str(workdir), device="cpu")
    return trainer.fit(ds, state=state, max_epochs=1, **fit)


@pytest.mark.parametrize("optimizer,mode", [("rowwise_adagrad", ""),
                                            ("sparse_adamw", ""),
                                            ("sparse_adamw", "interpret")])
def test_lazy_writeback_fit_matches_jax(monkeypatch, tmp_path, optimizer, mode):
    """K = 4 through ``Trainer.fit`` on chunks of 8 and 4 steps (chunk_steps
    8, an epoch of 12), against JAX's chunk function over the same chunks
    (``mode`` "interpret": JAX's sorted layout and its Pallas scatter
    interpreted); three combined updates, each with the lr at its apply
    step."""
    cfg = lazy_cfg(optimizer, chunk_steps=8)
    ds = train_dataset(cfg, 12 * 64, seed=21)
    params = jax_params(cfg, ds, seed=4)
    want = jax_chunks(cfg, params, ds, [8, 4], monkeypatch, mode)
    state = port_fit(cfg, params, ds, tmp_path)
    assert state.step == 12 and state.applies == 3 and state.pending.count == 0
    assert_states_close(state, want, cfg, tol=STEP_TOL)


def test_lazy_writeback_single_step_exact(monkeypatch, tmp_path):
    """With one step, the chunk-end flush applies exactly that step's update:
    K = 4 equals K = 1 bit for bit, and JAX's K = 4. The arena is compared
    on its addressable rows: K = 4's three empty slots of the buffer point
    at the spare row above the vocab, which Adam's weight decay moves."""
    cfgs = {k: train_cfg(True, embedding_optimizer="sparse_adamw", embedding_update_period=k)
            for k in (1, K)}
    ds = train_dataset(cfgs[1], 64, seed=22)
    params = jax_params(cfgs[1], ds, seed=5)
    states = {k: port_fit(c, params, ds, tmp_path / f"k{k}") for k, c in cfgs.items()}
    vocab = cfgs[1].embeddings.embedding_table_size
    n = vocab["user_id"] + vocab["item_id"] - 1                  # the arena's rows
    for name, t in states[1].model.state_dict().items():
        assert torch.equal(states[K].model.state_dict()[name][:n], t[:n]), name
    for key in ("emb_mu", "emb_nu"):
        for name, t in getattr(states[1], key).items():
            assert torch.equal(getattr(states[K], key)[name], t), (key, name)
    assert states[K].applies == 1
    want = jax_chunks(cfgs[K], params, ds, [1], monkeypatch)
    assert_states_close(states[K], want, cfgs[K], tol=STEP_TOL)


def test_lazy_writeback_first_apply_bias_correction(tmp_path):
    """``sparse_adamw`` with K = 2: the first combined apply uses Adam's bias
    correction t = 1 (the apply counter), not the global step. An LR whose
    one parameter is a 5,000 x 1 table, eight distinct ids in two batches of
    four: every gradient is taken at the start values, and one Adam apply
    with t = 1 moves a row by lr * (g / (|g| + 1e-8) + wd * p)."""
    cfg = config_from_dict({
        "name": "lr",
        "features": {"sparse_feature_names": ["user_id"], "item_feature_names": [],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 1},
                       "embedding_table_size": {"user_id": 5000}},
        "dataset": {"batch_size": 4},
        "train_hparams": {"max_epoch": 1, "lr": 1e-2, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": "sparse_adamw",
                          "embedding_update_period": 2},
    })
    ids = np.arange(1, 9, dtype=np.int32)
    labels = (ids % 2).astype(np.float32)
    ds = PackedDataset({"user_id": ids, "label": labels.reshape(-1, 1)})
    model = build_ranker(cfg, seed=3, device="cpu")
    p0 = model.embedder.tables["user_id"].detach()[:, 0].numpy().copy()
    trainer = Trainer(cfg, model, workdir=str(tmp_path), device="cpu")
    state = trainer.fit(ds, max_epochs=1)
    p1 = model.embedder.tables["user_id"].detach()[:, 0].numpy()
    hp = cfg.train_hparams
    g = (1 / (1 + np.exp(-p0[ids].astype(np.float64))) - labels) / 4.0
    delta = hp.lr * (g / (np.abs(g) + 1e-8) + hp.weight_decay * p0[ids])
    np.testing.assert_allclose(p1[ids], p0[ids] - delta, rtol=1e-5, atol=1e-7)
    untouched = np.setdiff1d(np.arange(1, 5000), ids)
    np.testing.assert_array_equal(p1[untouched], p0[untouched])
    assert state.applies == 1 and state.step == 2


def test_apply_counter_diverges_from_jax_on_unaligned_chunks(monkeypatch, tmp_path):
    """The one intended divergence of K-step write-back: on chunks of 6 steps
    with K = 4, each chunk applies twice (a group and the tail of 2). The
    JAX package starts its second chunk's counter at ``6 // 4 = 1`` and so
    gives Adam's bias correction t = 2 twice; the port counts its applies
    (t = 1, 2, 3, 4), so the tables differ. The port with JAX's counter
    forced at each chunk's entry matches JAX again: the counter is the
    whole difference. The lr is held at 1e-3 (the small configs decay it
    to 1e-4 from step 2, which would shrink the difference under the
    tolerance)."""
    cfg = lazy_cfg("sparse_adamw", chunk_steps=6, lr_milestones=[100, 200])
    ds = train_dataset(cfg, 12 * 64, seed=23)
    params = jax_params(cfg, ds, seed=6)
    want = jax_chunks(cfg, params, ds, [6, 6], monkeypatch)
    state = port_fit(cfg, params, ds, tmp_path)
    assert state.applies == 4
    with pytest.raises(AssertionError):
        assert_states_close(state, want, cfg, tol=STEP_TOL)

    state = port_state(cfg, params)
    step = tss.make_sparse_train_step(state.model, cfg)
    hist = AucHist.zeros("cpu")
    batches = list(port_batches(BatchPacker(ds), epoch_order(cfg, ds)))
    for chunk in (batches[:6], batches[6:]):
        state.applies = state.step // K              # as JAX re-derives it
        for j, batch in enumerate(chunk):
            step(state, batch, hist)
            if (j + 1) % K == 0:
                step.flush(state)
        step.flush(state)
    assert_states_close(state, want, cfg, tol=STEP_TOL)


def test_resumed_lazy_writeback_equals_straight(tmp_path):
    """K = 4, ``ckpt_every_steps`` 6 (a checkpoint cuts a group: the chunk
    flushes there) and an epoch of 10 steps (not a multiple of 4): a run cut
    at step 6 and resumed equals the straight run bit for bit."""
    cfg = lazy_cfg("sparse_adamw", ckpt_every_steps=6)
    ds = train_dataset(cfg, 10 * 64, seed=24)
    straight = build_ranker(cfg, seed=7, device="cpu")
    resumed = build_ranker(cfg, seed=7, device="cpu")
    a = Trainer(cfg, straight, workdir=str(tmp_path / "a"), device="cpu").fit(ds, max_epochs=1)
    cut = train_cfg(True, embedding_optimizer="sparse_adamw", embedding_update_period=K,
                    ckpt_every_steps=6, max_step=6)
    Trainer(cut, resumed, workdir=str(tmp_path / "b"), device="cpu").fit(ds, max_epochs=1)
    again = build_ranker(cfg, seed=99, device="cpu")
    b = Trainer(cfg, again, workdir=str(tmp_path / "b"), device="cpu").fit(ds, max_epochs=1,
                                                                            resume=True)
    assert a.step == b.step == 10 and a.applies == b.applies == 3     # chunks of 6 and 4
    want, got = state_dict(a), state_dict(b)
    for name, t in want["model"].items():
        assert torch.equal(got["model"][name], t), name
    for key in ("emb_mu", "emb_nu"):
        for name, t in want[key].items():
            assert torch.equal(got[key][name], t), (key, name)


@pytest.mark.parametrize("optimizer", ["rowwise_adagrad", "sparse_adamw"])
def test_variant_checkpoint_round_trip(tmp_path, optimizer):
    """Port -> port: a K = 4 state after 6 steps (two applies) saved and
    loaded into a fresh state of another seed: every tensor, the step and
    the apply counter. A state with rows pending refuses to be saved."""
    cfg = lazy_cfg(optimizer)
    ds = train_dataset(cfg, 6 * 64, seed=25)
    trainer = Trainer(cfg, build_ranker(cfg, seed=8, device="cpu"), workdir=str(tmp_path),
                      device="cpu")
    state = trainer.fit(ds, max_epochs=1)
    path = save_state(str(tmp_path / "s.pt"), state)
    fresh = tss.init_sparse_state(build_ranker(cfg, seed=9, device="cpu"), cfg)
    loaded = load_state_dict(fresh, load_state(path))
    want, got = state_dict(state), state_dict(loaded)
    assert got["step"] == want["step"] == 6 and got["applies"] == want["applies"] == 2
    for key in ("model", "emb_acc", "emb_mu", "emb_nu"):
        assert sorted(got[key]) == sorted(want[key]), key
        for name, t in want[key].items():
            assert torch.equal(got[key][name], t), (key, name)
    step = tss.make_sparse_train_step(loaded.model, cfg)
    step(loaded, next(port_batches(BatchPacker(ds), epoch_order(cfg, ds))), AucHist.zeros("cpu"))
    with pytest.raises(ValueError, match="pending"):
        save_state(str(tmp_path / "t.pt"), loaded)
    step.flush(loaded)
    save_state(str(tmp_path / "t.pt"), loaded)


def test_sparse_adamw_state_through_jax_and_back(monkeypatch):
    """JAX -> port -> JAX: a ``sparse_adamw`` state after two K = 4 steps
    (one tail apply) comes back leaf for leaf; the port's apply counter
    starts at ``step // K``, as the JAX package derives it."""
    cfg = lazy_cfg("sparse_adamw")
    ds = train_dataset(cfg, 2 * 64, seed=26)
    params = jax_params(cfg, ds, seed=7)
    jstate = jax_chunks(cfg, params, ds, [2], monkeypatch)
    want = flatten_sparse_state(jstate)
    state = sparse_state_from_jax(jstate, build_ranker(cfg, device="cpu"), cfg)
    assert state.step == 2 and state.applies == 0 and sorted(state.emb_nu) == ["arena_d16"]
    got = sparse_state_to_jax(state)
    assert sorted(got) == sorted(want)
    for section in ("params", "emb_mu", "emb_nu"):
        assert sorted(got[section]) == sorted(want[section])
        for k, v in want[section].items():
            np.testing.assert_array_equal(got[section][k], v, err_msg=f"{section} {k}")
    with pytest.raises(ValueError, match="emb_mu"):
        sparse_state_from_jax(jstate, build_ranker(cfg, device="cpu"),
                              lazy_cfg("rowwise_adagrad"))


def test_a_checkpoint_of_the_previous_format_loads(tmp_path):
    """A sparse checkpoint as the port wrote it before ``sparse_adamw`` and
    K-step write-back (``emb_acc`` alone, no ``emb_mu``, ``emb_nu`` or
    ``applies``) loads into a ``rowwise_adagrad`` state."""
    cfg = train_cfg(True)
    state = tss.init_sparse_state(build_ranker(cfg, seed=10, device="cpu"), cfg)
    state.step = 5
    state.emb_acc["arena_d16"].uniform_(0.1, 1.0)
    old = {"kind": "sparse", "model": state.model.state_dict(), "step": 5,
           "dense_opt": state.dense_opt.state_dict(), "emb_acc": dict(state.emb_acc)}
    torch.save(old, str(tmp_path / "epoch_000.pt"))
    fresh = tss.init_sparse_state(build_ranker(cfg, seed=11, device="cpu"), cfg)
    trainer = Trainer(cfg, fresh.model, workdir=str(tmp_path / "w"), device="cpu")
    loaded = trainer.load_checkpoint(fresh, str(tmp_path / "epoch_000.pt"))
    assert loaded.step == trainer.global_step == 5 and loaded.applies == 0
    assert torch.equal(loaded.emb_acc["arena_d16"], state.emb_acc["arena_d16"])
    for name, t in state.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[name], t), name
