"""The port's checkpoints and resume (``training/checkpoint.py`` and the
``Trainer``'s checkpoint methods), on the CPU, on the sparse step and on the
all-dense step.

The resume cases mirror ``tests/test_checkpoint.py``: the step count goes on
from the checkpoint, step checkpoints land on multiples of
``ckpt_every_steps`` (after a restore too), a resumed run continues the same
data order, a run at ``max_step`` trains nothing. Where the JAX package's
tests hold a resumed run to an uninterrupted one within 1e-5 or 1e-6, these
hold the two states equal bit for bit: on the CPU the same steps in the same
order give the same bits, and a checkpoint stores every tensor as it is. A
JAX state converted by ``convert.py`` into a port checkpoint, loaded and
converted back equals the original bit for bit too.
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.data.packed_dataset import iterate_batches
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu_torch.convert import (dense_state_from_jax, dense_state_to_jax,
                                           flatten_dense_state, flatten_sparse_state,
                                           sparse_state_from_jax, sparse_state_to_jax)
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.checkpoint import (CheckpointManager, load_state,
                                                       load_state_dict, save_state, state_dict)
from news_recsys_tpu_torch.training.trainer import Trainer

from tests.test_torch_cuda import train_cfg, train_dataset

torch.set_num_threads(2)

# the sparse step (rowwise AdaGrad on the user and item tables), and the
# all-dense one (AdamW over every parameter)
STEPS = {"sparse": {}, "dense": {"embedding_optimizer": "adamw"}}


def make_cfg(step: str, **train):
    """A narrow DCN at batch 64 (user and item tables of 5,000 and 4,500
    ids, a pooled history of 5), ``max_step`` 10,000."""
    return train_cfg(False, **STEPS[step], **train)


def with_hp(cfg, **train):
    return dataclasses.replace(cfg, train_hparams=dataclasses.replace(cfg.train_hparams, **train))


def new_trainer(cfg, workdir, seed=0) -> Trainer:
    """A port trainer on the CPU whose model is drawn from ``seed``: every
    trainer of one test starts from the same parameters."""
    return Trainer(cfg, build_ranker(cfg, seed=seed, device="cpu"), workdir=str(workdir),
                   device="cpu")


def assert_equal_bits(a, b, path="state"):
    """Two checkpoint dicts (or parts of them) equal: tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            assert_equal_bits(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_bits(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def assert_states_equal(a, b):
    assert_equal_bits(state_dict(a), state_dict(b))


@pytest.mark.parametrize("step", list(STEPS))
def test_resume_continues_step(tmp_path, step):
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 256, seed=1)
    t = new_trainer(cfg, tmp_path)
    s = t.fit(ds, max_epochs=1)
    assert s.step == t.global_step == 4             # 256 / 64
    t.save_step_checkpoint(s, 4)

    t2 = new_trainer(cfg, tmp_path, seed=5)
    s2, ok = t2.restore_latest(t2.init_state())
    assert ok and t2.global_step == s2.step == 4
    assert_states_equal(s2, s)
    s2, _ = t2.train_epoch(s2, ds, epoch=1)
    assert s2.step == t2.global_step == 8


@pytest.mark.parametrize("step", list(STEPS))
def test_restore_latest_with_no_checkpoint(tmp_path, step):
    t = new_trainer(make_cfg(step), tmp_path)
    s = t.init_state()
    s2, ok = t.restore_latest(s)
    assert s2 is s and not ok and t.global_step == 0


@pytest.mark.parametrize("step", list(STEPS))
def test_mid_epoch_periodic_checkpoint(tmp_path, step):
    """ckpt_every_steps writes step checkpoints mid-epoch."""
    cfg = make_cfg(step, ckpt_every_steps=2)
    t = new_trainer(cfg, tmp_path)
    t.fit(train_dataset(cfg, 512, seed=2), max_epochs=1)    # 8 steps of 64
    assert t.checkpoint_manager().all_steps() == [2, 4, 6, 8]
    assert sorted(os.listdir(t.ckpt_dir)) == ["epoch_000.pt", "steps"]


@pytest.mark.parametrize("step", list(STEPS))
def test_resume_keeps_ckpt_cadence(tmp_path, step):
    """After a restore, step checkpoints keep landing on ckpt_every_steps
    multiples counted from step 0, also from a checkpoint off the cadence."""
    cfg = make_cfg(step, ckpt_every_steps=3)
    ds = train_dataset(cfg, 512, seed=3)                    # 8 steps an epoch
    t = new_trainer(cfg, tmp_path)
    s = t.fit(ds, max_epochs=1)
    assert t.checkpoint_manager().all_steps() == [3, 6]
    t.save_step_checkpoint(s, 8)

    t2 = new_trainer(cfg, tmp_path)
    t2.fit(ds, max_epochs=2, resume=True)                   # resumes at 8, runs to 16
    assert t2.checkpoint_manager().all_steps() == [3, 6, 8, 9, 12, 15]


@pytest.mark.parametrize("step", list(STEPS))
def test_resume_after_an_epoch_equals_the_straight_run(tmp_path, step):
    """1 epoch, a checkpoint, a new trainer with ``resume=True`` and 1 more
    epoch: bit for bit the state, and the epoch checkpoint, of 2 epochs
    straight."""
    cfg = make_cfg(step, ckpt_every_steps=4)
    ds = train_dataset(cfg, 300, seed=4)                    # 4 steps an epoch
    ref = new_trainer(cfg, tmp_path / "ref")
    s_ref = ref.fit(ds, max_epochs=2)

    first = new_trainer(cfg, tmp_path / "run")
    first.fit(ds, max_epochs=1)
    second = new_trainer(cfg, tmp_path / "run", seed=7)
    s = second.fit(ds, max_epochs=2, resume=True)
    assert second.global_step == s.step == 8
    assert_states_equal(s, s_ref)
    assert_equal_bits(load_state(os.path.join(second.ckpt_dir, "epoch_001.pt")),
                      load_state(os.path.join(ref.ckpt_dir, "epoch_001.pt")))
    assert second.predict(ds).tobytes() == ref.predict(ds).tobytes()


@pytest.mark.parametrize("step", list(STEPS))
def test_mid_epoch_resume_exact_data_order(tmp_path, step):
    """Cut mid-epoch at step 12 (``max_step``), resumed with the uncut
    config: the same final state as an uninterrupted run, bit for bit."""
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 512, seed=5)                    # 8 steps an epoch
    s_ref = new_trainer(cfg, tmp_path / "ref").fit(ds, max_epochs=2)

    t_b = new_trainer(with_hp(cfg, max_step=12), tmp_path / "b")
    s_b = t_b.fit(ds, max_epochs=2)
    assert t_b.global_step == 12
    t_b.save_step_checkpoint(s_b, 12)

    t_c = new_trainer(cfg, tmp_path / "c")
    t_c.ckpt_dir = t_b.ckpt_dir
    s_c = t_c.fit(ds, max_epochs=2, resume=True)
    assert t_c.global_step == 16
    assert_states_equal(s_c, s_ref)


@pytest.mark.parametrize("step", list(STEPS))
def test_resume_across_truncated_epochs(tmp_path, step):
    """Three sessions, each cut by a higher max_step and resumed from the
    last one's step checkpoints: the final state equals an uninterrupted
    run's bit for bit, and the last epoch's val_log block byte for byte."""
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 512, seed=6)                    # 8 steps an epoch
    dev = train_dataset(cfg, 256, seed=7)

    t_ref = new_trainer(with_hp(cfg, max_step=100), tmp_path / "ref")
    s_ref = t_ref.fit(ds, dev_ds=dev, max_epochs=3)

    # session A: cut in epoch 1 at step 12 (a step checkpoint lands there)
    t_a = new_trainer(with_hp(cfg, max_step=12, ckpt_every_steps=4), tmp_path / "a")
    t_a.fit(ds, dev_ds=dev, max_epochs=3)
    assert t_a.global_step == 12

    # session B: resumes at (epoch 1, offset 4), cut again in epoch 2
    t_b = new_trainer(with_hp(cfg, max_step=20, ckpt_every_steps=4), tmp_path / "b")
    t_b.ckpt_dir = t_a.ckpt_dir
    t_b.fit(ds, dev_ds=dev, max_epochs=3, resume=True)
    assert t_b.global_step == 20

    # session C: resumes at (epoch 2, offset 4) and completes epoch 2
    t_c = new_trainer(with_hp(cfg, max_step=100), tmp_path / "c")
    t_c.ckpt_dir = t_b.ckpt_dir
    s_c = t_c.fit(ds, dev_ds=dev, max_epochs=3, resume=True)
    assert t_c.global_step == 24
    assert_states_equal(s_c, s_ref)

    def last_block(path):
        text = open(path).read()
        return text[text.rindex("Epoch 2 "):]
    assert last_block(t_c.val_log_path) == last_block(t_ref.val_log_path)


@pytest.mark.parametrize("step", list(STEPS))
def test_resume_at_max_step_is_noop(tmp_path, step):
    """Resumed at max_step: no 0-step epoch is validated or checkpointed."""
    cfg = make_cfg(step, max_step=8, ckpt_every_steps=4)
    ds = train_dataset(cfg, 512, seed=8)
    t = new_trainer(cfg, tmp_path)
    s = t.fit(ds, max_epochs=3)
    assert t.global_step == 8

    t2 = new_trainer(cfg, tmp_path)
    s2 = t2.fit(ds, max_epochs=3, resume=True)
    assert t2.global_step == 8
    assert t2.checkpoint_manager().all_steps() == [4, 8]
    assert sorted(os.listdir(t2.ckpt_dir)) == ["epoch_000.pt", "steps"]
    assert open(t2.val_log_path).read() == ""
    assert_states_equal(s2, s)


@pytest.mark.parametrize("step", list(STEPS))
def test_load_checkpoint_is_strict(tmp_path, step):
    """``load_checkpoint`` restores an epoch file and the trainer's step; it
    raises on a checkpoint of the other kind, of other shapes, or none."""
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 300, seed=9)
    t = new_trainer(cfg, tmp_path / "a")
    s = t.fit(ds, max_epochs=1)
    path = os.path.join(t.ckpt_dir, "epoch_000.pt")

    t2 = new_trainer(cfg, tmp_path / "b", seed=3)
    s2 = t2.load_checkpoint(t2.init_state(), path)
    assert t2.global_step == 4
    assert_states_equal(s2, s)

    other = "dense" if step == "sparse" else "sparse"
    t3 = new_trainer(make_cfg(other), tmp_path / "c")
    with pytest.raises(ValueError, match=f"a '{step}' checkpoint does not load into a "
                                         f"'{other}' training state"):
        t3.load_checkpoint(t3.init_state(), path)

    raw = dataclasses.replace(cfg.embeddings, embedding_table_size={
        **cfg.embeddings.embedding_table_size, "user_id": 6000})
    t4 = new_trainer(dataclasses.replace(cfg, embeddings=raw), tmp_path / "d")
    with pytest.raises(RuntimeError, match="size mismatch"):
        t4.load_checkpoint(t4.init_state(), path)
    with pytest.raises(FileNotFoundError):
        t2.load_checkpoint(t2.init_state(), str(tmp_path / "none.pt"))


def test_checkpoint_kinds_must_agree_on_adamw(tmp_path):
    """A sparse state with no AdamW (every table large) and one with AdamW
    do not load into each other."""
    cfg = make_cfg("sparse")
    t = new_trainer(cfg, tmp_path)
    s = t.init_state()
    blob = state_dict(s)
    blob["dense_opt"] = None
    with pytest.raises(ValueError, match="AdamW is absent in the checkpoint, present in the "
                                         "state"):
        load_state_dict(t.init_state(), blob)


def test_manager_lists_and_restores_steps(tmp_path):
    cfg = make_cfg("dense")
    t = new_trainer(cfg, tmp_path)
    s = t.init_state()
    mgr = CheckpointManager(str(tmp_path / "m"))
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(s)
    for k in (10, 2, 30):
        s.step = k
        mgr.save(k, s)
    assert mgr.all_steps() == [2, 10, 30] and mgr.latest_step() == 30
    assert mgr.restore(s, step=10).step == 10
    assert mgr.restore(s).step == 30
    assert not glob.glob(str(tmp_path / "m" / "*.tmp"))


@pytest.mark.parametrize("step", list(STEPS))
def test_jax_state_through_a_port_checkpoint_and_back(tmp_path, step):
    """A JAX state after 4 steps -> ``convert.py`` -> a port checkpoint file
    -> loaded into a fresh port state -> back to the JAX package's layout:
    every array equal to the original's bit for bit."""
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 300, seed=10)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    jstate = jt.init_state(next(iterate_batches(ds, cfg.dataset.batch_size, shuffle=False)))
    jstate = jax.device_get(jt.train_epoch(jstate, ds, 0)[0])
    sparse = step == "sparse"
    model = build_ranker(cfg, device="cpu")
    path = save_state(str(tmp_path / "epoch_000.pt"),
                      (sparse_state_from_jax if sparse else dense_state_from_jax)(jstate, model,
                                                                                   cfg))
    t = new_trainer(cfg, tmp_path / "port", seed=9)
    state = t.load_checkpoint(t.init_state(), path)
    assert t.global_step == 4
    got = (sparse_state_to_jax if sparse else dense_state_to_jax)(state)
    want = (flatten_sparse_state if sparse else flatten_dense_state)(jstate)

    def assert_same(a, b, where):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), where
            for k in b:
                assert_same(a[k], b[k], f"{where}/{k}")
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), where

    assert_same(got, want, "state")


@pytest.mark.parametrize("step", list(STEPS))
def test_model_info_matches_jax(tmp_path, step):
    """``model_info.log`` lists the parameters as the JAX package's does,
    line for line."""
    cfg = make_cfg(step)
    ds = train_dataset(cfg, 64, seed=11)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    jt.init_state(next(iterate_batches(ds, cfg.dataset.batch_size, shuffle=False)))
    t = new_trainer(cfg, tmp_path / "port")
    t.init_state()
    assert ((tmp_path / "port" / "model_info.log").read_text()
            == (tmp_path / "jax" / "model_info.log").read_text())


def read_events(path):
    """(tag, step, value) of every scalar record of an events file."""
    import struct
    out, data = [], open(path, "rb").read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        rec = data[pos + 12: pos + 12 + n]
        pos += 12 + n + 4
        if b"brain.Event" in rec:
            continue
        # Event: wall_time (9 bytes), step (tag 0x10, varint), summary (tag 0x2a)
        i, step, shift = 10, 0, 0
        while True:
            b = rec[i]
            step |= (b & 0x7F) << shift
            i, shift = i + 1, shift + 7
            if not b & 0x80:
                break
        tag_len = rec[i + 5]
        tag = rec[i + 6: i + 6 + tag_len].decode()
        (value,) = struct.unpack_from("<f", rec, i + 7 + tag_len)
        out.append((tag, step, value))
    return out


def test_scalars_go_to_tensorboard(tmp_path):
    """Every finite number of ``metrics.jsonl`` is also a scalar of the
    events file beside it, at the same step."""
    import json
    cfg = make_cfg("sparse")
    t = new_trainer(cfg, tmp_path)
    t.fit(train_dataset(cfg, 300, seed=12), dev_ds=train_dataset(cfg, 128, seed=13),
          max_epochs=2)
    (events,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    want = [(k, m["step"], np.float32(v)) for m in map(json.loads, open(t.metrics_path))
            for k, v in m.items() if k != "step" and isinstance(v, (int, float)) and v == v]
    assert read_events(events) == want
    assert {k for k, _, _ in want} >= {"train_loss", "train_auc", "val_auc", "epoch", "steps"}
