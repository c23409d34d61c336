"""The port's training runtime on the CPU: the slab-streamed path, the
device metric engine and profiling, against the device-resident path, the
host engine and the JAX package.

- The slab path (a packed dataset above ``device_resident_bytes``) gives a
  step the same batch as the resident path, so states, scores and
  validation blocks are equal bit for bit.
- Against JAX's slab path (``jtrainer.Trainer`` with the same budget): the
  DCN's sparse step after 6-8 steps within rtol 1e-5 / atol 5e-5 (the
  float32 step tolerance of the slice, tests/test_torch_trainer.py), with
  ``skip_steps``, K-step write-back (K 4) and a step checkpoint that cuts a
  slab.
- The device engine against the host engine and JAX's
  ``compute_user_metrics_device`` within abs 2e-5 (``User_Count`` exact),
  the tolerance of tests/test_metrics_device.py: both device engines take
  float32 scores, the host engine float64.
"""

import glob
import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import trainer as jtrainer
from news_recsys_tpu.training.metrics import compute_user_metrics as jhost_metrics
from news_recsys_tpu.training.metrics_device import compute_user_metrics_device as jdev_metrics
from news_recsys_tpu_torch.convert import params_from_flax, sparse_state_from_jax
from news_recsys_tpu_torch.data.packed_dataset import BatchPacker
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset as TPackedDataset
from news_recsys_tpu_torch.models import dssm as tdssm
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import metrics_device as tmetrics_device
from news_recsys_tpu_torch.training import retrieval as tretrieval
from news_recsys_tpu_torch.training.metrics import compute_user_metrics
from news_recsys_tpu_torch.training.metrics_device import compute_user_metrics_device
from news_recsys_tpu_torch.training.trainer import Trainer
from news_recsys_tpu_torch.utils import profiling

from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_retrieval import configs, dssm_arrays, dssm_raw, eval_sets
from tests.test_torch_training import assert_states_close, jax_params

torch.set_num_threads(2)
STEP_TOL = dict(rtol=1e-5, atol=5e-5)
METRIC_TOL = 2e-5


def budget(cfg, ds, steps: int) -> int:
    """A ``device_resident_bytes`` that sends ``ds`` down the slab path with
    slabs of ``steps`` batches."""
    packer = BatchPacker(ds)
    row = (packer.int_mat.nbytes + packer.float_mat.nbytes) / len(ds)
    return int(row * cfg.dataset.batch_size * steps) + 1


def with_budget(cfg, nbytes: int):
    import dataclasses
    return dataclasses.replace(cfg, train_hparams=dataclasses.replace(
        cfg.train_hparams, device_resident_bytes=nbytes))


def assert_same_bits(a: torch.nn.Module, b: torch.nn.Module):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def assert_same_blocks(got: dict, want: dict):
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


# -- the slab-streamed path ----------------------------------------------------

RANKER_CASES = {
    "rowwise": dict(),
    "dense": dict(embedding_optimizer="adamw"),
    # K 4 flushes where chunks end: chunk_steps at the slab's size keeps the
    # resident path's chunks, so the two flush at the same steps
    "sparse_adamw_K4": dict(embedding_optimizer="sparse_adamw", embedding_update_period=4,
                            chunk_steps=3),
}


@pytest.mark.parametrize("case", list(RANKER_CASES))
def test_slab_path_equals_the_resident_path(tmp_path, case):
    """Two epochs of 7 steps (batch 64; the slab path's 3 a slab, so a
    slab ends inside each epoch), ``predict`` of 450 rows (eval batch 64,
    the tail padded) and ``validate`` on the device engine: the same bits
    on both paths."""
    cfg = train_cfg(False, device_metrics_min_rows=0, **RANKER_CASES[case])
    ds = train_dataset(cfg, 7 * 64 + 5, seed=30)
    dev = train_dataset(cfg, 450, seed=31)
    slab_cfg = with_budget(cfg, budget(cfg, ds, 3))
    runs = {}
    for name, c in (("resident", cfg), ("slab", slab_cfg)):
        t = Trainer(c, build_ranker(c, seed=2, device="cpu"), workdir=str(tmp_path / name),
                    device="cpu")
        state = t.fit(ds, max_epochs=2)
        runs[name] = (t, state, t.predict(dev), t.validate(state, dev, 1, warm_user_set={1, 2}))
    (rt, rs, rp, rv), (st, ss, sp, sv) = runs["resident"], runs["slab"]
    assert rt._packer(ds)[1] is not None and st._packer(ds)[1] is None
    assert st._slab_chunk_cap(st._packer(ds)[0], 64) == 3
    assert st._packer(dev)[1] is None                          # predict streams too
    assert ss.step == rs.step == 14
    assert_same_bits(ss.model, rs.model)
    for key in ("emb_acc", "emb_mu", "emb_nu"):
        for t, x in (getattr(rs, key, None) or {}).items():
            assert torch.equal(getattr(ss, key)[t], x), (key, t)
    np.testing.assert_array_equal(sp, rp)
    assert_same_blocks(sv, rv)


@pytest.mark.parametrize("nbytes", [1, 5_000, 70_000, 10 ** 9])
def test_slab_cap_follows_jax(tmp_path, nbytes):
    """``_slab_chunk_cap`` and ``_use_device_resident`` give JAX's answers."""
    cfg = with_budget(train_cfg(True), nbytes)
    ds = train_dataset(cfg, 1000, seed=32)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    t = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path / "port"),
                device="cpu")
    jpacker, packer = jt._packer(ds), BatchPacker(ds)
    assert t._slab_chunk_cap(packer, 64) == jt._slab_chunk_cap(jpacker, 64)
    assert t._use_device_resident(packer) == jt._use_device_resident(jpacker)
    assert (t._packer(ds)[1] is None) == (not jt._use_device_resident(jpacker))


@pytest.mark.parametrize("skip", [0, 2])
def test_slab_path_matches_jax(monkeypatch, tmp_path, skip):
    """The DCN's rowwise AdaGrad step with K 4, slabs of 3 batches and a step
    checkpoint every 5 steps, one epoch of 8 steps after ``skip`` from the
    same state: JAX's chunks are 3, 2 | 3, 3 (2 | 3, 3 after a skip of 2),
    each flushed at its end, and the port's the same."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = train_cfg(True, embedding_update_period=4, ckpt_every_steps=5)
    ds = train_dataset(cfg, 8 * 64 + 9, seed=33)
    cfg = with_budget(cfg, budget(cfg, ds, 3))
    params = jax_params(cfg, ds, seed=6)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    from news_recsys_tpu.training import sparse_step as jss
    jstate = jss.init_sparse_state(params, cfg, jss.make_dense_tx(cfg), jt.model.tables)
    assert not jt._use_device_resident(jt._packer(ds))
    jstate, jm = jt.train_epoch(jstate, ds, 0, skip_steps=skip)
    jstate = jax.device_get(jstate)

    t = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                workdir=str(tmp_path / "port"), device="cpu")
    state = sparse_state_from_jax(jax.device_get(jss.init_sparse_state(
        params, cfg, jss.make_dense_tx(cfg), jt.model.tables)), t.model, cfg)
    state, m = t.train_epoch(state, ds, 0, skip_steps=skip)
    assert m["steps"] == jm["steps"] == 8 - skip
    assert t.global_step == jt.global_step == state.step
    assert sorted(os.listdir(tmp_path / "port" / "ckpts" / "steps")) == ["step_000000005.pt"]
    assert_states_close(state, jstate, cfg, tol=STEP_TOL)
    np.testing.assert_allclose(m["train_loss"], jm["train_loss"], **STEP_TOL)


def test_slab_predict_matches_jax(monkeypatch, tmp_path):
    """``predict`` on the slab path (slabs of 2 eval batches of 64, 300 rows,
    the tail padded with the last row) against JAX's slab ``predict``."""
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = train_cfg(True)
    ds = train_dataset(cfg, 300, seed=34)
    cfg = with_budget(cfg, budget(cfg, ds, 2))
    params = jax_params(cfg, ds, seed=7)
    jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=str(tmp_path / "jax"),
                          use_mesh=False)
    want = jt.predict(params, ds)
    t = Trainer(cfg, params_from_flax(params, build_ranker(cfg, device="cpu")),
                workdir=str(tmp_path / "port"), device="cpu")
    assert t._packer(ds)[1] is None
    np.testing.assert_allclose(t.predict(ds), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["adamw", "rowwise_adagrad"])
def test_dssm_slab_epoch_equals_the_resident_epoch(tmp_path, optimizer):
    """``DSSMTrainer`` inherits the slab path: two epochs of 4 steps with
    slabs of 3 batches (the epoch's negatives, its carry, are indexed by
    the global step, so a slab does not move them) and the retrieval
    encodes, bit for bit as on the resident path."""
    raw = dssm_raw(optimizer, large=optimizer != "adamw")
    _, cfg = configs(raw)
    ds = TPackedDataset(dssm_arrays(raw, 4 * 32 + 5, 35))
    items, query, targets, histories = eval_sets(raw, 36)
    item_ds, query_ds = TPackedDataset(items), TPackedDataset(query)
    slab_cfg = with_budget(cfg, budget(cfg, ds, 3))
    runs = {}
    for name, c in (("resident", cfg), ("slab", slab_cfg)):
        t = tretrieval.DSSMTrainer(c, tdssm.build_dssm(c, seed=1, device="cpu"),
                                   workdir=str(tmp_path / name), device="cpu")
        state = t.fit(ds, max_epochs=2)
        runs[name] = (t, state, t.encode_item_corpus(item_ds), t.encode_users(query_ds))
    assert runs["slab"][0]._packer(ds)[1] is None
    assert runs["slab"][1].step == runs["resident"][1].step == 8
    assert_same_bits(runs["slab"][1].model, runs["resident"][1].model)
    for i in (2, 3):
        np.testing.assert_array_equal(runs["slab"][i], runs["resident"][i])


# -- the device metric engine --------------------------------------------------

def metric_case(rng, n=4000, n_users=250, quantize=None, no_pos_users=0):
    uids = rng.integers(1, n_users + 1, n)
    scores = rng.random(n)
    if quantize:
        scores = np.round(scores * quantize) / quantize
    labels = (rng.random(n) < 0.12).astype(np.float64)
    labels[np.isin(uids, np.arange(1, no_pos_users + 1))] = 0.0
    warm = set(int(u) for u in rng.choice(np.arange(1, n_users + 1), n_users // 2,
                                          replace=False))
    return uids, scores, labels, warm


def assert_blocks_close(got, want, tol=METRIC_TOL):
    assert list(got) == list(want)
    for cohort in want:
        assert sorted(got[cohort]) == sorted(want[cohort]), cohort
        for key, val in want[cohort].items():
            if key == "User_Count":
                assert got[cohort][key] == val, cohort
            else:
                assert got[cohort][key] == pytest.approx(val, abs=tol), (cohort, key)


METRIC_CASES = {
    "distinct": dict(),
    "ties": dict(quantize=6),
    "no_positives": dict(no_pos_users=40, quantize=20),
    "one_row_users": dict(n=300, n_users=250),
    "heavy_users": dict(n=60_000, n_users=40),
}


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_device_engine_matches_host_and_jax(case, warm):
    """Against the port's host engine, the JAX host engine and JAX's device
    engine; without a warm set every user is warm and Cold_Start is empty."""
    rng = np.random.default_rng(40)
    uids, scores, labels, warm_set = metric_case(rng, **METRIC_CASES[case])
    warm_set = warm_set if warm else None
    got = compute_user_metrics_device(uids, scores, labels, warm_set, device="cpu")
    assert_blocks_close(got, compute_user_metrics(uids, scores, labels, warm_set))
    assert_blocks_close(got, jhost_metrics(uids, scores, labels, warm_set))
    jdev = jdev_metrics(uids, scores, labels, warm_set)
    assert_blocks_close(got, {c: {k: jdev[c][k] for k in got[c]} for c in got})
    if not warm:
        assert got["Cold_Start"]["User_Count"] == 0


def test_device_engine_large_n_with_ties():
    """300,000 rows with ties and a few users of ~5,000 rows: the per-user
    sums stay exact (twice the ranks, in int64), pooled AUC and LogLoss are
    the host's float64 functions on float32 scores."""
    rng = np.random.default_rng(41)
    n, n_users = 300_000, 20_000
    uids = rng.integers(1, n_users + 1, n)
    uids[:25_000] = rng.integers(1, 6, 25_000)
    scores = np.round(rng.random(n) * 5_000) / 5_000
    labels = (rng.random(n) < 0.08).astype(np.float64)
    warm = set(range(1, n_users // 2))
    got = compute_user_metrics_device(uids, scores, labels, warm, device="cpu")
    assert_blocks_close(got, compute_user_metrics(uids, scores, labels, warm))
    assert_blocks_close(got, compute_user_metrics(uids, scores.astype(np.float32), labels, warm),
                        tol=1e-9)


def test_device_engine_repeats_its_bits():
    rng = np.random.default_rng(42)
    uids, scores, labels, warm = metric_case(rng, quantize=6)
    a, b = (compute_user_metrics_device(uids, scores, labels, warm, device="cpu")
            for _ in range(2))
    assert_same_blocks(a, b)


def test_empty_input_gives_the_empty_block():
    e = np.zeros(0)
    assert compute_user_metrics_device(e, e, e, device="cpu") == compute_user_metrics(e, e, e)


@pytest.mark.parametrize("min_rows,engine", [(0, "device"), (451, "host")])
def test_validate_takes_the_engine_from_device_metrics_min_rows(monkeypatch, tmp_path,
                                                                min_rows, engine):
    """``validate`` takes the device engine from ``device_metrics_min_rows``
    rows, as JAX's trainer does (``trainer.py:532-540``), else the host's."""
    from news_recsys_tpu_torch.training import trainer as ttrainer
    cfg = train_cfg(True, device_metrics_min_rows=min_rows)
    dev = train_dataset(cfg, 450, seed=43)
    calls = []
    for name in ("compute_user_metrics_device", "compute_user_metrics"):
        real = getattr(ttrainer, name)
        monkeypatch.setattr(ttrainer, name,
                            lambda *a, real=real, name=name, **kw: calls.append(name) or real(*a, **kw))
    t = Trainer(cfg, build_ranker(cfg, seed=3, device="cpu"), workdir=str(tmp_path), device="cpu")
    got = t.validate(t.init_state(), dev, 0, warm_user_set={1, 2, 3})
    assert calls == ["compute_user_metrics_device" if engine == "device"
                     else "compute_user_metrics"]
    want = compute_user_metrics(dev.arrays["user_id"], t.predict(dev), dev.arrays["label"][:, 0],
                                {1, 2, 3})
    assert_blocks_close(got, want)


def test_device_engine_defaults_to_the_card():
    """The engine runs on the card unless asked for the CPU."""
    rng = np.random.default_rng(44)
    uids, scores, labels, _ = metric_case(rng, n=100, n_users=10)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        tmetrics_device.compute_user_metrics_device(uids, scores, labels)


# -- profiling -----------------------------------------------------------------

def read_trace(log_dir: str) -> dict:
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json*"))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    names = {e.get("name") for e in read_trace(str(tmp_path / "prof"))["traceEvents"]}
    assert "aten::mm" in names


def test_profile_steps_traces_all_of_epoch_0(tmp_path):
    """``Trainer(profile_steps=1)`` traces epoch 0 into ``<log_dir>/profile``
    and no later epoch. Like JAX's trainer (``trainer.py:392``), it reads
    the count only as a flag: the trace holds every step of the epoch (4
    here), not 1 (ROADMAP queue 3, the reference's open faults)."""
    cfg = train_cfg(True)
    ds = train_dataset(cfg, 4 * 64, seed=45)
    t = Trainer(cfg, build_ranker(cfg, seed=4, device="cpu"), workdir=str(tmp_path),
                device="cpu", profile_steps=1)
    t.fit(ds, max_epochs=2)
    events = read_trace(str(tmp_path / "profile"))["traceEvents"]
    steps = [e for e in events if str(e.get("name", "")).startswith("Optimizer.step#AdamW")]
    assert len(steps) == 4
    assert len(glob.glob(str(tmp_path / "profile" / "*.pt.trace.json*"))) == 1


def test_dssm_trainer_takes_profile_steps(tmp_path):
    raw = dssm_raw()
    _, cfg = configs(raw)
    t = tretrieval.DSSMTrainer(cfg, tdssm.build_dssm(cfg, seed=1, device="cpu"),
                               workdir=str(tmp_path), device="cpu", profile_steps=2)
    assert t.profile_steps == 2


def test_device_memory_stats_lists_each_card():
    stats = profiling.device_memory_stats()
    assert len(stats) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    for s in stats:
        assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} <= set(s)
