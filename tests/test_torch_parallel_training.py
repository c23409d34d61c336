"""The port's trainer over gloo ranks on the CPU: against one process and
against the JAX package's trainer on meshes of the same shape.

Two spawns (``spawn_ranks``, ``file://`` rendezvous under ``tmp_path``, one
thread a rank) run every layout here; the one-process references run in
this process under the same ``torch.set_num_threads(1)``:

- (data 1, model 2), two epochs of a narrow DCN (``train_cfg``: a joint
  dedup of the user and item tables, a ``hist`` pooled over the item table,
  a small ``category`` table on AdamW): ``rowwise_adagrad``,
  ``sparse_adamw``, the all-dense ``adamw`` step, bfloat16 tables and
  K-step write-back. The gathered state equals one process's bit for bit:
  the forward reads the same rows and the update sees the same slots.
  ``sparse_adamw`` leaves out the spare rows, which the sharded route
  never writes (JAX's ``OOB_ROW``) and one process moves by weight decay;
  DeepFM and the attention ranker (``attention_config``, batch 64) too;
- checkpoints between layouts: the two-rank run's epoch checkpoint loads
  into one process and predicts the same scores, and a one-process
  checkpoint continues on two ranks as it continues on one, bit for bit;
- (data 2, model 2), one epoch of ``rowwise_adagrad``, ``sparse_adamw`` and
  ``adamw``: the predictions against JAX's ``Trainer`` under
  ``make_mesh(data=2, model=2, devices=jax.devices()[:4])`` and against one
  process, at the JAX package's own tolerances (atol 2e-4 on the sparse
  step's predictions, 1e-4 on the dense step's: ``tests/test_sparse_optim.py``,
  ``tests/test_trainer.py``); every rank gets the same gathered scores.

The spawned ranks import this module, so JAX is imported inside the
fixtures and tests that use it, never at the top.
"""

import os

import numpy as np
import pytest
import torch

from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.parallel.distributed import spawn_ranks
from news_recsys_tpu_torch.parallel.mesh import Mesh
from news_recsys_tpu_torch.training.checkpoint import load_state, state_dict
from news_recsys_tpu_torch.training.trainer import Trainer
from news_recsys_tpu_torch.zoo import attention_arrays, attention_config

from tests.test_torch_cuda import train_cfg, train_dataset, zoo_train_cfg

torch.set_num_threads(2)

BIT_RUNS = {
    "rowwise_adagrad": {},
    "sparse_adamw": {"embedding_optimizer": "sparse_adamw"},
    "adamw": {"embedding_optimizer": "adamw"},
    "bf16": {"bf16": True},
    "K4": {"embedding_update_period": 4},
}
# other rankers at (1, 2): DeepFM (the FM second order, a pooled hist) and
# the attention ranker (its unpooled history of 30 read through the
# exchange as (B, L) ids, the fused block), batch 64
ZOO_RUNS = ("deepfm", "attention")
JAX_RUNS = {"rowwise_adagrad": {}, "sparse_adamw": {"embedding_optimizer": "sparse_adamw"},
            "adamw": {"embedding_optimizer": "adamw"}}
JAX_ATOL = {"rowwise_adagrad": 2e-4, "sparse_adamw": 2e-4, "adamw": 1e-4}


def run_cfg(opts):
    opts = dict(opts)
    mesh = {"param_dtype": "bfloat16"} if opts.pop("bf16", False) else None
    return train_cfg(False, mesh=mesh, **opts)


def blob_arrays(blob) -> dict:
    """A checkpoint dict's tensors by a flat name, as numpy (bfloat16 as
    float32)."""
    out = {f"model/{k}": v for k, v in blob["model"].items()}
    for key in ("emb_acc", "emb_mu", "emb_nu"):
        out.update({f"{key}/{t}": v for t, v in blob.get(key, {}).items()})
    for key in ("opt", "dense_opt"):
        for i, st in ((blob.get(key) or {}).get("state") or {}).items():
            out.update({f"{key}/{i}/{k}": v for k, v in st.items() if k != "step"})
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def fit_run(run, mesh, workdir):
    """A trainer of ``run``'s config on ``mesh`` (None: one process) from
    ``run["weights"]`` in ``run.get("workdir", workdir)``, trained
    ``run["epochs"]`` epochs (``fit(resume=run.get("resume"))``), or, with
    ``run["load"]`` (a checkpoint after epoch 0), loaded from it and trained
    epoch 1; returns (trainer, state, dataset)."""
    cfg = run["cfg"]
    model = build_ranker(cfg, device="cpu")
    model.load_state_dict(run["weights"])
    trainer = Trainer(cfg, model, workdir=run.get("workdir", workdir), device="cpu", mesh=mesh)
    state = trainer.init_state()
    ds = (PackedDataset(run["arrays"]) if "arrays" in run
          else train_dataset(cfg, run["rows"], seed=run["seed"]))
    if run.get("load"):
        state, _ = trainer.train_epoch(trainer.load_checkpoint(state, run["load"]), ds, 1)
    else:
        state = trainer.fit(ds, max_epochs=run["epochs"], state=state,
                            resume=run.get("resume", False))
    return trainer, state, ds


def trainer_worker(rank, runs, root):
    """Each run on its own mesh: the predictions (the gathered scores, on
    every rank) and, on rank 0, the gathered state's arrays."""
    out = {}
    meshes = {}
    for name, run in runs.items():
        lay = run["layout"]
        mesh = meshes.get(lay) or meshes.setdefault(lay, Mesh(*lay))
        trainer, state, ds = fit_run(run, mesh, os.path.join(root, name))
        blob = state_dict(state, mesh)
        out[name] = (trainer.predict(ds), blob_arrays(blob) if rank == 0 else None)
    return out


def one_process(run, workdir):
    """(predictions, state arrays, trainer) of ``run`` in this process, at one
    thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer, state, ds = fit_run(run, None, workdir)
        return trainer.predict(ds), blob_arrays(state_dict(state)), trainer
    finally:
        torch.set_num_threads(threads)


def initial_weights(cfg, seed=3):
    net = build_ranker(cfg, seed=seed, device="cpu")
    return {k: v.clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The (data 1, model 2) runs and the checkpoint runs on two ranks, with
    their one-process references."""
    root = str(tmp_path_factory.mktemp("two"))
    runs = {}
    for name, opts in BIT_RUNS.items():
        cfg = run_cfg(opts)
        runs[name] = dict(cfg=cfg, layout=(1, 2), weights=initial_weights(cfg), rows=300,
                          seed=8, epochs=2)
    cfg = zoo_train_cfg("deepfm", arena=False)
    runs["deepfm"] = dict(runs["rowwise_adagrad"], cfg=cfg, weights=initial_weights(cfg))
    cfg = attention_config(batch_size=64)
    runs["attention"] = dict(cfg=cfg, layout=(1, 2), weights=initial_weights(cfg),
                             arrays=attention_arrays(256, seed=5), epochs=2)
    # a one-process checkpoint after one epoch, continued for one more
    base = dict(runs["sparse_adamw"], epochs=1)
    _, _, trainer = one_process(base, os.path.join(root, "ckpt_source"))
    runs["resumed"] = dict(base, load=os.path.join(trainer.ckpt_dir, "epoch_000.pt"))
    refs = {name: one_process(run, os.path.join(root, "ref", name))
            for name, run in runs.items()}
    # step checkpoints every 2 steps of a run cut at step 6 (mid epoch 1),
    # resumed with fit(resume=True) under the other layout by a model of
    # other weights, which only the restore replaces
    ada = runs["rowwise_adagrad"]
    cut, full = run_cfg({"ckpt_every_steps": 2, "max_step": 6}), run_cfg({"ckpt_every_steps": 2})
    one_process(dict(ada, cfg=cut), os.path.join(root, "cut_one"))
    other = initial_weights(full, seed=99)
    runs["resume_on_ranks"] = dict(ada, cfg=full, workdir=os.path.join(root, "cut_one"),
                                   resume=True, weights=other)
    runs["cut_on_ranks"] = dict(ada, cfg=cut, workdir=os.path.join(root, "cut_ranks"))
    got = spawn_ranks(trainer_worker, 2, (runs, os.path.join(root, "ranks")),
                      init_method=f"file://{root}/store", threads=1, timeout=300)
    refs["resume_on_one"] = one_process(dict(ada, cfg=full, resume=True, weights=other),
                                        os.path.join(root, "cut_ranks"))
    return runs, refs, got, root


def spare_rows(run):
    """Flat names -> rows above every real id (the padded spare rows) of the
    large tables and their moments."""
    cfg = run["cfg"]
    sizes = cfg.embeddings.embedding_table_size
    return {t: sizes[t] for t in ("user_id", "item_id")}


@pytest.mark.parametrize("name", list(BIT_RUNS) + list(ZOO_RUNS))
def test_model_parallel_equals_one_process(two_ranks, name):
    """Tables, accumulators or moments, dense parameters and AdamW's moments
    after two epochs at (data 1, model 2): bit for bit one process's (the
    spare rows aside for ``sparse_adamw``), and the same predictions on both
    ranks."""
    runs, refs, got, _ = two_ranks
    pred, arrays = got[0][name]
    ref_pred, ref_arrays, _ = refs[name]
    np.testing.assert_array_equal(got[1][name][0], pred)
    np.testing.assert_array_equal(pred, ref_pred)
    assert set(arrays) == set(ref_arrays)
    spare = spare_rows(runs[name]) if name == "sparse_adamw" else {}
    for key, want in ref_arrays.items():
        have = arrays[key]
        table = key.rsplit("/", 1)[-1].rsplit(".", 1)[-1]
        if table in spare and have.ndim == 2 and have.shape[0] > 1000:
            have, want = have[:spare[table]], want[:spare[table]]
        np.testing.assert_array_equal(have, want, err_msg=key)


def test_sharded_adamw_leaves_padding_and_spare_rows(two_ranks):
    """``sparse_adamw`` at (1, 2): the padding row 0 and every row above the
    vocab keep their initial values (their slots route out of every shard),
    while one process's joint dedup clips slots onto the spare row, where
    weight decay moves it."""
    runs, refs, got, _ = two_ranks
    run = runs["sparse_adamw"]
    _, arrays = got[0]["sparse_adamw"]
    _, ref_arrays, _ = refs["sparse_adamw"]
    moved = 0
    for t, vocab in spare_rows(run).items():
        init = run["weights"][f"embedder.tables.{t}"].numpy()
        have = arrays[f"model/embedder.tables.{t}"]
        np.testing.assert_array_equal(have[0], 0.0)
        np.testing.assert_array_equal(have[vocab:], init[vocab:])
        for m in ("emb_mu", "emb_nu"):
            np.testing.assert_array_equal(arrays[f"{m}/{t}"][vocab:], 0.0)
        moved += int((ref_arrays[f"model/embedder.tables.{t}"][vocab:] != init[vocab:]).any())
    assert moved > 0


def test_two_rank_checkpoint_loads_in_one_process(two_ranks, tmp_path):
    """The epoch checkpoint process 0 wrote at (1, 2) is one process's format:
    a one-process trainer loads it and predicts the ranks' scores."""
    runs, _, got, root = two_ranks
    run = runs["rowwise_adagrad"]
    path = os.path.join(root, "ranks", "rowwise_adagrad", "ckpts", "epoch_001.pt")
    blob = load_state(path)
    assert blob["kind"] == "sparse" and blob["step"] == 8
    assert blob["model"]["embedder.tables.user_id"].shape == (5120, 16)
    cfg = run["cfg"]
    trainer = Trainer(cfg, build_ranker(cfg, device="cpu"), workdir=str(tmp_path), device="cpu")
    state = trainer.load_checkpoint(trainer.init_state(), path)
    assert state.step == trainer.global_step == 8
    np.testing.assert_array_equal(trainer.predict(train_dataset(cfg, 300, seed=8)),
                                  got[0]["rowwise_adagrad"][0])
    for name in os.listdir(os.path.join(root, "ranks", "rowwise_adagrad")):
        assert name in ("ckpts", "val_log.log", "train.log", "metrics.jsonl",
                        "model_info.log") or name.startswith("events.out.tfevents")


def test_one_process_checkpoint_continues_on_two_ranks(two_ranks):
    """A one-process ``sparse_adamw`` checkpoint after one epoch, loaded by
    both ranks (each keeps its rows) and trained one more epoch: one
    process's continuation, bit for bit (the spare rows aside)."""
    runs, refs, got, _ = two_ranks
    pred, arrays = got[0]["resumed"]
    ref_pred, ref_arrays, _ = refs["resumed"]
    np.testing.assert_array_equal(pred, ref_pred)
    spare = spare_rows(runs["resumed"])
    for key, want in ref_arrays.items():
        table = key.rsplit(".", 1)[-1].rsplit("/", 1)[-1]
        have = arrays[key]
        if table in spare and have.ndim == 2 and have.shape[0] > 1000:
            have, want = have[:spare[table]], want[:spare[table]]
        np.testing.assert_array_equal(have, want, err_msg=key)


@pytest.mark.parametrize("where", ["ranks", "one"])
def test_step_checkpoints_resume_across_layouts(two_ranks, where):
    """A run cut at step 6 (step checkpoints every 2) by one process and
    resumed with ``fit(resume=True)`` on two ranks, and cut on two ranks and
    resumed by one process: each ends where the straight two-epoch run ends,
    bit for bit (``rowwise_adagrad``)."""
    _, refs, got, root = two_ranks
    steps = sorted(os.listdir(os.path.join(root, "cut_ranks" if where == "one" else "cut_one",
                                           "ckpts", "steps")))
    assert steps[:3] == [f"step_{s:09d}.pt" for s in (2, 4, 6)]
    pred, arrays = (got[0]["resume_on_ranks"] if where == "ranks"
                    else refs["resume_on_one"][:2])
    ref_pred, ref_arrays, _ = refs["rowwise_adagrad"]
    np.testing.assert_array_equal(pred, ref_pred)
    for key, want in ref_arrays.items():
        np.testing.assert_array_equal(arrays[key], want, err_msg=key)


def test_model_info_lists_whole_tables(two_ranks):
    """``model_info.log`` of a sharded run names each table's whole shape, as
    one process's does."""
    _, _, _, root = two_ranks
    with open(os.path.join(root, "ranks", "rowwise_adagrad", "model_info.log")) as f:
        sharded = f.read()
    with open(os.path.join(root, "ref", "rowwise_adagrad", "model_info.log")) as f:
        assert sharded == f.read()
    assert "params/embedder/user_id | (5120, 16)" in sharded


# -- (data 2, model 2) against JAX ------------------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Predictions after one epoch at (2, 2): JAX's trainer, the four ranks,
    one process. The parameters are the JAX trainer's init, converted."""
    import jax

    from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training import trainer as jtrainer
    from news_recsys_tpu_torch.convert import params_from_flax
    from tests.test_torch_training import jax_params

    os.environ["NRT_PALLAS"] = ""                 # JAX's XLA routes
    root = str(tmp_path_factory.mktemp("four"))
    runs, jax_preds = {}, {}
    for name, opts in JAX_RUNS.items():
        cfg = run_cfg(opts)
        ds = train_dataset(cfg, 300, seed=11)
        jt = jtrainer.Trainer(cfg, jbuild_ranker(cfg, "dcn"), workdir=os.path.join(root, "jax"),
                              mesh=make_mesh(2, 2, devices=jax.devices()[:4]))
        jstate = jt.fit(ds, max_epochs=1)
        jax_preds[name] = np.asarray(jt.predict(jstate.params, ds))
        params = jax_params(cfg, ds, seed=cfg.train_hparams.seed)
        weights = initial_weights(cfg)
        weights.update(params_from_flax(params, build_ranker(cfg, device="cpu")).state_dict())
        runs[name] = dict(cfg=cfg, layout=(2, 2), weights=weights, rows=300, seed=11, epochs=1)
    refs = {name: one_process(run, os.path.join(root, "ref", name))[0]
            for name, run in runs.items()}
    got = spawn_ranks(trainer_worker, 4, (runs, os.path.join(root, "ranks")),
                      init_method=f"file://{root}/store", threads=1, timeout=300)
    return jax_preds, refs, got


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_data_and_model_parallel_matches_jax(four_ranks, name):
    jax_preds, refs, got = four_ranks
    pred = got[0][name][0]
    assert pred.shape == (300,) and np.isfinite(pred).all()
    for r in range(1, 4):
        np.testing.assert_array_equal(got[r][name][0], pred)
    np.testing.assert_allclose(pred, jax_preds[name], atol=JAX_ATOL[name])
    np.testing.assert_allclose(pred, refs[name], atol=JAX_ATOL[name])
