"""The port's DSSM trainer over gloo ranks on the CPU, against one process
and against the JAX package's ``DSSMTrainer`` on meshes of the same shape,
as ``tests/test_retrieval.py`` holds JAX's to one device: ``adamw`` at data
parallel 2 and ``rowwise_adagrad`` at (data 2, model 2), two epochs each,
the encodings within atol 2e-4 (its tolerance). At (data 1, model 2) the
all-dense DSSM step (the pooled ``hist`` on the compact table of exchanged
rows) equals one process bit for bit, through ``DSSMTrainer`` and through
``train`` on two processes.

Each step's negatives are permutations of the global batch. JAX draws them
inside its step from ``fold_in(key, step)``; the port takes them as the
epoch's carry, so every run here gets JAX's (rebuilt outside the JAX
package, as ``tests/test_torch_retrieval.py`` does). Under a data axis a
rank's users meet negatives drawn from every rank's items: the item tower's
outputs are gathered with their gradient.

The spawned ranks import this module, so JAX is imported inside the
fixtures, never at the top.
"""

import os

import numpy as np
import pytest
import torch

from news_recsys_tpu_torch.config import config_from_dict
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.parallel.distributed import spawn_ranks
from news_recsys_tpu_torch.parallel.mesh import Mesh
from news_recsys_tpu_torch.training.retrieval import DSSMTrainer, NegativeDraws

torch.set_num_threads(2)
ENC_ATOL = 2e-4
EPOCHS, STEPS, BATCH = 2, 4, 32


def fit_dssm(run, mesh, workdir):
    """(user encodings, item encodings, every step's loss) after
    ``EPOCHS`` epochs of ``run`` on ``mesh`` (None: one process), every
    step's negatives JAX's."""
    cfg = config_from_dict(run["raw"])
    model = build_dssm(cfg, device="cpu")
    model.load_state_dict(run["weights"])
    trainer = DSSMTrainer(cfg, model, workdir=workdir, device="cpu", mesh=mesh)
    perms = torch.from_numpy(run["perms"])
    trainer._epoch_carry = lambda epoch, first, steps: NegativeDraws(
        perms[first:first + steps], first)
    ds = PackedDataset(run["arrays"])
    losses = []
    step = trainer.train_step

    def recording_step(state, batch, carry):
        loss, aux = step(state, batch, carry)
        losses.append(float(loss))
        return loss, aux

    trainer.train_step = recording_step
    trainer.fit(ds, max_epochs=EPOCHS)
    return trainer.encode_users(ds), trainer.encode_item_corpus(ds), np.asarray(losses)


def dssm_worker(rank, runs, root):
    meshes = {}
    out = {}
    for name, run in runs.items():
        lay = run["layout"]
        mesh = meshes.get(lay) or meshes.setdefault(lay, Mesh(*lay))
        out[name] = fit_dssm(run, mesh, os.path.join(root, name))
    return out


def one_process(run, workdir):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fit_dssm(run, None, workdir)
    finally:
        torch.set_num_threads(threads)


def jax_dssm(raw, layout, arrays, workdir):
    """(initial weights for the port, user encodings, item encodings) of JAX's
    ``DSSMTrainer`` on ``make_mesh(*layout)`` over the first devices."""
    import jax

    from news_recsys_tpu.config import config_from_dict as jconfig_from_dict
    from news_recsys_tpu.data.packed_dataset import PackedDataset as JPackedDataset
    from news_recsys_tpu.models import dssm as jdssm
    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training import retrieval as jretrieval
    from news_recsys_tpu_torch.convert import params_from_flax
    from tests.test_torch_models import jax_init

    jcfg = jconfig_from_dict(raw)
    ds = JPackedDataset(arrays)
    jmodel = jdssm.build_dssm(jcfg)
    params = jax_init(jmodel, ds.take(np.arange(BATCH)), seed=raw["train_hparams"]["seed"])
    cfg = config_from_dict(raw)
    weights = params_from_flax(params, build_dssm(cfg, device="cpu")).state_dict()
    mesh = make_mesh(*layout, devices=jax.devices()[:layout[0] * layout[1]])
    jt = jretrieval.DSSMTrainer(jcfg, jmodel, workdir=workdir, mesh=mesh)
    state = jt.fit(ds, max_epochs=EPOCHS)
    return ({k: v.clone() for k, v in weights.items()},
            np.asarray(jt.encode_users(state.params, ds)),
            np.asarray(jt.encode_item_corpus(state.params, ds)))


def make_run(optimizer, layout, root, seed):
    from tests.test_torch_retrieval import KEY_SEED, dssm_arrays, dssm_raw, jax_perms

    raw = dssm_raw(optimizer, large=optimizer != "adamw", batch_size=BATCH)
    arrays = dssm_arrays(raw, STEPS * BATCH, seed)
    perms = np.stack([jax_perms(s, BATCH, raw["dssm_cfg"]["negative_sample_rate"], KEY_SEED)
                      for s in range(EPOCHS * STEPS)]).astype(np.int32)
    weights, ju, ji = jax_dssm(raw, layout, arrays, os.path.join(root, f"jax_{optimizer}"))
    run = dict(raw=raw, layout=layout, arrays=arrays, perms=perms, weights=weights)
    return run, (ju, ji)


@pytest.fixture(scope="module")
def dssm_runs(tmp_path_factory):
    """Every run on its ranks (2 ranks: DP 2 ``adamw`` and (1, 2) ``adamw``;
    4 ranks: (2, 2) ``rowwise_adagrad``), one process and JAX."""
    os.environ["NRT_PALLAS"] = ""                 # JAX's XLA routes
    root = str(tmp_path_factory.mktemp("dssm"))
    dp, jax_dp = make_run("adamw", (2, 1), root, seed=3)
    mp, jax_mp = make_run("rowwise_adagrad", (2, 2), root, seed=4)
    runs2 = {"dp2": dp, "model2": dict(dp, layout=(1, 2))}
    runs4 = {"dp2_mp2": mp}
    got = {}
    for world, runs in ((2, runs2), (4, runs4)):
        out = spawn_ranks(dssm_worker, world, (runs, os.path.join(root, f"ranks{world}")),
                          init_method=f"file://{root}/store{world}", threads=1, timeout=300)
        for name in runs:
            for r in range(1, world):
                for a, b in zip(out[r][name], out[0][name]):
                    np.testing.assert_array_equal(a, b)      # every rank: the gathered rows
            got[name] = out[0][name]
    refs = {name: one_process(run, os.path.join(root, "ref", name))
            for name, run in {**runs2, **runs4}.items()}
    return got, refs, {"dp2": jax_dp, "dp2_mp2": jax_mp}


@pytest.mark.parametrize("name", ["dp2", "dp2_mp2"])
def test_dssm_mesh_matches_jax(dssm_runs, name):
    got, refs, jax_enc = dssm_runs
    for have, want, ref in zip(got[name][:2], jax_enc[name], refs[name][:2]):
        assert have.shape == want.shape and np.isfinite(have).all()
        np.testing.assert_allclose(have, want, atol=ENC_ATOL)
        np.testing.assert_allclose(have, ref, atol=ENC_ATOL)


def test_dssm_model_parallel_equals_one_process(dssm_runs):
    """(data 1, model 2), the all-dense step: ``hist`` pooled by the pool
    kernel's plain version over the compact table of exchanged rows, the
    tables' gradients on their shards; the encodings bit for bit one
    process's."""
    got, refs, _ = dssm_runs
    for have, want in zip(got["model2"], refs["model2"]):
        np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("name", ["dp2", "dp2_mp2"])
def test_dssm_step_losses_are_the_global_batchs(dssm_runs, name):
    """Every step's loss on the ranks is one process's: the mean over the
    global batch, each user against negatives drawn from every rank's items.
    Negatives drawn within a rank's own half would change it at the first
    step by far more than this tolerance."""
    got, refs, _ = dssm_runs
    assert got[name][2].shape == (EPOCHS * STEPS,)
    np.testing.assert_allclose(got[name][2], refs[name][2], rtol=1e-5)
    np.testing.assert_array_equal(got["model2"][2], refs["model2"][2])


def test_dssm_cli_on_two_processes_equals_one(tmp_path):
    """``train`` of ``configs/dssm.yaml`` (cut to synthetic data as
    ``tests/test_torch_cli_dssm.py`` cuts it; all-dense AdamW, ``hist``
    pooled on the compact table of exchanged rows) on two processes over TCP
    with the tables sharded (``mesh.model`` 2), against one process, one
    thread each: the epoch's loss, the ``Retrieval:`` block and
    ``retrieval_eval.json`` equal, the epoch checkpoint's weights bit for bit
    (gathered by process 0), and the serving bundle written from the whole
    tables."""
    import sys

    import yaml

    from news_recsys_tpu_torch.cli import main as cli
    from news_recsys_tpu_torch.training.checkpoint import load_state
    from tests.test_torch_cli_dssm import write_dssm_config
    from tests.test_torch_parallel_cli import free_port, losses, run

    cfg = write_dssm_config(tmp_path / "dssm.yaml", tmp_path)
    raw = yaml.safe_load(open(cfg))
    raw["mesh"] = {"data": -1, "model": 2}
    (tmp_path / "dssm.yaml").write_text(yaml.safe_dump(raw))
    cli(["synth", "--out", str(tmp_path / "Data"), "--news", "150", "--users", "60",
         "--train-impressions", "300", "--dev-impressions", "80"])
    cli(["preprocess", "-c", cfg])
    cli(["fe", "-c", cfg])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "news_recsys_tpu_torch", "train", "-c", cfg, "--device",
            "cpu", "--epochs", "1", "--workdir"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    run([base + [one]], env=env)
    port = free_port()
    run([base + [two, "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(i)] for i in range(2)], env=env)
    assert losses(one) == losses(two) and len(losses(two)) == 1
    for name in ("val_log.log", "retrieval_eval.json"):
        assert open(os.path.join(one, name)).read() == open(os.path.join(two, name)).read()
    a, b = (load_state(os.path.join(d, "ckpts", "epoch_000.pt")) for d in (one, two))
    assert a["kind"] == b["kind"] == "weights" and set(a["model"]) == set(b["model"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert sorted(os.listdir(os.path.join(two, "bundle"))) == \
        sorted(os.listdir(os.path.join(one, "bundle")))
