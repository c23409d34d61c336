"""The port's MIND parity harness and popularity baseline on the CPU, at a
tiny synthetic scale, against the JAX package's scripts:

- ``per_user_ranking_metrics`` equals ``scripts/mind_parity.py``'s within
  1e-9 on seeded data (users with no positive, with one row, tied scores)
  and the port's metric engine's Overall block;
- ``model_config`` and ``checksum_manifest`` equal the JAX script's on the
  same files, and a refused download ends both with exit code 2 and the
  same message;
- the scoring half: both harnesses end to end on the same synthetic files,
  the training processes replaced by one set of seeded JAX parameters (the
  JAX trainer's checkpoint, and the port's through ``convert.py``): the
  port's ``Trainer.predict`` equals JAX's within 1e-5 for deep, DCN and the
  attention ranker, and the table within 1e-6;
- a real tiny run of the port's harness on a copy of the files
  (``--data``): its artifact has the JAX artifact's keys, the manifest and
  ``base.yaml`` of the ``--synth`` run, and each row equals the best
  epoch's Overall block of its own val log within 1e-4 (the log prints
  four decimals);
- ``scripts/popularity_baseline_torch.py`` equals
  ``scripts/popularity_baseline.py`` exactly, on files whose click counts
  tie (pandas' order of equal counts restated);
- neither script imports JAX, flax, pandas or the JAX package, and both
  refuse a missing card.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import yaml

from tests.test_torch_fullscale import FORBIDDEN, REPO, TINY, load_script

MODELS = ("deep", "dcn", "attention")
EPOCHS = 2
SCORE_TOL = 1e-5
TABLE_TOL = 1e-6
METRIC_TOL = 1e-9
LOG_TOL = 1e-4


@pytest.fixture(scope="module")
def parity():
    return load_script("mind_parity_torch")


@pytest.fixture(scope="module")
def jparity():
    return load_script("mind_parity")


def metric_case(seed: int) -> tuple:
    """Users with 1 to 40 rows; scores on a grid of 20 values, so that many
    tie; a fifth of the users have no positive, and some users' only
    positives lie below the top 10."""
    rng = np.random.default_rng(seed)
    n_users = 300
    rows = rng.integers(1, 41, n_users)
    uids = np.repeat(rng.permutation(10_000)[:n_users], rows).astype(np.int64)
    order = rng.permutation(len(uids))                   # users' rows interleaved
    uids = uids[order]
    scores = (rng.integers(0, 20, len(uids)) / 20).astype(np.float32)
    labels = (rng.random(len(uids)) < 0.15).astype(np.float32)
    no_pos = np.isin(uids, rng.choice(np.unique(uids), n_users // 5, replace=False))
    labels[no_pos] = 0.0
    return uids, scores, labels


@pytest.mark.parametrize("seed", range(4))
def test_per_user_metrics_equal_the_jax_scripts(parity, jparity, seed):
    uids, scores, labels = metric_case(seed)
    counts = np.unique(uids, return_counts=True)[1]
    assert (counts == 1).any() and len(np.unique(scores)) <= 20
    got = parity.per_user_ranking_metrics(uids, scores, labels)
    want = jparity.per_user_ranking_metrics(uids, scores, labels)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=METRIC_TOL, err_msg=key)


def test_per_user_metrics_hand_computed(parity, jparity):
    """``tests/test_mind_parity.py``'s case: user 1's positive at rank 2,
    user 2's at rank 1, user 3 without one."""
    uids = np.array([1, 1, 1, 2, 2, 3, 3], np.int64)
    scores = np.array([.9, .8, .7, .6, .5, .4, .3], np.float32)
    labels = np.array([0, 1, 0, 1, 0, 0, 0], np.float32)
    got = parity.per_user_ranking_metrics(uids, scores, labels)
    ndcg_u1 = (1 / np.log2(3)) / (1 / np.log2(2))
    np.testing.assert_allclose(got["MRR"], (0.5 + 1.0 + 0.0) / 3, atol=1e-12)
    np.testing.assert_allclose(got["nDCG@5"], (ndcg_u1 + 1.0 + 0.0) / 3, atol=1e-12)
    assert got["nDCG@10"] == got["nDCG@5"]
    want = jparity.per_user_ranking_metrics(uids, scores, labels)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=METRIC_TOL)


def test_mrr_counts_a_first_positive_only_within_ten(parity):
    uids = np.zeros(12, np.int64)
    scores = np.linspace(1, 0, 12).astype(np.float32)
    labels = np.zeros(12, np.float32)
    labels[10] = 1.0                                    # rank 11
    got = parity.per_user_ranking_metrics(uids, scores, labels)
    assert got["MRR"] == got["nDCG@10"] == got["nDCG@5"] == 0.0
    labels[9] = 1.0                                     # rank 10
    assert parity.per_user_ranking_metrics(uids, scores, labels)["MRR"] == 0.1


@pytest.mark.parametrize("seed", range(2))
def test_per_user_metrics_equal_the_metric_engine(parity, seed):
    from news_recsys_tpu_torch.training.metrics import compute_user_metrics

    uids, scores, labels = metric_case(seed)
    got = parity.per_user_ranking_metrics(uids, scores, labels)
    want = compute_user_metrics(uids, scores, labels, None)["Overall"]
    for ours, theirs in (("AUC", "AUC"), ("MRR", "MRR@10"), ("nDCG@10", "NDCG@10")):
        np.testing.assert_allclose(got[ours], want[theirs], rtol=0, atol=METRIC_TOL)


# -- both harnesses on the same files, training replaced by seeded JAX parameters ------


def val_log_text(epochs: int) -> str:
    """A val log whose last epoch has the best Warm-Start AUC."""
    from news_recsys_tpu_torch.training.metrics import format_validation_block

    blocks = []
    for e in range(epochs):
        cohort = {"AUC": 0.5 + 0.01 * e, "LogLoss": 0.4, "GAUC": 0.5, "NDCG@10": 0.2,
                  "HR@10": 0.4, "MRR@10": 0.1 + 0.01 * e}
        blocks.append(format_validation_block(
            {"Overall": cohort, "Warm_Start": {**cohort, "User_Count": 7},
             "Cold_Start": {**cohort, "User_Count": 3}}, e))
    return "".join(blocks)


def jax_checkpoint(cfg_path: str, name: str, exp_dir: str) -> str:
    """The JAX trainer's state of ``name`` from the config's seed, as its
    ``epoch_<last>.msgpack``."""
    from news_recsys_tpu.config import load_config as jload_config
    from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
    from news_recsys_tpu.training.trainer import Trainer as JTrainer

    export = load_script("export_torch_checkpoint")
    jcfg = jload_config(cfg_path)
    jt = JTrainer(jcfg, jbuild_ranker(jcfg, name), workdir=exp_dir, use_mesh=False)
    return jt.save_checkpoint(jt.init_state(export.sample_batch(jcfg)), EPOCHS - 1)


def run_harness(main, argv: list, module, fake_train) -> tuple:
    """``main`` with its training processes replaced by ``fake_train(argv)``
    and every call of ``per_user_ranking_metrics`` recorded."""
    real_run = subprocess.run
    calls = []
    metrics = module.per_user_ranking_metrics

    def run(cmd, *args, **kwargs):
        if "train" in cmd[3:4]:
            fake_train(cmd)
            return subprocess.CompletedProcess(cmd, 0, "", "")
        return real_run(cmd, *args, **kwargs)

    def recorded(uids, scores, labels):
        table = metrics(uids, scores, labels)
        calls.append((uids, scores, labels, table))
        return table

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(subprocess, "run", run)
        mp.setattr(module, "per_user_ranking_metrics", recorded)
        artifact = main(argv)
    return artifact, calls


def flag(cmd: list, name: str) -> str:
    """The value of ``name`` in a ``train`` command (after ``python -m <package>``)."""
    return cmd[cmd.index(name, 4) + 1]


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory, parity, jparity):
    """Both harnesses ``--synth`` at the tiny scale, each model's training
    replaced by the same seeded JAX parameters and a val log of two epochs;
    returns {"jax"|"port": (workdir, artifact, calls)}."""
    jwork = str(tmp_path_factory.mktemp("jax_harness"))
    pwork = str(tmp_path_factory.mktemp("port_harness"))
    common = ["--synth", "--synth-args", TINY, "--models", ",".join(MODELS),
              "--epochs", str(EPOCHS)]

    def jax_train(cmd):
        exp_dir = flag(cmd, "--workdir")
        os.makedirs(exp_dir)
        with open(os.path.join(exp_dir, "val_log.log"), "w") as f:
            f.write(val_log_text(EPOCHS))
        jax_checkpoint(flag(cmd, "-c"), flag(cmd, "-m"), exp_dir)

    def jax_main(argv):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["mind_parity.py", *argv])
            jparity.main()
        with open(argv[argv.index("--out") + 1]) as f:
            return json.load(f)

    def port_train(cmd):
        assert flag(cmd, "--device") == "cpu"
        name, exp_dir = flag(cmd, "-m"), flag(cmd, "--workdir")
        os.makedirs(exp_dir)
        shutil.copy(os.path.join(jwork, f"exp_{name}", "val_log.log"), exp_dir)
        export = load_script("export_torch_checkpoint")
        export.export(flag(cmd, "-c"), os.path.join(jwork, f"exp_{name}"),
                      os.path.join(exp_dir, "ckpts", f"epoch_{EPOCHS - 1:03d}.pt"), name)

    out = {"jax": (jwork, *run_harness(jax_main, [*common, "--workdir", jwork, "--out",
                                                  os.path.join(jwork, "out.json")],
                                       jparity, jax_train))}
    out["port"] = (pwork, *run_harness(parity.main, [*common, "--workdir", pwork, "--device",
                                                     "cpu", "--out",
                                                     os.path.join(pwork, "out.json")],
                                       parity, port_train))
    return out


@pytest.mark.parametrize("index,name", list(enumerate(MODELS)))
def test_scores_and_table_equal_jax_predict(harnesses, index, name):
    """The dev split scored from the same parameters: JAX's ``Trainer.predict``
    (its kernels through the JAX package's CPU route) and the port's."""
    juids, jscores, jlabels, jtable = harnesses["jax"][2][index]
    uids, scores, labels, table = harnesses["port"][2][index]
    np.testing.assert_array_equal(uids, juids)
    np.testing.assert_array_equal(labels, jlabels)
    assert scores.dtype == np.float32 and len(scores) == len(jscores) > 500
    assert np.std(scores) > 1e-3                        # the model tells rows apart
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=SCORE_TOL)
    for key in jtable:
        np.testing.assert_allclose(table[key], jtable[key], rtol=0, atol=TABLE_TOL, err_msg=key)


def test_artifact_has_the_jax_artifacts_keys(harnesses):
    _, jart, _ = harnesses["jax"]
    _, art, _ = harnesses["port"]
    assert set(art) >= set(jart) and {"device", "wall_seconds"} <= set(art)
    assert art["device"]["name"] == "cpu" and art["checksums"] == jart["checksums"]
    assert art["epochs"] == jart["epochs"] == EPOCHS
    assert [r["model"] for r in art["results"]] == [r["model"] for r in jart["results"]]
    for res, jres in zip(art["results"], jart["results"]):
        assert set(res) == set(jres) | {"val_log_overall"}
        assert (res["best_epoch"], res["warm_auc_best"]) == (jres["best_epoch"],
                                                              jres["warm_auc_best"])
        for key in ("AUC", "MRR", "nDCG@5", "nDCG@10"):
            assert abs(res[key] - jres[key]) <= 1e-5 + TABLE_TOL, (res["model"], key)
    assert art["table_markdown"].splitlines()[:2] == jart["table_markdown"].splitlines()[:2]


def yaml_of(path: str, workdir: str, data_dir: str = None) -> dict:
    with open(path) as f:
        text = f.read()
    if data_dir:
        text = text.replace(data_dir, "<data>")
    return yaml.safe_load(text.replace(workdir, "<workdir>"))


def test_configs_are_the_jax_scripts(harnesses, jparity, parity, tmp_path):
    """``boot.yaml``, the tightened ``base.yaml`` and each model's config."""
    jwork, pwork = harnesses["jax"][0], harnesses["port"][0]
    for fname in ("boot.yaml", "base.yaml", *(f"{n}.yaml" for n in MODELS)):
        assert yaml_of(os.path.join(pwork, fname), pwork) == \
            yaml_of(os.path.join(jwork, fname), jwork), fname
    base = os.path.join(pwork, "base.yaml")
    for name in (*MODELS, "fm"):
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "p").mkdir(exist_ok=True)
        want = jparity.model_config(base, str(tmp_path / "j"), name)
        got = parity.model_config(base, str(tmp_path / "p"), name)
        assert yaml_of(got, "") == yaml_of(want, ""), name


def test_manifest_is_the_jax_scripts(harnesses, jparity, parity):
    data = os.path.join(harnesses["port"][0], "Data", "MIND")
    got = parity.checksum_manifest(data)
    assert got == jparity.checksum_manifest(data) == harnesses["port"][1]["checksums"]
    assert sorted(got) == ["MINDsmall_dev/behaviors.tsv", "MINDsmall_dev/news.tsv",
                           "MINDsmall_train/behaviors.tsv", "MINDsmall_train/news.tsv"]


def test_synth_route_is_prepares_own(harnesses):
    """``--synth`` leaves the synthesis to ``fullscale_rankers_torch.prepare``,
    which records its arguments and time."""
    pwork, art, _ = harnesses["port"]
    with open(os.path.join(pwork, "prepare.json")) as f:
        prep = json.load(f)
    assert prep["synth"] == TINY
    assert {"synth", "preprocess", "fe"} <= set(prep["wall_seconds"])
    assert set(prep["wall_seconds"]) | {"checksums", "data_step"} <= set(art["wall_seconds"])


def test_default_workdir_is_a_new_temporary_dir(harnesses, parity, tmp_path, monkeypatch):
    """Without ``--workdir`` the run writes into a new directory under the
    temporary dir, so two runs never share one."""
    import tempfile

    assert parity.build_parser().parse_args([]).workdir is None
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    parity.main(["--data", os.path.join(harnesses["port"][0], "Data", "MIND"), "--models", "",
                 "--device", "cpu", "--out", str(tmp_path / "out.json")])
    made = [p for p in os.listdir(tmp_path) if p.startswith("mind_parity_torch_")]
    assert len(made) == 1 and os.path.exists(tmp_path / made[0] / "base.yaml")


def test_refused_download_exits_2_with_the_jax_scripts_message(parity, jparity, tmp_path,
                                                               monkeypatch, capsys):
    """Neither flag and no files: the fetch (patched to fail; nothing is
    downloaded) ends both harnesses with exit code 2 and the same words."""
    def refuse(url, path):
        raise OSError("the network refuses")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    said = {}
    for label, run in (("jax", lambda w: (monkeypatch.setattr(
                            sys, "argv", ["mind_parity.py", "--workdir", w]), jparity.main())),
                       ("port", lambda w: parity.main(["--workdir", w, "--device", "cpu"]))):
        work = str(tmp_path / label)
        with pytest.raises(SystemExit) as exc:
            run(work)
        assert exc.value.code == 2
        out, err = capsys.readouterr()
        said[label] = (out, err)
        assert not os.path.exists(os.path.join(work, "Data", "MIND", "MINDsmall_train"))
    assert said["port"] == said["jax"]
    assert "MIND download unavailable" in said["port"][1]


# -- a real tiny run on a copy of the files ---------------------------------------------


def tree_state(root: str) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


@pytest.fixture(scope="module")
def tiny_run(harnesses, parity, tmp_path_factory):
    """The port's harness with ``--data`` on a copy of the ``--synth`` run's
    raw files: three models trained at once on the CPU for two epochs."""
    root = tmp_path_factory.mktemp("data_route")
    data = str(root / "copy")
    shutil.copytree(os.path.join(harnesses["port"][0], "Data", "MIND"), data)
    before = tree_state(data)
    work, logs = str(root / "work"), str(root / "logs")
    art = parity.main(["--data", data, "--workdir", work, "--models", ",".join(MODELS),
                       "--epochs", str(EPOCHS), "--device", "cpu", "--jobs", "3",
                       "--out", str(root / "out.json"), "--val-logs", logs])
    return data, work, logs, art, before


def test_data_route_on_a_copy(tiny_run, harnesses):
    """The manifest and ``base.yaml`` of the ``--synth`` run; nothing is
    written into the given directory."""
    data, work, _, art, before = tiny_run
    pwork, part, _ = harnesses["port"]
    assert art["checksums"] == part["checksums"]
    assert art["data"] == "REAL MIND-small" and art["data_dir"] == data
    assert yaml_of(os.path.join(work, "base.yaml"), work, data) == \
        yaml_of(os.path.join(pwork, "base.yaml"), pwork, os.path.join(pwork, "Data", "MIND"))
    assert tree_state(data) == before
    assert not os.path.exists(os.path.join(work, "Data"))


def test_data_route_keeps_each_process_log(tiny_run):
    """Each training process's output is kept beside its run, and the data
    step records that nothing was synthesised."""
    _, work, _, _, _ = tiny_run
    with open(os.path.join(work, "prepare.json")) as f:
        assert json.load(f)["synth"] is None
    for name in MODELS:
        assert os.path.getsize(os.path.join(work, f"exp_{name}", "train_process.log")) > 0


def test_tiny_run_rows_are_their_val_logs(tiny_run, harnesses):
    """Each row: the best epoch of its val log (JAX's ``log_analysis``) and,
    within the log's four decimals, its Overall block."""
    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log

    _, _, logs, art, _ = tiny_run
    jart = harnesses["jax"][1]
    assert set(art) >= set(jart)
    assert [r["model"] for r in art["results"]] == list(MODELS)
    for res in art["results"]:
        assert set(res) >= set(jart["results"][0])
        best = best_epoch(parse_log(os.path.join(logs, f"{res['model']}_val_log.log")))
        assert res["best_epoch"] == best["epoch"]
        overall = best["data"]["Overall"]
        assert res["val_log_overall"] == overall
        for ours, theirs in (("AUC", "AUC"), ("nDCG@10", "NDCG@10"), ("MRR", "MRR@10")):
            assert abs(res[ours] - overall[theirs]) <= LOG_TOL, (res["model"], ours)
        assert 0.0 < res["nDCG@5"] <= 1.0
    assert f"| attention | {art['results'][2]['AUC']:.4f} |" in art["table_markdown"]


# -- the popularity baseline ----------------------------------------------------------------


def write_processed(pre: str, seed: int) -> None:
    """Processed train and dev files of 40 items whose click counts tie in
    many places; histories of zero to six items."""
    from news_recsys_tpu_torch.data.preprocess import write_tsv

    rng = np.random.default_rng(seed)
    os.makedirs(pre, exist_ok=True)
    for split, n in (("train", 400), ("dev", 160)):
        rows = []
        for i in range(n):
            hist = rng.choice(40, rng.integers(0, 7), replace=False)
            rows.append([f"I{i}", int(rng.integers(1, 50)), 1_570_000 + i,
                         " ".join(str(h) for h in hist) or None, int(rng.integers(0, 40)),
                         int(rng.random() < 0.3)])
        write_tsv(os.path.join(pre, f"{split}_behaviors_processed.csv"), rows)


def popularity_both(pre: str, out_dir, ks: str) -> tuple:
    jpop = load_script("popularity_baseline")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["popularity_baseline.py", "--pre", pre, "--out",
                                 str(out_dir / "j.json"), "--k", ks])
        jpop.main()
    with open(out_dir / "j.json") as f:
        want = json.load(f)
    got = load_script("popularity_baseline_torch").main(
        ["--pre", pre, "--out", str(out_dir / "p.json"), "--k", ks, "--device", "cpu"])
    return got, want


@pytest.mark.parametrize("seed", range(3))
def test_popularity_equals_the_jax_script_with_tied_counts(tmp_path, seed):
    import torch

    pre = str(tmp_path / "pre")
    write_processed(pre, seed)
    got, want = popularity_both(pre, tmp_path, "1,2,5,10")
    assert got.pop("device")["name"] == "cpu"
    assert got == want
    # the tie order decides the answer on these files: by item id it differs
    pop = load_script("popularity_baseline_torch")
    items, labels = pop.read_rows(os.path.join(pre, "train_behaviors_processed.csv"), False)
    counts = np.bincount(items[labels == 1], minlength=40)
    assert len(set(counts.tolist())) < 40
    by_id = torch.from_numpy(np.lexsort((np.arange(40), -counts))[: int((counts > 0).sum())])
    dev_items, dev_labels, hist = pop.read_rows(
        os.path.join(pre, "dev_behaviors_processed.csv"), True)
    pos = dev_labels == 1
    histories = [[int(x) for x in s.split()] for s, p in zip(hist, pos) if p]
    other = pop.hit_rates(by_id[:60], torch.from_numpy(dev_items[pos]), histories,
                          [1, 2, 5, 10], 40)
    assert other != {k: v for k, v in want.items() if k.startswith("HR@")}


def test_popularity_on_the_harness_files(harnesses, tmp_path):
    pre = os.path.join(harnesses["port"][0], "tmp", "preprocess")
    got, want = popularity_both(pre, tmp_path, "10,50")
    got.pop("device")
    assert got == want and want["queries"] > 50


# -- imports and the card ----------------------------------------------------------------------


def test_scripts_import_no_jax(harnesses, tmp_path):
    """In a fresh process both scripts run (the harness's data step on a copy
    of the files, the popularity baseline) and load no JAX, flax, pandas or
    JAX package module; neither names one."""
    pwork = harnesses["port"][0]
    data = str(tmp_path / "copy")
    shutil.copytree(os.path.join(pwork, "Data", "MIND"), data)
    code = f"""
import importlib.util, json, sys
def load(name):
    spec = importlib.util.spec_from_file_location(name, {REPO!r} + f"/scripts/{{name}}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m
load("mind_parity_torch").main(["--data", {data!r}, "--workdir", {str(tmp_path / "w")!r},
                                "--models", "", "--device", "cpu",
                                "--out", {str(tmp_path / "a.json")!r}])
load("popularity_baseline_torch").main(["--pre", {str(tmp_path / "w" / "tmp" / "preprocess")!r},
                                        "--out", {str(tmp_path / "p.json")!r},
                                        "--device", "cpu"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("BAD=" + json.dumps(bad))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("BAD=")][-1]
    assert json.loads(line[4:]) == []
    for name in ("mind_parity_torch", "popularity_baseline_torch"):
        with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m and m.split(".")[0] in FORBIDDEN], name


def test_scripts_refuse_a_missing_card(harnesses, parity, tmp_path):
    """The default ``--device cuda`` where no card is visible is an error
    before anything is written, never a CPU run."""
    pre = os.path.join(harnesses["port"][0], "tmp", "preprocess")
    out, work = str(tmp_path / "out.json"), str(tmp_path / "w")
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        parity.main(["--synth", "--synth-args", TINY, "--workdir", work, "--out", out])
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        load_script("popularity_baseline_torch").main(["--pre", pre, "--out", out])
    assert not os.path.exists(out) and not os.path.exists(work)


# -- the committed runs on the card --------------------------------------------------------

# the bands set before the reference-scale run: each model's Overall block
# at its best epoch in the reference's scoreboard artifact
AUC_BAND, RANK_BAND = 0.005, 0.003


def test_committed_synth_run_inside_its_bands():
    """``artifacts/mind_parity_torch_synth.json`` (``--synth`` at the
    reference's scale, on the card): each row within its band of
    ``artifacts/rankers_fullscale_r05.json``'s best Overall block, and equal
    to its own val log's best Overall block within the log's four decimals."""
    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log

    art_dir = os.path.join(REPO, "artifacts")
    with open(os.path.join(art_dir, "mind_parity_torch_synth.json")) as f:
        art = json.load(f)
    with open(os.path.join(art_dir, "rankers_fullscale_r05.json")) as f:
        ref = {r["model"]: r["best"]["Overall"] for r in json.load(f)["results"]
               if r["model"] in MODELS}
    assert ref["deep"]["AUC"] == 0.7788 and ref["dcn"]["NDCG@10"] == 0.3614
    assert art["device"]["name"].startswith("NVIDIA") and art["epochs"] == 8
    assert art["data"].startswith("synthetic stand-in") and "--seed 3" in art["data"]
    assert [r["model"] for r in art["results"]] == list(MODELS)
    for res in art["results"]:
        want = ref[res["model"]]
        assert abs(res["AUC"] - want["AUC"]) <= AUC_BAND + 1e-9, res["model"]
        assert abs(res["nDCG@10"] - want["NDCG@10"]) <= RANK_BAND + 1e-9, res["model"]
        assert abs(res["MRR"] - want["MRR@10"]) <= RANK_BAND + 1e-9, res["model"]
        assert 0 < res["nDCG@5"] < res["nDCG@10"]
        best = best_epoch(parse_log(os.path.join(art_dir, "mind_parity_torch",
                                                 f"{res['model']}_val_log.log")))
        assert best["epoch"] == res["best_epoch"] and best["data"]["Overall"] == \
            res["val_log_overall"]
        for ours, theirs in (("AUC", "AUC"), ("nDCG@10", "NDCG@10"), ("MRR", "MRR@10")):
            assert abs(res[ours] - best["data"]["Overall"][theirs]) <= LOG_TOL


def test_committed_popularity_is_the_reference_floor():
    with open(os.path.join(REPO, "artifacts", "popularity_baseline_torch.json")) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "artifacts", "popularity_baseline_r05.json")) as f:
        want = json.load(f)
    assert got.pop("device")["name"].startswith("NVIDIA")
    assert got == want
    assert (got["HR@10"], got["HR@50"], got["queries"]) == (0.00828, 0.02653, 35992)
