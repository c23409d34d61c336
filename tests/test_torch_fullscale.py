"""The port's full-scale quality campaign scripts on the CPU, at a tiny
synthetic scale, against the JAX package's:

- ``scripts/fullscale_rankers_torch.py::model_config_dict`` equals the YAML
  that ``scripts/fullscale_rankers.py::run_model`` writes, for every row of
  the campaign and every variant token, and agrees with the zoo's recipes;
- ``--prepare``'s ``base.yaml`` equals what ``scripts/mind_parity.py``
  writes and tightens on the same synthetic files;
- the script end to end (three models in parallel, two epochs, on the CPU):
  its artifact has the JAX artifact's keys, its best epochs are the JAX
  ``log_analysis.best_epoch`` of the same logs;
- ``scripts/cascade_eval_torch.py`` on that run's checkpoints: finite HR@10,
  and the query histories of ``scripts/cascade_eval.py``'s pandas reading;
- neither script imports JAX, flax, pandas or the JAX package.
"""

import ast
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from news_recsys_tpu_torch.config import config_from_dict, config_to_dict, load_config
from news_recsys_tpu_torch.zoo import mind_dssm_config, mind_ranker_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "--news 400 --users 300 --train-impressions 600 --dev-impressions 200 --seed 3"
CAMPAIGN = ("lr", "fm", "deepfm", "dcn@v2", "deep", "widedeep", "dcn", "attention",
            "dssm@aug+logq+ns8")
# every variant token of the recipe, alone and combined
VARIANTS = ("lr@adamw", "fm@adamw", "dssm@aug", "dssm@logq", "dssm@aug+logq",
            "dssm@aug+logq+temp0.05", "dssm@aug+adamw", "dssm@ns4", "dcn@bf16",
            "dcn@b8192", "dcn@b8192+bf16", "attention@b2048", "dcn@rneg4",
            "attention@rneg4", "fm@is0.1", "lr@is1.0", "deep@v2", "widedeep@adamw")
RUN_MODELS = ("lr", "dcn", "dssm@aug+logq+ns8")
RUN_EPOCHS = 2
FORBIDDEN = ("jax", "flax", "optax", "orbax", "pandas", "news_recsys_tpu")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fullscale():
    return load_script("fullscale_rankers_torch")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory, fullscale):
    """A tiny ``--prepare`` workdir; returns (workdir, base.yaml)."""
    workdir = str(tmp_path_factory.mktemp("fullscale"))
    fullscale.main(["--prepare", "--workdir", workdir, "--synth-args", TINY, "--models", ""])
    return workdir, os.path.join(workdir, "base.yaml")


def jax_model_yaml(name, base, tmp_path, monkeypatch, optimizer="auto", chunk_steps=0):
    """The config ``scripts/fullscale_rankers.py::run_model`` writes for
    ``name``; its training process is not started."""
    script = load_script("fullscale_rankers")

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(script.subprocess, "run", stop)
    with pytest.raises(Stop):
        script.run_model(name, base, 1, str(tmp_path), optimizer, chunk_steps=chunk_steps)
    tag = name.replace("@", "_")
    with open(tmp_path / f"{tag}.yaml") as f:
        return yaml.safe_load(f)


def round_trip(raw: dict) -> dict:
    return yaml.safe_load(yaml.safe_dump(raw))


# -- (a) the recipe -----------------------------------------------------------------


@pytest.mark.parametrize("name", CAMPAIGN + VARIANTS)
def test_model_config_is_the_jax_scripts(name, prepared, fullscale, tmp_path, monkeypatch):
    _, base = prepared
    want = jax_model_yaml(name, base, tmp_path, monkeypatch)
    base_raw = config_to_dict(load_config(base))
    got = fullscale.model_config_dict(base_raw, name)
    assert round_trip(got) == want
    assert base_raw == config_to_dict(load_config(base))           # left as it was
    assert fullscale.model_tag(name) == name.replace("@", "_")


@pytest.mark.parametrize("optimizer,chunk_steps", [("adamw", 0), ("sparse_adamw", 64)])
@pytest.mark.parametrize("name", ["dcn", "dssm@aug+logq+ns8", "lr@adamw"])
def test_model_config_takes_the_optimizer_and_chunks(name, optimizer, chunk_steps, prepared,
                                                      fullscale, tmp_path, monkeypatch):
    _, base = prepared
    want = jax_model_yaml(name, base, tmp_path, monkeypatch, optimizer, chunk_steps)
    got = fullscale.model_config_dict(config_to_dict(load_config(base)), name, optimizer,
                                      chunk_steps)
    assert round_trip(got) == want


def test_unknown_variant_token_is_refused_as_jax_refuses_it(prepared, fullscale, tmp_path,
                                                            monkeypatch):
    _, base = prepared
    script = load_script("fullscale_rankers")
    with pytest.raises(ValueError, match="Unknown variant token 'x9'"):
        script.run_model("dcn@v2+x9", base, 1, str(tmp_path), "auto")
    with pytest.raises(ValueError, match="Unknown variant token 'x9'"):
        fullscale.model_config_dict(config_to_dict(load_config(base)), "dcn@v2+x9")


@pytest.mark.parametrize("name", [n for n in CAMPAIGN if not n.startswith("dssm")])
def test_recipe_agrees_with_the_zoo(name, fullscale):
    """From the model's shipped config, the recipe gives
    ``zoo.mind_ranker_config(name)`` section for section."""
    model = name.split("@")[0]
    raw = config_to_dict(load_config(os.path.join(REPO, "configs", f"{model}.yaml")))
    got = config_to_dict(config_from_dict(fullscale.model_config_dict(raw, name)))
    want = config_to_dict(mind_ranker_config(name))
    assert sorted(got) == sorted(want)
    for section in want:
        assert got[section] == want[section], section


def test_dssm_recipe_agrees_with_the_zoo_but_for_its_schedule(fullscale):
    """``configs/dssm.yaml`` (``zoo.mind_dssm_config``) through the
    campaign's DSSM recipe: the same model, the same ``dssm_cfg``; only the
    training differs: the reference's retrieval schedule (3e-3 to 1e-4 over
    steps 10k and 60k, against the file's 1e-3) and the campaign's
    ``rowwise_adagrad`` on the large tables (the file's all-dense AdamW)."""
    raw = config_to_dict(mind_dssm_config())
    got = config_to_dict(config_from_dict(
        fullscale.model_config_dict(raw, "dssm@aug+logq+ns8")))
    for section in raw:
        if section != "train_hparams":
            assert got[section] == raw[section], section
    changed = {k for k in raw["train_hparams"]
               if got["train_hparams"][k] != raw["train_hparams"][k]}
    assert changed == {"lr", "min_lr", "lr_milestones", "embedding_optimizer"}
    hp = got["train_hparams"]
    assert (hp["lr"], hp["min_lr"], hp["lr_milestones"], hp["embedding_optimizer"]) == (
        3e-3, 1e-4, [10000, 60000], "rowwise_adagrad")


def test_model_epochs_follow_the_flags(fullscale):
    args = fullscale.build_parser().parse_args(
        ["--config", "x", "--epochs", "6", "--shallow-epochs", "16", "--dssm-epochs", "40",
         "--model-epochs", "dcn@v2=16,deep=3"])
    got = {n: fullscale.model_epochs(n, args) for n in CAMPAIGN}
    assert got == {"lr": 16, "fm": 16, "deepfm": 16, "dcn@v2": 16, "deep": 3,
                   "widedeep": 6, "dcn": 6, "attention": 6, "dssm@aug+logq+ns8": 40}


# -- (b) the data and the base config -------------------------------------------------


def test_prepare_writes_mind_paritys_base_config(prepared, tmp_path, monkeypatch):
    """``scripts/mind_parity.py --synth`` (the JAX package's synth,
    preprocess and fe) stopped before its first model: its tightened
    ``base.yaml`` and its boot config are ``--prepare``'s, but for the
    work directory in the paths."""
    workdir, base = prepared
    parity = load_script("mind_parity")

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(parity, "model_config", stop)
    monkeypatch.setattr(sys, "argv", ["mind_parity.py", "--workdir", str(tmp_path), "--synth",
                                      "--synth-args", TINY, "--models", "deep",
                                      "--out", str(tmp_path / "out.json")])
    with pytest.raises(Stop):
        parity.main()
    for fname in ("base.yaml", "boot.yaml"):
        with open(tmp_path / fname) as f:
            want = yaml.safe_load(f.read().replace(str(tmp_path), "<workdir>"))
        with open(os.path.join(workdir, fname)) as f:
            got = yaml.safe_load(f.read().replace(workdir, "<workdir>"))
        assert got == want, fname
    with open(os.path.join(workdir, "prepare.json")) as f:
        assert json.load(f)["synth"] == TINY


# -- (c) the runs ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def campaign(prepared, fullscale, tmp_path_factory):
    """Three models, two epochs each, three at once, on the CPU; returns
    (workdir, artifact path, val-log dir, artifact)."""
    workdir, base = prepared
    out_dir = tmp_path_factory.mktemp("campaign_out")
    out, logs = str(out_dir / "rankers.json"), str(out_dir / "logs")
    artifact = fullscale.main(["--config", base, "--workdir", workdir, "--models",
                               ",".join(RUN_MODELS), "--epochs", str(RUN_EPOCHS), "--device",
                               "cpu", "--jobs", "3", "--seed", "7", "--out", out,
                               "--val-logs", logs])
    return workdir, out, logs, artifact


def test_campaign_artifact_has_the_jax_artifacts_keys(campaign):
    workdir, out, logs, artifact = campaign
    with open(out) as f:
        assert json.load(f) == artifact
    with open(os.path.join(REPO, "artifacts", "rankers_fullscale_r05.json")) as f:
        ref = json.load(f)
    assert set(artifact) >= (set(ref) - {"backend", "notes"}) | {"device", "jobs", "seed"}
    assert artifact["device"]["name"] == "cpu" and artifact["jobs"] == 3
    assert artifact["seed"] == 7
    assert "not a throughput figure" in artifact["examples_per_sec_last"]
    ref_keys = {k for r in ref["results"] for k in r} - {"carried_from", "reused_existing_run"}
    assert [r["model"] for r in artifact["results"]] == [
        n.replace("@", "_") for n in RUN_MODELS]
    for res in artifact["results"]:
        want = ref_keys - ({"final_retrieval_eval"} if "Retrieval" not in res["best"] else set())
        assert set(res) == want | {"seed"}, res["model"]
        assert res["epochs"] == RUN_EPOCHS and res["seed"] == 7
        with open(os.path.join(workdir, f"{res['model']}.yaml")) as f:
            assert yaml.safe_load(f)["train_hparams"]["seed"] == 7
        for cohort in res["best"].values():
            assert all(math.isfinite(v) for v in cohort.values()), res["model"]


def test_campaign_best_epochs_are_jax_log_analysis(campaign):
    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log

    _, _, logs, artifact = campaign
    for res in artifact["results"]:
        path = os.path.join(logs, f"{res['model']}_val_log.log")
        epochs = parse_log(path)
        assert len(epochs) == RUN_EPOCHS
        best = best_epoch(epochs)
        assert res["best_epoch"] == best["epoch"]
        assert res["best"] == {coh.replace(" Users", "").replace(" ", "_"):
                               {k: round(v, 5) for k, v in vals.items()}
                               for coh, vals in best["data"].items()}
    dssm = artifact["results"][-1]
    assert dssm["final_retrieval_eval"]["num_queries"] == dssm["best"]["Retrieval"]["Queries"]


def test_campaign_reuses_finished_runs(campaign, fullscale, monkeypatch, tmp_path):
    """``FULLSCALE_REUSE=1`` keeps a run whose log holds the epochs asked
    for, and trains none again."""
    workdir, _, _, artifact = campaign
    monkeypatch.setenv("FULLSCALE_REUSE", "1")

    def refuse(*args, **kwargs):
        raise AssertionError("a finished run was trained again")

    monkeypatch.setattr(fullscale.subprocess, "run", refuse)
    again = fullscale.main(["--config", os.path.join(workdir, "base.yaml"), "--workdir",
                            workdir, "--models", "lr", "--epochs", str(RUN_EPOCHS),
                            "--device", "cpu", "--seed", "7", "--out",
                            str(tmp_path / "a.json"), "--val-logs", str(tmp_path / "l")])
    (res,) = again["results"]
    assert res["reused_existing_run"] and res["best"] == artifact["results"][0]["best"]


# -- (d) the cascade ------------------------------------------------------------------


def pandas_histories(cfg_path: str):
    """``scripts/cascade_eval.py``'s reading of the dev positives' histories."""
    import pandas as pd

    from news_recsys_tpu.config import load_config as jload_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset as JPacked

    rc_cfg = jload_config(cfg_path)
    dev = JPacked.open_split(rc_cfg, "dev")
    pos = dev.arrays["label"][:, 0] == 1
    cols = ["impression_id", "user_id", "time", "history", "item_id", "label"]
    df = pd.read_csv(os.path.join(rc_cfg.paths.out_basedir, "preprocess",
                                  "dev_behaviors_processed.csv"),
                     sep="\t", names=cols, quoting=3)
    hists = df["history"].fillna("").astype(str).apply(
        lambda s: [int(x) for x in s.split(" ")] if s else [])
    return [h for h, m in zip(hists, pos) if m], dev.arrays["item_id"][pos]


def cascade_argv(workdir, out, *extra):
    dssm = os.path.join(workdir, "exp_dssm_aug+logq+ns8")
    return ["--recall-cfg", os.path.join(workdir, "dssm_aug+logq+ns8.yaml"),
            "--recall-ckpt", os.path.join(dssm, "ckpts", f"epoch_{RUN_EPOCHS - 1:03d}.pt"),
            "--ranker-cfg", os.path.join(workdir, "dcn.yaml"),
            "--ranker-ckpt", os.path.join(workdir, "exp_dcn"), "--device", "cpu",
            "--out", out, *extra]


@pytest.mark.parametrize("max_queries", [0, 40])
def test_cascade_eval_on_the_campaigns_checkpoints(campaign, tmp_path, max_queries):
    workdir, _, _, artifact = campaign
    cascade = load_script("cascade_eval_torch")
    out = str(tmp_path / "cascade.json")
    res = cascade.main(cascade_argv(workdir, out, "--chunk", "32",
                                    "--max-queries", str(max_queries)))
    with open(out) as f:
        assert json.load(f) == res
    want_hist, want_targets = pandas_histories(os.path.join(workdir, "dssm_aug+logq+ns8.yaml"))
    assert res["queries"] == (max_queries or len(want_hist))
    for key in ("HR@10_recall_only", "HR@10_cascade", "lift"):
        assert math.isfinite(res[key]) and res[key] >= 0, key
    assert res["HR@10_recall_only"] <= 1 and res["HR@10_cascade"] <= 1
    assert res["device"]["name"] == "cpu" and (res["fetch"], res["k"]) == (100, 10)
    if not max_queries:       # the run's own final retrieval eval: the same recall
        dssm = artifact["results"][-1]
        assert res["HR@10_recall_only"] == round(dssm["final_retrieval_eval"]["HR@10"], 5)


def test_cascade_queries_are_cascade_evals(campaign):
    """The dev positives' histories and targets equal ``scripts/cascade_eval.py``'s
    pandas reading of the same ``dev_behaviors_processed.csv``, and the
    ``--max-queries`` draw picks the same rows."""
    workdir = campaign[0]
    cascade = load_script("cascade_eval_torch")
    cfg_path = os.path.join(workdir, "dssm_aug+logq+ns8.yaml")
    want_hist, want_targets = pandas_histories(cfg_path)
    assert any(want_hist) and not all(want_hist)           # empty histories too
    _, targets, histories = cascade.dev_queries(load_config(cfg_path))
    assert histories == want_hist
    np.testing.assert_array_equal(targets, want_targets)
    _, targets, histories = cascade.dev_queries(load_config(cfg_path), max_queries=40)
    keep = np.random.default_rng(0).choice(len(want_hist), 40, replace=False)
    assert histories == [want_hist[i] for i in keep]
    np.testing.assert_array_equal(targets, want_targets[keep])


# -- (e) imports ----------------------------------------------------------------------


def test_scripts_import_no_jax(campaign, tmp_path):
    """In a fresh process, both scripts load and run (a ``--prepare`` and
    a cascade evaluation on the CPU), and no JAX, flax, pandas or JAX
    package module is loaded."""
    workdir = campaign[0]
    code = f"""
import importlib.util, json, sys
def load(name):
    spec = importlib.util.spec_from_file_location(name, {REPO!r} + f"/scripts/{{name}}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m
load("fullscale_rankers_torch").main(["--prepare", "--workdir", {str(tmp_path / "w")!r},
                                      "--synth-args", {TINY!r}, "--models", ""])
load("cascade_eval_torch").main({cascade_argv(workdir, str(tmp_path / "c.json"))!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("BAD=" + json.dumps(bad))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("BAD=")][-1]
    assert json.loads(line[4:]) == []
    for name in ("fullscale_rankers_torch", "cascade_eval_torch",
                 "quality_table_torch"):                            # nor names one
        with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m and m.split(".")[0] in FORBIDDEN], name


def test_scripts_refuse_a_missing_card(campaign, fullscale, tmp_path):
    """``--device cuda`` where no card is visible (as on this CPU) is an
    error before anything runs, never a CPU run."""
    workdir = campaign[0]
    cascade = load_script("cascade_eval_torch")
    out = str(tmp_path / "c.json")
    with pytest.raises((SystemExit, OSError, subprocess.CalledProcessError)):
        cascade.main(cascade_argv(workdir, out)[:-4] + ["--device", "cuda", "--out", out])
    with pytest.raises((SystemExit, OSError, subprocess.CalledProcessError)):
        fullscale.main(["--config", os.path.join(workdir, "base.yaml"), "--workdir",
                        str(tmp_path / "w"), "--models", "lr", "--epochs", "1",
                        "--out", out, "--val-logs", str(tmp_path / "l")])
    assert not os.path.exists(out) and not os.path.exists(tmp_path / "w")


def test_quality_table_of_the_committed_campaign():
    """``scripts/quality_table_torch.py`` over the campaign's committed
    artifacts (two seeds on the card): every row and both cascades inside
    the tolerance set before the run, each value the artifact's own."""
    art = os.path.join(REPO, "artifacts")
    table = load_script("quality_table_torch").main(
        ["--runs", f"{art}/rankers_fullscale_torch_r16.json",
         f"{art}/rankers_fullscale_torch_r16_seed7.json",
         "--logs", f"{art}/fullscale_torch_r16/seed42", f"{art}/fullscale_torch_r16/seed7",
         "--cascade", f"{art}/cascade_eval_torch_r16.json",
         f"{art}/cascade_eval_torch_r16_seed7.json"])
    assert sorted(table) == sorted([n.replace("@", "_") for n in CAMPAIGN] + [
        "cascade_eval_torch_r16.json", "cascade_eval_torch_r16_seed7.json"])
    assert all(all(np.atleast_1d(row["inside"])) for row in table.values())
    with open(f"{art}/rankers_fullscale_torch_r16.json") as f:
        run = json.load(f)
    assert run["device"]["name"].startswith("NVIDIA") and run["seed"] == 42
    for res in run["results"]:
        best = res["best"]
        want = best["Warm_Start"]["AUC"] if "Warm_Start" in best else best["Retrieval"]["HR@10"]
        assert table[res["model"]]["values"][0] == want
