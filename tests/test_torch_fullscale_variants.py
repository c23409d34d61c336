"""The full-scale campaign's variant rows (the scoreboard's batch-8,192 and
bf16 rows, the AdamW columns, random corpus negatives and their cascades,
the DSSM ablations and ItemCF) on the CPU, against the reference's records
and the JAX package:

- each row's target and tolerance in ``scripts/quality_table_torch.py``
  equal the reference artifact's best value and the band set for it, and
  the reference's own val log, where it kept one, parses through the port's
  ``log_analysis`` to that value;
- a tiny campaign of the variant paths through the port's script (two
  epochs, five runs at once): the JAX artifact's keys, and best epochs that
  are the JAX ``log_analysis.best_epoch`` of the same logs;
- ``scripts/cascade_eval_torch.py`` ranked by the attention model on that
  campaign's checkpoints answers the first queries as the JAX package's
  ``CascadeRecommender`` does with the same weights;
- the quality table over the committed r17 artifacts: every row, cascade
  and the ItemCF baseline inside its band, on an NVIDIA card.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
TINY = "--news 400 --users 300 --train-impressions 600 --dev-impressions 200 --seed 3"
RUN_MODELS = ("dcn@rneg4", "fm@adamw", "dcn@b1024+bf16", "attention@rneg4",
              "dssm@aug+logq+adamw")
RUN_EPOCHS = 2
CASCADE_QUERIES = 48

# the variant rows: (tag, target, tolerance or None for the collapse band,
# the reference artifact that holds the target)
VARIANT_ROWS = (
    ("dcn_b8192", 0.7774, 0.005, "rankers_fullscale_r04.json"),
    ("dcn_b8192+bf16", 0.7781, 0.005, "rankers_fullscale_r05_bf16.json"),
    ("attention_b2048", 0.7795, 0.005, "rankers_fullscale_r04.json"),
    ("lr_adamw", 0.5663, 0.010, "rankers_fullscale_r05.json"),
    ("fm_adamw", 0.782, 0.005, "rankers_fullscale_r05.json"),
    ("dcn_rneg4", 0.7774, 0.005, "rankers_fullscale_r05_rneg.json"),
    ("attention_rneg4", 0.7779, 0.005, "rankers_fullscale_r05_rneg_att.json"),
    ("dssm_aug+logq+adamw", 0.019, 0.003, "rankers_fullscale_r05.json"),
    ("dssm_aug+logq+ns8", 0.0193, 0.003, "rankers_fullscale_r05_sweep.json"),
    ("dssm_aug+logq", 0.0189, 0.003, "rankers_fullscale_r05.json"),
    ("dssm_logq", 0.0164, 0.003, "rankers_fullscale_r05.json"),
    ("dssm_aug+logq+temp0.05", 0.0184, 0.003, "rankers_fullscale_r05.json"),
    ("dssm", 0.0014, None, "rankers_fullscale_r04.json"),
    ("dssm_adamw", 0.0013, None, "rankers_fullscale_r04.json"),
    ("dssm_aug", 0.0016, None, "rankers_fullscale_r05.json"),
    ("dssm_aug+adamw", 0.0012, None, "rankers_fullscale_r05.json"),
)
ABLATIONS = ("dssm_aug+logq", "dssm_logq", "dssm_aug+logq+temp0.05", "dssm", "dssm_adamw",
             "dssm_aug", "dssm_aug+adamw")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def table():
    return load_script("quality_table_torch")


def best_of(res: dict) -> float:
    best = res["best"]
    return best["Warm_Start"]["AUC"] if "Warm_Start" in best else best["Retrieval"]["HR@10"]


# -- (a) the targets ---------------------------------------------------------------


@pytest.mark.parametrize("tag,target,tol,source", VARIANT_ROWS, ids=[r[0] for r in VARIANT_ROWS])
def test_row_target_is_the_reference_artifacts(tag, target, tol, source, table):
    from news_recsys_tpu_torch.utils.log_analysis import best_epoch, parse_log

    row = next(r for r in table.TARGETS if r.tag == tag)
    assert (row.target, row.tol, row.source) == (target, tol, source)
    assert row.rule == ("collapse" if tol is None else
                        "floor" if tag == "dssm_aug+logq+ns8" else "band")
    with open(os.path.join(ART, source)) as f:
        ref = next(r for r in json.load(f)["results"] if r["model"] == tag)
    assert best_of(ref) == target
    if row.log is None:                   # the reference kept no val log of the rneg rows
        assert tag.endswith("rneg4")
        return
    parsed = best_epoch(parse_log(os.path.join(REPO, row.log)))
    assert parsed["epoch"] == ref["best_epoch"]
    assert table.criterion(parsed["data"]) == target


def test_collapse_band_and_cascade_targets(table):
    """The collapse band lies between random and half of popularity; each
    cascade's target is the reference's disposition of it."""
    with open(os.path.join(ART, "itemcf_quality_r04.json")) as f:
        itemcf = json.load(f)
    with open(os.path.join(ART, "popularity_baseline_r05.json")) as f:
        popularity = json.load(f)
    with open(os.path.join(ART, "cascade_disposition_r05.json")) as f:
        disposition = json.load(f)["results"]
    assert table.RANDOM_HR10 == itemcf["random_baseline"]["HR@10"]
    assert table.COLLAPSE_MAX < popularity["HR@10"] / 2
    assert {k: v[0] for k, v in table.CASCADES.items()} == {
        "dcn": round(disposition["cascade_dcn_impression_trained"], 4),
        "dcn_rneg4": disposition["cascade_dcn_rneg4_debiased"],
        "attention_rneg4": disposition["cascade_attention_rneg4_debiased"]}
    assert {k: v[0] for k, v in table.ITEMCF.items()} == {k: itemcf[k]
                                                          for k in ("HR@10", "HR@50")}
    assert table.ITEMCF_QUERIES == itemcf["queries"]
    for name in ("cascade_eval_rneg_r05.json", "cascade_eval_rneg_att_r05.json"):
        with open(os.path.join(ART, name)) as f:
            ref = json.load(f)
        ranker = table.cascade_ranker(ref)
        assert ref["HR@10_cascade"] == table.CASCADES[ranker][0]
        assert (ref["fetch"], ref["k"], ref["queries"]) == (100, 10, 35992)


# -- (b) a tiny campaign of the variant paths ------------------------------------


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """``--prepare`` at the tiny scale, then the five variant paths for two
    epochs, all at once, on the CPU; returns (workdir, val-log dir, artifact)."""
    fullscale = load_script("fullscale_rankers_torch")
    workdir = str(tmp_path_factory.mktemp("variants"))
    out = tmp_path_factory.mktemp("variants_out")
    artifact = fullscale.main(
        ["--prepare", "--workdir", workdir, "--synth-args", TINY,
         "--models", ",".join(RUN_MODELS), "--epochs", str(RUN_EPOCHS), "--device", "cpu",
         "--jobs", str(len(RUN_MODELS)), "--seed", "7", "--out", str(out / "rankers.json"),
         "--val-logs", str(out / "logs")])
    return workdir, str(out / "logs"), artifact


def test_variant_campaign_artifact_has_the_jax_artifacts_keys(campaign):
    workdir, _, artifact = campaign
    with open(os.path.join(ART, "rankers_fullscale_r05.json")) as f:
        ref = json.load(f)
    assert set(artifact) >= (set(ref) - {"backend", "notes"}) | {"device", "jobs", "seed"}
    assert "failed" not in artifact
    ref_keys = {k for r in ref["results"] for k in r} - {"carried_from", "reused_existing_run"}
    assert [r["model"] for r in artifact["results"]] == [n.replace("@", "_")
                                                         for n in RUN_MODELS]
    optimizers = {"fm_adamw": "adamw", "dssm_aug+logq+adamw": "adamw"}
    for res in artifact["results"]:
        want = ref_keys - ({"final_retrieval_eval"} if "Retrieval" not in res["best"] else set())
        assert set(res) == want | {"seed"}, res["model"]
        assert res["optimizer"] == optimizers.get(res["model"], "rowwise_adagrad")
        assert (res["epochs"], res["seed"]) == (RUN_EPOCHS, 7)
        for cohort in res["best"].values():
            assert all(math.isfinite(v) for v in cohort.values()), res["model"]
        with open(os.path.join(workdir, f"{res['model']}.yaml")) as f:
            assert "random_neg_per_positive" in f.read() or "rneg" not in res["model"]


def test_variant_campaign_best_epochs_are_jax_log_analysis(campaign):
    from news_recsys_tpu.utils.log_analysis import best_epoch, parse_log

    _, logs, artifact = campaign
    for res in artifact["results"]:
        epochs = parse_log(os.path.join(logs, f"{res['model']}_val_log.log"))
        assert len(epochs) == RUN_EPOCHS
        best = best_epoch(epochs)
        assert res["best_epoch"] == best["epoch"], res["model"]
        assert res["best"] == {coh.replace(" Users", "").replace(" ", "_"):
                               {k: round(v, 5) for k, v in vals.items()}
                               for coh, vals in best["data"].items()}, res["model"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_routes_are_logged_once_a_table(dtype):
    """``make_table_updater`` logs each large table's route the first time
    the table takes it: the dense AdaGrad route at 1/8 of a table's rows or
    more, else the sorted route with the row scatter (float32) or the
    unique-row plain write (bfloat16); a second update logs nothing."""
    import logging
    from types import SimpleNamespace

    import torch

    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    from news_recsys_tpu_torch.training import sparse_step as tss
    from news_recsys_tpu_torch.zoo import mind_ranker_config

    raw = config_to_dict(mind_ranker_config("dcn"))
    raw["mesh"]["param_dtype"] = dtype
    cfg = config_from_dict(raw)
    spec = {"item_id": (640, 16), "user_id": (9000, 16)}       # 768 and 9,088 rows padded
    slots = {"item_id": 96, "user_id": 1000}                    # 96 = 768 / 8: dense
    rng = np.random.default_rng(0)
    tables = {t: torch.zeros(tss.padded_vocab(v), d, dtype=getattr(torch, dtype))
              for t, (v, d) in spec.items()}
    state = SimpleNamespace(model=SimpleNamespace(embedder=SimpleNamespace(tables=tables)),
                            emb_acc={t: torch.full((x.shape[0],), 0.1)
                                     for t, x in tables.items()})
    per_table = {t: [(torch.from_numpy(rng.integers(1, spec[t][0], n).astype(np.int32)),
                      torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)))]
                 for t, n in slots.items()}
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("news_recsys_tpu_torch.sparse_step")
    logger.addHandler(handler)
    try:
        update = tss.make_table_updater(cfg, spec)
        update(state, per_table, 0, 0.01)
        update(state, per_table, 1, 0.01)
    finally:
        logger.removeHandler(handler)
    sorted_route = "unique-row, plain write" if dtype == "bfloat16" else "sorted, row scatter"
    assert lines == ["table item_id: dense route at 96 slots of 768 rows",
                     f"table user_id: {sorted_route} route at 1000 slots of 9088 rows"]


# -- (c) the attention-ranked cascade --------------------------------------------


def flax_tree(model) -> dict:
    """The port model's parameters as the JAX package's variables tree."""
    from news_recsys_tpu_torch.convert import params_to_flax

    tree = {}
    for path, value in params_to_flax(model).items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return {"params": tree}


def test_attention_cascade_eval_answers_as_jaxs_cascade(campaign, monkeypatch):
    """The script's cascade (DSSM recall, ``attention_rneg4`` at its newest
    epoch) against the JAX package's ``CascadeRecommender`` on the same
    weights and item splits: the same ids for the first queries (but for
    ties at 2e-5) and scores within 2e-5; the script's artifact is finite."""
    from news_recsys_tpu import serving as jserving
    from news_recsys_tpu.config import load_config as jload_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset as JPacked
    from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
    from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
    from news_recsys_tpu_torch.config import load_config

    from test_torch_serving import assert_same_answers

    monkeypatch.setenv("NRT_PALLAS", "")
    workdir = campaign[0]
    cascade = load_script("cascade_eval_torch")
    recall_cfg = os.path.join(workdir, "dssm_aug+logq+adamw.yaml")
    ranker_cfg = os.path.join(workdir, "attention_rneg4.yaml")
    argv = ["--recall-cfg", recall_cfg,
            "--recall-ckpt", os.path.join(workdir, "exp_dssm_aug+logq+adamw", "ckpts",
                                          f"epoch_{RUN_EPOCHS - 1:03d}.pt"),
            "--ranker-cfg", ranker_cfg,
            "--ranker-ckpt", os.path.join(workdir, "exp_attention_rneg4"), "--device", "cpu"]
    args = cascade.build_parser().parse_args(argv)
    rc_cfg, dssm, recall, casc = cascade.build(args)
    query, targets, histories = cascade.dev_queries(load_config(recall_cfg), CASCADE_QUERIES)
    cols = [s.name for s in dssm.user_schema.specs] + [
        f"{s.name}_mask" for s in dssm.user_schema.specs if f"{s.name}_mask" in query]
    batch = {c: query[c] for c in cols} | {"label": np.zeros((len(targets), 1), np.float32)}
    got = casc.recommend(batch, k=10, histories=histories)

    jdcfg, jrcfg = jload_config(recall_cfg), jload_config(ranker_cfg)
    jrecall = jserving.Recommender(jdcfg, jbuild_dssm(jdcfg), flax_tree(dssm),
                                   JPacked.open_split(jdcfg, "item"), backend="device")
    jcasc = jserving.CascadeRecommender(jrecall, jrcfg, jbuild_ranker(jrcfg, "attention"),
                                        flax_tree(casc.ranker_model),
                                        JPacked.open_split(jrcfg, "item"), fetch=100)
    want = jcasc.recommend(batch, k=10, histories=histories)
    assert sum(len(ids) for ids in got[0]) > 0
    assert_same_answers(got, want, tol=2e-5)

    res = cascade.main(argv + ["--max-queries", str(CASCADE_QUERIES), "--out",
                               os.path.join(workdir, "cascade.json")])
    assert res["queries"] == CASCADE_QUERIES and res["ranker"]["cfg"] == ranker_cfg
    assert load_script("quality_table_torch").cascade_ranker(res) == "attention_rneg4"
    for key in ("HR@10_recall_only", "HR@10_cascade", "lift"):
        assert math.isfinite(res[key]) and res[key] >= 0, key


# -- (d) the committed campaign --------------------------------------------------


def test_quality_table_of_the_committed_variant_campaign(table):
    """``scripts/quality_table_torch.py`` over the r17 artifacts (the variant
    rows of both seeds, seed 42's DSSM ablations, both rneg cascades of each
    seed and ItemCF on the card's host): every row inside the band set before
    the run, each value the artifact's own, the card an NVIDIA one."""
    runs = [f"{ART}/rankers_fullscale_torch_r17.json",
            f"{ART}/rankers_fullscale_torch_r17_seed7.json",
            f"{ART}/rankers_fullscale_torch_r17_ablations.json"]
    logs = [f"{ART}/fullscale_torch_r17/seed42", f"{ART}/fullscale_torch_r17/seed7",
            f"{ART}/fullscale_torch_r17/seed42"]
    cascades = [f"{ART}/cascade_eval_torch_r17_{r}_seed{s}.json"
                for r in ("dcn_rneg4", "attention_rneg4") for s in (42, 7)]
    got = table.main(["--runs", *runs, "--logs", *logs, "--cascade", *cascades,
                      "--itemcf", f"{ART}/itemcf_fullscale_torch_r17.json"])
    rows = [r[0] for r in VARIANT_ROWS]
    assert sorted(got) == sorted(rows + [os.path.basename(c) for c in cascades] + ["itemcf"])
    for tag in rows:
        assert got[tag]["seeds"] == ([42] if tag in ABLATIONS else [42, 7]), tag
    assert all(all(np.atleast_1d(row["inside"])) for row in got.values())
    for path in runs + cascades + [f"{ART}/itemcf_fullscale_torch_r17.json"]:
        with open(path) as f:
            doc = json.load(f)
        assert doc["device"]["name"].startswith("NVIDIA"), path
        for res in doc.get("results", []):
            seed_col = got[res["model"]]["seeds"].index(doc["seed"])
            assert got[res["model"]]["values"][seed_col] == best_of(res)
