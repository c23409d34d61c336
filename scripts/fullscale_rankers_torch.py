"""Train the ranking zoo and the DSSM at MIND scale with the PyTorch port on
learnable synthetic data, and record each run's best epoch: the port's
counterpart of ``scripts/fullscale_rankers.py`` and of the ``--synth`` data
half of ``scripts/mind_parity.py``. Imports the port, torch, numpy and PyYAML
only.

Usage (data and base config first, then the runs):

    python scripts/fullscale_rankers_torch.py --prepare --workdir /tmp/fullscale --models ""
    python scripts/fullscale_rankers_torch.py --config /tmp/fullscale/base.yaml \\
        --workdir /tmp/fullscale --models lr,fm,deepfm,dcn@v2,deep,widedeep,dcn,attention,\\
dssm@aug+logq+ns8 --epochs 6 --shallow-epochs 16 --dssm-epochs 40 --model-epochs dcn@v2=16 \\
        --jobs 4 --out artifacts/rankers_fullscale_torch.json --val-logs artifacts/fullscale_torch

``--prepare`` writes the raw files with the port's ``synth`` (by default at
the reference's scale, seed 3), runs ``preprocess`` on a boot config, writes
``<workdir>/base.yaml`` with table sizes from the ID maps, runs ``fe`` and
tightens the small tables to the vocabularies that extraction built.

Each model trains in a fresh ``python -m news_recsys_tpu_torch train``
process on ``--device``; ``--jobs N`` runs up to N of them at once (the
steps are host-bound, so N runs share one card). A run's ``val_log.log``
gives its best epoch by Warm-Start AUC (HR@k for the DSSM), as the
reference's ``log_analysis.py`` picks it. The artifact names the card
(``nvidia-smi`` name and power limit); its ``examples_per_sec_last`` is
taken with up to ``jobs`` runs sharing the card and the host, not a
throughput figure. ``FULLSCALE_REUSE=1`` keeps an experiment dir whose
``val_log.log`` already holds the epochs asked for.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODELS = ["lr", "deep", "widedeep", "fm", "deepfm", "dcn", "attention", "dssm"]

ARRAY_FEATURES = ("hist", "entities")  # extracted at full scale; only the
                                       # sequence models consume them

FEATS = ["user_id", "item_id", "category", "subcategory", "user_click_category",
         "hist", "entities"]

# scripts/mind_parity.py's --synth-args: the reference's MIND-small scale
SYNTH_ARGS = ("--news 65239 --users 94057 --train-impressions 220000 "
              "--dev-impressions 73000 --seed 3")

DATA = ("learnable synthetic MIND (news_recsys_tpu_torch/data/synthetic.py, held equal "
        "to the JAX package's generator; synth {synth})")


# -- the data and the base config ------------------------------------------------


def boot_config_dict(workdir: str, data_dir: str) -> dict:
    """``preprocess`` reads only the paths: the minimal schema of
    ``scripts/mind_parity.py``'s boot config."""
    return {"name": "boot",
            "paths": {"data_path": data_dir, "out_basedir": os.path.join(workdir, "tmp")},
            "features": {"sparse_feature_names": FEATS[:5],
                         "item_feature_names": ["item_id"],
                         "user_feature_names": ["user_id"]},
            "embeddings": {"embedding_size": {f: 8 for f in FEATS[:5]},
                           "embedding_table_size": {f: 8 for f in FEATS[:5]}}}


def base_config_dict(workdir: str, data_dir: str, n_users: int, n_news: int) -> dict:
    """The reference's ``train_cf_deep.yaml`` recipe with the user and item
    tables sized from the ID maps (``scripts/mind_parity.py::write_config``)."""
    return {
        "name": "deep",
        "paths": {"data_path": data_dir, "out_basedir": os.path.join(workdir, "tmp")},
        "features": {
            "feature_names": FEATS,
            "sparse_feature_names": FEATS[:5],
            "array_feature_names": ["hist", "entities"],
            "item_feature_names": ["item_id", "category", "subcategory", "entities"],
            "user_feature_names": ["user_id", "user_click_category", "hist"],
            "array_max_length": {"hist": 30, "entities": 5},
        },
        "embeddings": {
            "embedding_size": {"user_id": 32, "item_id": 32, "category": 16,
                               "subcategory": 16, "user_click_category": 16,
                               "entities": 16},
            "embedding_table_size": {"user_id": int(n_users), "item_id": int(n_news),
                                     "category": 64, "subcategory": 512,
                                     "user_click_category": 64, "entities": 60000},
            "share_emb_table_features": {"hist": "item_id"},
            "arena_tables": True,
        },
        "dataset": {"batch_size": 512},
        "train_hparams": {"val_freq": 1, "max_epoch": 30, "lr": 1e-3,
                          "min_lr": 5e-6, "lr_milestones": [40000, 200000],
                          "max_step": 300000, "seed": 42,
                          "embedding_optimizer": "rowwise_adagrad"},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 1,
                          "num_heads": 2, "ff_dim": 64},
        "dcn_cfg": {"num_layers": 3, "version": 1},
    }


def tighten(raw: dict, vocab: dict) -> dict:
    """The small tables cut to the vocabularies extraction built (the
    ``[dict, max]`` of ``original_val_2_embedding_idx_dict.json``), so that
    no id falls out of its table."""
    for feat in ("category", "subcategory", "user_click_category", "entities"):
        if feat in vocab:
            raw["embeddings"]["embedding_table_size"][feat] = int(vocab[feat][1]) + 1
    return raw


def prepare(workdir: str, synth_args: str = SYNTH_ARGS, data_dir: str = None) -> str:
    """Raw files (unless ``<workdir>/Data/MIND`` has them), ``preprocess``,
    ``base.yaml``, ``fe`` and the tightening; returns the base config's path
    and writes ``prepare.json`` (the synth arguments and each step's wall
    time) beside it. A ``data_dir`` given holds the raw files already
    (``MINDsmall_{train,dev}/``): it is read, never written, and nothing is
    synthesised."""
    import yaml

    from news_recsys_tpu_torch.cli import main as cli

    os.makedirs(workdir, exist_ok=True)
    own = data_dir is None
    data_dir = os.path.join(workdir, "Data", "MIND") if own else data_dir
    times = {}

    def step(label, *argv):
        t0 = time.time()
        cli(list(argv))
        times[label] = round(time.time() - t0, 1)
        print(f"prepare: {label} {times[label]} s", flush=True)

    if own and not os.path.exists(os.path.join(data_dir, "MINDsmall_dev", "behaviors.tsv")):
        step("synth", "synth", "--out", data_dir, *synth_args.split())
    boot_path = os.path.join(workdir, "boot.yaml")
    with open(boot_path, "w") as f:
        yaml.safe_dump(boot_config_dict(workdir, data_dir), f)
    step("preprocess", "preprocess", "-c", boot_path)

    pre = os.path.join(workdir, "tmp", "preprocess")
    with open(os.path.join(pre, "news_id_map.json")) as f:
        n_news = max(json.load(f).values()) + 1
    with open(os.path.join(pre, "user_id_map.json")) as f:
        n_users = max(json.load(f).values()) + 1
    base = os.path.join(workdir, "base.yaml")
    with open(base, "w") as f:
        yaml.safe_dump(base_config_dict(workdir, data_dir, n_users, n_news), f)
    step("fe", "fe", "-c", base)

    with open(os.path.join(workdir, "tmp", "extractored_feature",
                           "original_val_2_embedding_idx_dict.json")) as f:
        vocab = json.load(f)
    with open(base) as f:
        raw = tighten(yaml.safe_load(f), vocab)
    with open(base, "w") as f:
        yaml.safe_dump(raw, f)
    with open(os.path.join(workdir, "prepare.json"), "w") as f:
        json.dump({"synth": synth_args if own else None, "wall_seconds": times}, f, indent=2)
    return base


# -- each model's recipe -----------------------------------------------------------


def model_config_dict(base_raw: dict, name: str, optimizer: str = "auto",
                      chunk_steps: int = 0) -> dict:
    """The config ``scripts/fullscale_rankers.py::run_model`` writes to
    ``<workdir>/<tag>.yaml`` for ``name`` (``model@token+token``) from the
    base config's full dict (``config_to_dict(load_config(base))``), as a
    new dict; ``base_raw`` is left as it was."""
    import copy

    raw = copy.deepcopy(base_raw)
    name, _, variant = name.partition("@")
    raw["name"] = name
    feats = raw["features"]

    def drop_arrays(keep=()):
        gone = [a for a in ARRAY_FEATURES if a not in keep]
        for key in ("feature_names", "array_feature_names",
                    "item_feature_names", "user_feature_names"):
            feats[key] = [f for f in feats.get(key, []) if f not in gone]
        for a in gone:
            feats.get("array_max_length", {}).pop(a, None)
            raw["embeddings"]["embedding_size"].pop(a, None)
            raw["embeddings"]["embedding_table_size"].pop(a, None)
            raw["embeddings"].get("share_emb_table_features", {}).pop(a, None)

    if name == "attention":
        # configs/attention.yaml: the history Transformer and entities, the
        # history sharing the item table
        drop_arrays(keep=ARRAY_FEATURES)
        raw["attention_cfg"] = {"hist_feature": "hist", "num_layers": 1,
                                "num_heads": 2, "ff_dim": 64}
    elif name == "dssm":
        # configs/dssm.yaml's towers at 16 wide, the history pooled in the
        # user tower; the reference's retrieval schedule, lr 3e-3 -> 1e-4
        # over steps [10k, 60k]
        drop_arrays(keep=("hist",))
        raw["embeddings"]["embedding_size"] = {
            k: 16 for k in raw["embeddings"]["embedding_size"]}
        raw["train_hparams"].update(lr=3e-3, min_lr=1e-4, lr_milestones=[10000, 60000])
    else:
        drop_arrays()
    if name in ("lr", "fm", "deepfm"):
        # the shallow models score straight from raw embeddings: a small
        # init keeps them out of sigmoid saturation
        # (artifacts/fm_diagnosis_r05.json)
        raw["embeddings"]["init_scale"] = 0.03
    if optimizer == "auto":
        optimizer = "rowwise_adagrad"
    raw["train_hparams"]["embedding_optimizer"] = optimizer
    for tok in [t for t in variant.split("+") if t]:
        if tok == "adamw":
            raw["train_hparams"]["embedding_optimizer"] = "adamw"
        elif tok == "aug":
            raw.setdefault("dssm_cfg", {})["hist_augment"] = True
        elif tok == "logq":
            raw.setdefault("dssm_cfg", {})["logq_correction"] = True
        elif tok == "v2":
            raw.setdefault("dcn_cfg", {"num_layers": 3})["version"] = 2
        elif tok.startswith("ns"):
            raw.setdefault("dssm_cfg", {})["negative_sample_rate"] = int(tok[2:])
        elif tok.startswith("temp"):
            raw.setdefault("dssm_cfg", {})["temperature"] = float(tok[4:])
        elif tok == "bf16":
            raw.setdefault("mesh", {}).update(param_dtype="bfloat16",
                                              compute_dtype="bfloat16")
        elif tok.startswith("rneg"):
            raw.setdefault("rank_cfg", {})["random_neg_per_positive"] = int(tok[4:])
        elif tok.startswith("is"):
            raw["embeddings"]["init_scale"] = float(tok[2:])
        elif tok.startswith("b") and tok[1:].isdigit():
            # large batch: lr scaled by the square root of the batch's
            # multiple of 512, the step counts cut by it (the schedule keeps
            # its place in epochs)
            batch = int(tok[1:])
            factor = batch // 512
            raw["dataset"]["batch_size"] = batch
            hp = raw["train_hparams"]
            hp["lr"] = hp["lr"] * factor ** 0.5
            hp["min_lr"] = hp["min_lr"] * factor ** 0.5
            hp["lr_milestones"] = [max(1, m // factor) for m in hp["lr_milestones"]]
            hp["max_step"] = max(1, hp["max_step"] // factor)
        else:
            raise ValueError(f"Unknown variant token {tok!r} in {variant!r}")
    if chunk_steps:
        raw["train_hparams"]["chunk_steps"] = chunk_steps
    if name == "widedeep":
        raw.setdefault("wide_and_deep_cfg", {})["wide_feature_names"] = [
            "category", "subcategory"]
        # column 0 of a wide feature's row is its wide weight (16 + 1)
        for f in raw["wide_and_deep_cfg"]["wide_feature_names"]:
            raw["embeddings"]["embedding_size"][f] = 17
    if name in ("fm", "deepfm"):
        # the FM needs equal dims (w = column 0, v = columns 1..d)
        raw["embeddings"]["embedding_size"] = {
            k: 16 for k in raw["embeddings"]["embedding_size"]}
    if name == "dcn":
        raw.setdefault("dcn_cfg", {"num_layers": 3, "version": 1})
    return raw


def model_tag(name: str) -> str:
    model, _, variant = name.partition("@")
    return f"{model}_{variant}" if variant else model


def model_epochs(name: str, args) -> int:
    """``--model-epochs`` for ``name``, else ``--shallow-epochs`` for LR, FM
    and DeepFM, ``--dssm-epochs`` for the DSSM, else ``--epochs``."""
    if name in args.model_epochs:
        return args.model_epochs[name]
    base = name.split("@")[0]
    if base in ("lr", "fm", "deepfm"):
        return args.shallow_epochs or args.epochs
    if base == "dssm":
        return args.dssm_epochs or args.epochs
    return args.epochs


# -- the runs ---------------------------------------------------------------------


def job_threads(jobs: int) -> int:
    """OMP threads of each of ``jobs`` runs side by side (0: one run, the default)."""
    return max(1, (os.cpu_count() or 1) // jobs) if jobs > 1 else 0


def train_process(model: str, config: str, exp_dir: str, epochs: int, device: str = "cuda",
                  threads: int = 0) -> float:
    """Train ``model`` on ``config`` in a fresh ``python -m news_recsys_tpu_torch
    train`` process on ``device`` into ``exp_dir`` (a stale one is removed
    first: its logs would be parsed with the new ones). The process's output
    is kept as ``exp_dir/train_process.log``; returns the wall seconds."""
    if os.path.exists(exp_dir):
        shutil.rmtree(exp_dir)
    env = dict(os.environ)
    if threads:         # runs side by side: each its share of the host's cores
        env.setdefault("OMP_NUM_THREADS", str(threads))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "news_recsys_tpu_torch", "train", "-c", config,
         "-m", model, "--workdir", exp_dir, "--epochs", str(epochs), "--device", device],
        capture_output=True, text=True, cwd=REPO, env=env)
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "train_process.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)      # the logger's lines: routes, epochs
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
        raise RuntimeError(f"{model} training failed (rc={proc.returncode})")
    return time.time() - t0


def best_of(exp_dir: str) -> dict:
    """The best epoch of ``exp_dir/val_log.log`` (``utils/log_analysis``):
    Warm-Start AUC for the rankers, HR@k for the retrieval blocks."""
    from news_recsys_tpu_torch.utils.log_analysis import best_epoch, parse_log

    return best_epoch(parse_log(os.path.join(exp_dir, "val_log.log")))


def run_model(name: str, config: str, epochs: int, workdir: str, optimizer: str,
              chunk_steps: int = 0, device: str = "cuda", seed=None, threads: int = 0) -> dict:
    """Train ``name`` in a fresh process on ``device`` and read its best epoch."""
    import yaml

    from news_recsys_tpu_torch.config import config_to_dict, load_config

    raw = model_config_dict(config_to_dict(load_config(config)), name, optimizer, chunk_steps)
    if seed is not None:
        raw["train_hparams"]["seed"] = int(seed)
    model = name.split("@")[0]
    tag = model_tag(name)
    model_cfg = os.path.join(workdir, f"{tag}.yaml")
    with open(model_cfg, "w") as f:
        yaml.safe_dump(raw, f)

    exp_dir = os.path.join(workdir, f"exp_{tag}")
    val_log = os.path.join(exp_dir, "val_log.log")
    reuse = os.environ.get("FULLSCALE_REUSE") == "1" and os.path.exists(val_log)
    if reuse:
        with open(val_log) as f:
            reuse = f.read().count("Validation Results") >= epochs
    wall = 0.0 if reuse else train_process(model, model_cfg, exp_dir, epochs, device, threads)

    best = best_of(exp_dir)
    exps = []
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "examples_per_sec" in rec:
                exps.append(rec["examples_per_sec"])
    extra = {}
    ret_path = os.path.join(exp_dir, "retrieval_eval.json")
    if os.path.exists(ret_path):
        with open(ret_path) as f:
            extra["final_retrieval_eval"] = json.load(f)
    return {
        "model": tag,
        "optimizer": raw["train_hparams"]["embedding_optimizer"],
        "epochs": epochs,
        "seed": raw["train_hparams"]["seed"],
        **({"reused_existing_run": True} if reuse else {}),
        "wall_seconds": round(wall, 1),
        "examples_per_sec_last": round(exps[-1], 1) if exps else None,
        "best_epoch": best["epoch"],
        "best": {coh.replace(" Users", "").replace(" ", "_"):
                 {k: round(v, 5) for k, v in vals.items()}
                 for coh, vals in best["data"].items()},
        "exp_dir": exp_dir,
        **extra,
    }


def card(device: str) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them; on
    the CPU, the name ``cpu``."""
    if not device.startswith("cuda"):
        return {"name": "cpu", "power_limit": None, "torch_device": device}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit, "torch_device": device}


def parse_model_epochs(spec: str) -> dict:
    out = {}
    for item in [s for s in spec.split(",") if s]:
        name, _, n = item.rpartition("=")
        out[name] = int(n)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="base full-scale yaml (default with --prepare: <workdir>/base.yaml)")
    ap.add_argument("--prepare", action="store_true",
                    help="write the raw files, preprocess, base.yaml and fe into --workdir "
                         "first")
    ap.add_argument("--synth-args", default=SYNTH_ARGS,
                    help="the synth command's arguments for --prepare")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--optimizer", default="auto",
                    help="auto = rowwise_adagrad for every model; pass an explicit optimizer "
                         "to force one column across the whole zoo")
    ap.add_argument("--chunk-steps", type=int, default=0)
    ap.add_argument("--dssm-epochs", type=int, default=0,
                    help="epochs of the DSSM retrieval runs")
    ap.add_argument("--shallow-epochs", type=int, default=0,
                    help="epochs of the shallow lr/fm/deepfm runs")
    ap.add_argument("--model-epochs", type=parse_model_epochs, default={},
                    help="NAME=N,...: epochs of single runs (over the other epoch flags)")
    ap.add_argument("--workdir", default="/tmp/fullscale")
    ap.add_argument("--out", default="artifacts/rankers_fullscale_torch.json")
    ap.add_argument("--val-logs", default="artifacts/fullscale_torch")
    ap.add_argument("--device", default="cuda", help="torch device of the runs: cuda or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="train_hparams.seed of every run (default: the base config's)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="runs at once (they share the one card)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    names = [n for n in args.models.split(",") if n]
    device = card(args.device) if names else None      # no card: fail before any work
    if args.prepare:
        base = prepare(args.workdir, args.synth_args)
        args.config = args.config or base
    if args.config is None:
        raise SystemExit("--config is required without --prepare")
    if not names:
        return {}
    os.makedirs(args.workdir, exist_ok=True)
    threads = job_threads(args.jobs)

    def one(name):
        print(f"=== {name} ===", flush=True)
        res = run_model(name, args.config, model_epochs(name, args), args.workdir,
                        args.optimizer, chunk_steps=args.chunk_steps, device=args.device,
                        seed=args.seed, threads=threads)
        print(json.dumps({k: v for k, v in res.items() if k != "exp_dir"}), flush=True)
        return res

    t0 = time.time()
    # the longest runs first, so that the short ones fill in beside them
    order = sorted(names, key=lambda n: -model_epochs(n, args))
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        futures = {n: pool.submit(one, n) for n in order}
    results, failed = [], []
    for n in names:         # a failed run leaves the others' results standing
        try:
            results.append(futures[n].result())
        except Exception as exc:
            print(f"{n}: {exc}", flush=True)
            failed.append(n)
    campaign_wall = time.time() - t0

    os.makedirs(args.val_logs, exist_ok=True)
    for res in results:
        shutil.copy(os.path.join(res.pop("exp_dir"), "val_log.log"),
                    os.path.join(args.val_logs, f"{res['model']}_val_log.log"))

    prep = os.path.join(os.path.dirname(os.path.abspath(args.config)), "prepare.json")
    synth = SYNTH_ARGS
    if os.path.exists(prep):
        with open(prep) as f:
            synth = json.load(f)["synth"]
    artifact = {
        "device": device,
        "data": DATA.format(synth=synth),
        "criterion": "best epoch by Warm-Start AUC (reference log_analysis.py); HR@10 for "
                     "the DSSM",
        "jobs": args.jobs,
        "seed": args.seed if args.seed is not None else (results[0]["seed"] if results else None),
        "examples_per_sec_last": f"the last epoch's examples/s, taken with up to {args.jobs} "
                                 "runs sharing the card and the host: not a throughput figure",
        "campaign_wall_seconds": round(campaign_wall, 1),
        "results": results,
        **({"failed": failed} if failed else {}),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}")

    lr_res = [r for r in results if r["model"] == "lr"]
    lr_auc = lr_res[0]["best"]["Overall"]["AUC"] if lr_res else None
    for r in results:
        if "Retrieval" in r["best"]:
            hr = {k: v for k, v in r["best"]["Retrieval"].items() if k.startswith("HR@")}
            print(f"{r['model']}: retrieval {hr}")
        elif r["model"] != "lr":
            line = f"{r['model']}: Overall AUC {r['best']['Overall']['AUC']:.4f}"
            if lr_auc is not None:
                delta = r["best"]["Overall"]["AUC"] - lr_auc
                line += f" (vs LR {'+' if delta >= 0 else ''}{delta:.4f})"
            print(line)
    if failed:
        raise SystemExit(f"runs failed: {failed}")
    return artifact


if __name__ == "__main__":
    main()
