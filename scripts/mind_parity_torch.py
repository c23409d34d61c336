"""Turnkey MIND parity harness on the PyTorch port: raw MIND-small files to
the reference's scoreboard table (Model | AUC | MRR | nDCG@5 | nDCG@10) in
one command. The port's counterpart of ``scripts/mind_parity.py``; imports
the port, torch, numpy and PyYAML only.

    python scripts/mind_parity_torch.py --data <dir holding MINDsmall_train/ and MINDsmall_dev/>
    python scripts/mind_parity_torch.py --synth --workdir <workdir> \\
        --out artifacts/mind_parity_torch_synth.json

Steps:
1. data: ``--data`` (a directory holding ``MINDsmall_train/`` and
   ``MINDsmall_dev/``, each with ``news.tsv`` and ``behaviors.tsv``: read,
   never written), ``--synth`` (the learnable synthetic stand-in at the
   reference's scale, written by the port's ``synth`` into
   ``<workdir>/Data/MIND``), or else a download of the official archives,
   which ends the run with exit code 2 where the network refuses;
2. the sha256 and size of each of the four files;
3. ``preprocess``, ``base.yaml`` (the reference's ``train_cf_deep.yaml``
   recipe, the user and item tables sized from the ID maps), ``fe`` and the
   small tables cut to the vocabularies built, through the port's CLI
   (``scripts/fullscale_rankers_torch.py::prepare``);
4. each model (deep, dcn and the attention ranker by default) trains on
   that recipe in a fresh ``python -m news_recsys_tpu_torch train`` process
   on ``--device``; its best epoch by Warm-Start AUC (the reference's
   criterion) is read from its ``val_log.log``;
5. the best epoch's checkpoint is loaded with ``Trainer.load_checkpoint``
   and the dev split scored with ``Trainer.predict`` on ``--device``; the
   table takes the pooled AUC and MRR@10, nDCG@5 and nDCG@10 as means over
   users (the reference's grouping).

Everything runs on the card unless ``--device cpu`` is given; with no card
the default ``cuda`` is an error before any work. The artifact names the
card (``nvidia-smi`` name and power limit).
"""

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

MIND_URLS = {
    "MINDsmall_train": "https://mind201910small.blob.core.windows.net/release/MINDsmall_train.zip",
    "MINDsmall_dev": "https://mind201910small.blob.core.windows.net/release/MINDsmall_dev.zip",
}

ARRAY_FEATURES = ("hist", "entities")   # only the attention ranker reads them
MODELS = "deep,dcn,attention"
K_MRR = 10


def fullscale():
    """``scripts/fullscale_rankers_torch.py`` of this checkout: the boot and
    base configs, the tightening and the data preparation."""
    spec = importlib.util.spec_from_file_location(
        "_fullscale_rankers_torch", os.path.join(REPO, "scripts", "fullscale_rankers_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- the data ---------------------------------------------------------------------


def try_download(data_dir: str) -> bool:
    """Fetch and unzip the official archives; False if the network refuses."""
    import zipfile
    os.makedirs(data_dir, exist_ok=True)
    for split, url in MIND_URLS.items():
        dest = os.path.join(data_dir, split)
        if os.path.exists(os.path.join(dest, "behaviors.tsv")):
            continue
        zpath = os.path.join(data_dir, f"{split}.zip")
        try:
            print(f"downloading {url} ...", flush=True)
            urllib.request.urlretrieve(url, zpath)
        except Exception as e:                      # DNS, offline, refused
            print(f"download failed: {e}", flush=True)
            return False
        with zipfile.ZipFile(zpath) as z:
            z.extractall(dest)
        os.remove(zpath)
    return True


def checksum_manifest(data_dir: str) -> dict:
    """sha256 and bytes of the four raw files, keyed ``<split>/<file>``."""
    out = {}
    for split in ("MINDsmall_train", "MINDsmall_dev"):
        for fname in ("news.tsv", "behaviors.tsv"):
            path = os.path.join(data_dir, split, fname)
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            out[f"{split}/{fname}"] = {"sha256": h.hexdigest(),
                                       "bytes": os.path.getsize(path)}
    return out


# -- the models ---------------------------------------------------------------------


def model_config_dict(base_raw: dict, name: str) -> dict:
    """``base_raw`` (the dict of ``base.yaml``) as the config of ``name``: every
    model but the attention ranker drops ``hist`` and ``entities``. A new
    dict; ``base_raw`` is left as it was."""
    import copy

    raw = copy.deepcopy(base_raw)
    raw["name"] = name
    if name != "attention":
        feats = raw["features"]
        for key in ("feature_names", "array_feature_names",
                    "item_feature_names", "user_feature_names"):
            feats[key] = [x for x in feats[key] if x not in ARRAY_FEATURES]
        for a in ARRAY_FEATURES:
            feats["array_max_length"].pop(a, None)
            raw["embeddings"]["embedding_size"].pop(a, None)
            raw["embeddings"]["embedding_table_size"].pop(a, None)
            raw["embeddings"]["share_emb_table_features"].pop(a, None)
    return raw


def model_config(base_path: str, workdir: str, name: str) -> str:
    """Write ``<workdir>/<name>.yaml`` (:func:`model_config_dict` of
    ``base_path``) and return its path."""
    import yaml

    with open(base_path) as f:
        raw = model_config_dict(yaml.safe_load(f), name)
    path = os.path.join(workdir, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


# -- the table ------------------------------------------------------------------------


def per_user_ranking_metrics(uids, scores, labels) -> dict:
    """The pooled AUC and the per-user means of MRR@10, nDCG@5 and nDCG@10,
    the reference's grouping: each user's rows by score, highest first (ties
    in row order); a user with no positive counts 0 for all three; MRR
    counts a first positive only within the top 10."""
    from news_recsys_tpu_torch.training.metrics import pooled_auc

    order = np.lexsort((-scores, uids))
    u, s, y = uids[order], scores[order], labels[order]
    first_row = np.concatenate([[True], u[1:] != u[:-1]])
    starts = np.flatnonzero(first_row)
    seg = np.cumsum(first_row) - 1
    n_users = len(starts)
    rank = np.arange(len(u)) - starts[seg] + 1          # 1-based, by score
    pos = y > 0
    n_pos = np.bincount(seg, weights=y.astype(np.float64), minlength=n_users)
    first = np.full(n_users, np.inf)
    np.minimum.at(first, seg[pos], rank[pos].astype(np.float64))
    mrr = np.where(first <= K_MRR, 1.0 / first, 0.0)
    gains = 1.0 / np.log2(np.arange(1, len(u) + 1) + 1)
    out = {"AUC": float(pooled_auc(y, s)), "MRR": float(np.mean(np.where(n_pos > 0, mrr, 0.0)))}
    for k in (5, 10):
        top = pos & (rank <= k)
        dcg = np.bincount(seg[top], weights=gains[rank[top] - 1], minlength=n_users)
        ideal = np.concatenate([[0.0], np.cumsum(gains[:k])])[
            np.minimum(n_pos.astype(np.int64), k)]
        ndcg = np.where(ideal > 0, dcg / np.where(ideal > 0, ideal, 1.0), 0.0)
        out[f"nDCG@{k}"] = float(np.mean(np.where(n_pos > 0, ndcg, 0.0)))
    return {key: out[key] for key in ("AUC", "MRR", "nDCG@5", "nDCG@10")}


# -- training and scoring --------------------------------------------------------------


def train(name: str, cfg_path: str, workdir: str, epochs: int, device: str,
          threads: int = 0) -> dict:
    """Train ``name`` in a fresh process on ``device``; returns its experiment
    dir, wall seconds and best epoch."""
    fs = fullscale()
    exp_dir = os.path.join(workdir, f"exp_{name}")
    wall = fs.train_process(name, cfg_path, exp_dir, epochs, device, threads)
    return {"exp_dir": exp_dir, "wall": wall, "best": fs.best_of(exp_dir)}


def score_dev(cfg_path: str, ckpt: str, name: str, device: str) -> tuple:
    """``(user ids, scores, labels)`` of every dev row: the checkpoint loaded
    with ``Trainer.load_checkpoint``, the split scored with
    ``Trainer.predict`` on ``device``."""
    from news_recsys_tpu_torch.config import load_config
    from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import Trainer

    cfg = load_config(cfg_path)
    dev = PackedDataset.open_split(cfg, "dev")
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, build_ranker(cfg, name, device=device), workdir=tmp, device=device)
        tr.load_checkpoint(tr.init_state(), ckpt)
        scores = tr.predict(dev)
    return (dev.arrays["user_id"].astype(np.int64), np.asarray(scores),
            dev.arrays["label"][:, 0])


def checkpoint_of(run: dict) -> str:
    return os.path.join(run["exp_dir"], "ckpts", f"epoch_{run['best']['epoch']:03d}.pt")


def score(name: str, cfg_path: str, run: dict, device: str) -> dict:
    """The table's row of a trained run."""
    table = per_user_ranking_metrics(*score_dev(cfg_path, checkpoint_of(run), name, device))
    best = run["best"]
    return {"model": name, "best_epoch": best["epoch"], "wall_seconds": round(run["wall"], 1),
            "warm_auc_best": best["data"].get("Warm Start Users", {}).get("AUC"),
            **{k: round(v, 5) for k, v in table.items()},
            "val_log_overall": best["data"].get("Overall", {})}


# -- the command -------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="where the data step and the runs write (default: a new temporary dir)")
    ap.add_argument("--data", default=None,
                    help="existing dir holding MINDsmall_train/ + MINDsmall_dev/")
    ap.add_argument("--synth", action="store_true",
                    help="generate the synthetic stand-in instead of downloading")
    ap.add_argument("--models", default=MODELS)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--out", default="artifacts/mind_parity_torch.json")
    ap.add_argument("--synth-args", default="--news 65239 --users 94057 "
                    "--train-impressions 220000 --dev-impressions 73000 --seed 3")
    ap.add_argument("--device", default="cuda", help="torch device of every run: cuda or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="models trained at once (they share the one card); default one at "
                         "a time, as the JAX harness")
    ap.add_argument("--val-logs", default=None,
                    help="copy each run's val_log.log into this dir as <model>_val_log.log")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from news_recsys_tpu_torch.cli import _require_device

    _require_device(args.device)         # no card: fail before any work
    fs = fullscale()
    device = fs.card(args.device)

    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="mind_parity_torch_")
        print(f"workdir: {args.workdir}", flush=True)
    os.makedirs(args.workdir, exist_ok=True)
    data_dir = args.data or os.path.join(args.workdir, "Data", "MIND")
    real_data = args.data is not None
    have = os.path.exists(os.path.join(data_dir, "MINDsmall_dev", "behaviors.tsv"))
    if not have and not args.synth:
        real_data = try_download(data_dir)
        if not real_data:
            print("MIND download unavailable (no network). Either pass "
                  "--data <dir> with the tsvs in place, or --synth for the "
                  "synthetic stand-in.", file=sys.stderr)
            sys.exit(2)
    t0 = time.time()
    # the synthetic stand-in (with --synth) is written by prepare itself
    base = fs.prepare(args.workdir, args.synth_args, data_dir=data_dir if real_data else None)
    with open(os.path.join(args.workdir, "prepare.json")) as f:
        times = json.load(f)["wall_seconds"]
    t1 = time.time()
    manifest = checksum_manifest(data_dir)
    times["checksums"] = round(time.time() - t1, 1)
    times["data_step"] = round(time.time() - t0, 1)
    print(f"data step: {times}", flush=True)

    names = [n for n in args.models.split(",") if n]
    cfgs = {n: model_config(base, args.workdir, n) for n in names}
    threads = fs.job_threads(args.jobs)

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        runs = dict(zip(names, pool.map(lambda n: train(
            n, cfgs[n], args.workdir, args.epochs, args.device, threads), names)))
    results = []
    for name in names:
        print(f"=== {name} ===", flush=True)
        results.append(score(name, cfgs[name], runs[name], args.device))
        print(json.dumps(results[-1]), flush=True)
    runs_wall = time.time() - t0
    if args.val_logs:
        os.makedirs(args.val_logs, exist_ok=True)
        for name in names:
            shutil.copy(os.path.join(args.workdir, f"exp_{name}", "val_log.log"),
                        os.path.join(args.val_logs, f"{name}_val_log.log"))

    lines = ["| Model | AUC | MRR | nDCG@5 | nDCG@10 |",
             "| --- | --- | --- | --- | --- |"]
    for r in results:
        lines.append(f"| {r['model']} | {r['AUC']:.4f} | {r['MRR']:.4f} "
                     f"| {r['nDCG@5']:.4f} | {r['nDCG@10']:.4f} |")
    table = "\n".join(lines)
    print(table)

    artifact = {
        "what": "Turnkey MIND parity harness output (reference README.md:91-97 "
                "table shape; per-user grouping per base_model.py:333-492), on the "
                "PyTorch port",
        "data": ("REAL MIND-small" if real_data else
                 f"synthetic stand-in (synth {args.synth_args})"),
        "data_dir": data_dir,
        "checksums": manifest,
        "epochs": args.epochs,
        "results": results,
        "table_markdown": table,
        "device": device,
        "jobs": args.jobs,
        "wall_seconds": {**times, "runs": round(runs_wall, 1)},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
