"""Command line of the PyTorch port: ``python -m news_recsys_tpu_torch <command>``.

The JAX package's commands, on the port: ``synth`` (synthetic MIND-format
raw files), ``preprocess`` and ``fe`` (ID maps, exploded behaviors, packed
features: the files the JAX package writes), ``train`` (a ranker, or the
DSSM with a retrieval block every epoch, ``retrieval_eval.json`` and a
serving bundle, from one YAML config, with a checkpoint after every epoch
and ``--resume``), ``predict`` (per-row scores of a split from a
checkpoint; the DSSM's tower embeddings and their cosine), ``itemcf`` (the
non-neural recall baseline, on the host), ``serve`` (a bundle of this
package over HTTP, or the cascade of a recall bundle and a ranker's
checkpoint, its search on the device or the host;
``scripts/export_torch_bundle.py`` converts the JAX package's bundles),
``convert-ckpt`` (a checkpoint between the per-table and arena layouts),
``log`` (the best epoch of a ``val_log.log``) and ``visualize-history`` (an
HTML page of the raw files' user histories).
``scripts/export_torch_checkpoint.py`` converts a JAX ``epoch_*.msgpack``
into this package's ``epoch_*.pt``.

``train``, ``predict`` and ``serve`` run on ``--device`` (default ``cuda``).
A CUDA device that is not there is an error, not a reason to run on the
CPU. ``train`` runs over several processes with ``--coordinator host:port
--num-processes N --process-id i`` (one command a process), or under
``torchrun`` with none of them: each process takes one device (``cuda``:
its local rank's card) and the mesh of the config's ``mesh`` section. A
process group that does not start is an error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from .utils.logging import get_logger

logger = get_logger("cli")

EXPORT_SCRIPT = "scripts/export_torch_checkpoint.py"


def _require_device(device: str) -> None:
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA GPU is visible "
                         "(torch.cuda.is_available() is False); pass --device cpu "
                         "to run with the plain PyTorch ops")


def _load_warm_users(cfg):
    path = os.path.join(cfg.paths.out_basedir, "preprocess", "train_user_ids.json")
    if os.path.exists(path):
        with open(path) as f:
            return set(json.load(f))
    logger.warning(f"train_user_ids.json not found at {path}; all users treated as warm")
    return None


def cmd_synth(args) -> None:
    from .data.synthetic import generate_mind
    generate_mind(args.out, n_news=args.news, n_users=args.users,
                  n_impressions_train=args.train_impressions,
                  n_impressions_dev=args.dev_impressions, seed=args.seed,
                  adversarial=args.adversarial)
    print(f"Synthetic MIND written to {args.out}")


def cmd_preprocess(args) -> None:
    from .config import load_config
    from .data.preprocess import run_preprocess
    cfg = load_config(args.config)
    run_preprocess(cfg.paths.data_path, cfg.paths.out_basedir)


def cmd_fe(args) -> None:
    from .config import load_config
    from .data.feature_extraction import FeatureExtractionPipeline
    cfg = load_config(args.config)
    FeatureExtractionPipeline(cfg, write_text=args.text, limit_rows=args.limit_rows).run()


def cmd_train(args) -> None:
    several = (args.coordinator or args.num_processes is not None
               or args.process_id is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    _require_device(args.device)
    if not several:
        _train(args)
        return
    import torch.distributed as dist

    from .parallel.distributed import initialize_distributed
    args.device = str(initialize_distributed(args.coordinator, args.num_processes,
                                             args.process_id, device=args.device))
    try:
        _train(args)
    finally:
        dist.destroy_process_group()


def _train(args) -> None:
    from .config import load_config
    from .data.packed_dataset import PackedDataset
    from .models.rankers import build_ranker
    from .training.trainer import Trainer

    cfg = load_config(args.config)
    name = args.model or cfg.name
    train_ds = PackedDataset.open_split(cfg, "train")
    if name == "dssm":
        _train_dssm(cfg, args, train_ds)
        return
    dev_ds = PackedDataset.open_split(cfg, "dev")
    warm = _load_warm_users(cfg)
    model = build_ranker(cfg, name, seed=cfg.train_hparams.seed, device=args.device)

    # rank_cfg.random_neg_per_positive: mix label-0 rows pairing each
    # positive's user with uniform corpus items, so the ranker can re-score
    # retrieval candidates in the cascade (data/hist_pairs.py). Dev is untouched.
    rneg = int((cfg.extra("rank_cfg", {}) or {}).get("random_neg_per_positive", 0))
    if rneg > 0:
        from .data.hist_pairs import concat_datasets, random_negative_rows
        neg = random_negative_rows(cfg, train_ds, PackedDataset.open_split(cfg, "item"),
                                   per_positive=rneg, seed=cfg.train_hparams.seed)
        train_ds = concat_datasets(train_ds, neg)
        logger.info(f"Rank train set: +{len(neg)} random corpus negatives "
                    f"({rneg} per positive)")

    trainer = Trainer(cfg, model, workdir=args.workdir, device=args.device)
    logger.info(f"Training '{name}' on {args.device} -> {trainer.log_dir}"
                + (f" ({trainer.mesh})" if trainer.mesh is not None else ""))
    trainer.fit(train_ds, dev_ds, warm_user_set=warm, max_epochs=args.epochs,
                resume=args.resume)
    print(f"Experiment dir: {trainer.log_dir}")


def _train_dssm(cfg, args, train_ds) -> None:
    """The DSSM from ``cfg`` on ``args.device``: per-epoch retrieval
    validation on the dev positives (histories removed), then
    ``retrieval_eval.json`` and the serving bundle ``<log_dir>/bundle``."""
    from .data.packed_dataset import PackedDataset
    from .models.dssm import build_dssm
    from .serving import Recommender
    from .training.retrieval import DSSMTrainer, evaluate_retrieval

    model = build_dssm(cfg, seed=cfg.train_hparams.seed, device=args.device)
    trainer = DSSMTrainer(cfg, model, workdir=args.workdir, device=args.device)
    logger.info(f"Training DSSM on {args.device} -> {trainer.log_dir}")
    item_ds = PackedDataset.open_split(cfg, "item")
    dev_ds = PackedDataset.open_split(cfg, "dev")

    # dssm_cfg.hist_augment: leave-one-out history pairs as extra InfoNCE
    # positives (data/hist_pairs.py); it implies training on click
    # positives only, as train_on: positives does (the loss masks label-0
    # rows anyway)
    dcfg = cfg.extra("dssm_cfg", {}) or {}
    if dcfg.get("hist_augment", False) or dcfg.get("train_on", "all") == "positives":
        from .data.hist_pairs import concat_datasets, hist_augmented_pairs, positives_only
        base = positives_only(train_ds)
        logger.info(f"DSSM train set: {len(base)} click positives "
                    f"(of {len(train_ds)} exploded rows)")
        if dcfg.get("hist_augment", False):
            aug = hist_augmented_pairs(cfg, train_ds, item_ds)
            base = concat_datasets(base, aug)
            logger.info(f"DSSM train set: +{len(aug)} leave-one-out history pairs")
        train_ds = base
    pos = dev_ds.arrays["label"][:, 0] == 1
    query = PackedDataset({k: v[pos] for k, v in dev_ds.arrays.items()})
    histories = _dev_histories(cfg, pos)
    trainer.set_eval_data(item_ds, histories=histories, k=10)

    trainer.fit(train_ds, dev_ds=query, max_epochs=args.epochs, resume=args.resume)

    res = evaluate_retrieval(trainer, item_ds, query, target_item_ids=query.arrays["item_id"],
                             histories=histories, k=10)
    if trainer.mesh is not None:          # the bundle holds whole tables: gather the shards
        from .parallel.sharded_embedding import full_state_dict
        weights = full_state_dict(model, trainer.mesh)
        if not trainer.is_main:
            return
        model = build_dssm(cfg, seed=cfg.train_hparams.seed, device=args.device)
        model.load_state_dict(weights)
    print(json.dumps(res))
    with open(os.path.join(trainer.log_dir, "retrieval_eval.json"), "w") as f:
        json.dump(res, f)
    bundle = Recommender(cfg, model, item_ds, device=args.device).save(
        os.path.join(trainer.log_dir, "bundle"))
    print(f"Serving bundle: {bundle}")


def _dev_histories(cfg, row_mask) -> list:
    """Per-row clicked-history id lists of ``dev_behaviors_processed.csv``,
    the rows where ``row_mask`` holds."""
    from .data.feature_extraction import read_behaviors
    path = os.path.join(cfg.paths.out_basedir, "preprocess", "dev_behaviors_processed.csv")
    return [_history_ids(h) for h, m in zip(read_behaviors(path)["history"], row_mask) if m]


def _history_ids(history: str) -> list:
    return [int(x) for x in history.split(" ")] if history else []


def _refuse_msgpack(path: str) -> None:
    raise SystemExit(f"{path}: a checkpoint of the JAX package (flax msgpack); convert it "
                     f"with {EXPORT_SCRIPT} (where JAX is installed) and pass the .pt it writes")


def _resolve_ckpt(ckpt: str) -> str:
    """A checkpoint file, or an experiment dir's newest ``epoch_*.pt``."""
    if os.path.isdir(ckpt):
        cands = sorted(glob.glob(os.path.join(ckpt, "ckpts", "epoch_*.pt"))
                       or glob.glob(os.path.join(ckpt, "epoch_*.pt")))
        if cands:
            return cands[-1]
        if (glob.glob(os.path.join(ckpt, "ckpts", "epoch_*.msgpack"))
                or glob.glob(os.path.join(ckpt, "epoch_*.msgpack"))):
            _refuse_msgpack(ckpt)
        raise FileNotFoundError(f"No epoch_*.pt under {ckpt}")
    if ckpt.endswith(".msgpack"):
        _refuse_msgpack(ckpt)
    return ckpt


def _row_decoder(cfg, ds, decode: bool):
    """(row-index -> feature dict) with optional FeatureIdMapper decode."""
    import numpy as np

    mapper = None
    if decode:
        from .utils.feature_id_mapper import FeatureIdMapper
        mapper = FeatureIdMapper.from_dir(
            os.path.join(cfg.paths.out_basedir, "extractored_feature"))
    feat_names = [k for k in ds.arrays if k != "label" and not k.endswith("_mask")]

    def row(i):
        out = {}
        for k in feat_names:
            v = ds.arrays[k][i]
            val = v.tolist() if getattr(v, "ndim", 0) else (
                float(v) if isinstance(v, (np.floating, float)) else int(v))
            if mapper is not None and np.ndim(v) == 0:
                raw = mapper.get_real_val(k, int(v))
                if raw is not None:
                    val = raw
            out[k] = val
        out["label"] = ds.arrays["label"][i].tolist()
        return out

    return row


def cmd_predict(args) -> None:
    """Score a feature file with a trained checkpoint: checkpoint + split
    (or npz) -> per-row sigmoid scores (jsonl), with optional raw-value
    decode, in the JAX package's format."""
    import tempfile

    _require_device(args.device)
    from .config import load_config
    from .data.packed_dataset import PackedDataset
    from .models.rankers import build_ranker
    from .training.trainer import Trainer

    cfg = load_config(args.config)
    name = args.model or cfg.name
    ckpt = _resolve_ckpt(args.checkpoint)
    ds = (PackedDataset.load(args.input) if args.input
          else PackedDataset.open_split(cfg, args.split))
    if name == "dssm":
        _predict_dssm(cfg, args, ds, ckpt)
        return
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, name, device=args.device), workdir=tmp,
                          device=args.device)
        trainer.load_checkpoint(trainer.init_state(), ckpt)
        scores = trainer.predict(ds)

    row = _row_decoder(cfg, ds, args.decode)
    out_path = args.output or "predictions.jsonl"
    with open(out_path, "w") as f:
        for i in range(len(ds)):
            rec = row(i)
            rec["score"] = float(scores[i])
            f.write(json.dumps(rec) + "\n")
    print(f"Wrote {len(ds)} scored rows -> {out_path}")


def _predict_dssm(cfg, args, ds, ckpt: str) -> None:
    """Per-row L2-normalised user and item tower embeddings of ``ds`` and
    their cosine, from a weights-only DSSM checkpoint, in the JAX package's
    format (embeddings rounded to 6 places)."""
    import tempfile

    from .models.dssm import build_dssm
    from .training.retrieval import DSSMTrainer

    with tempfile.TemporaryDirectory() as tmp:
        trainer = DSSMTrainer(cfg, build_dssm(cfg, device=args.device), workdir=tmp,
                              device=args.device)
        trainer.load_params(trainer.init_state(), ckpt)
        u, i = trainer.encode_users(ds), trainer.encode_item_corpus(ds)
    scores = (u * i).sum(axis=1)

    row = _row_decoder(cfg, ds, args.decode)
    out_path = args.output or "predictions.jsonl"
    with open(out_path, "w") as f:
        for k in range(len(ds)):
            rec = row(k)
            rec["user_embedding"] = [round(float(x), 6) for x in u[k]]
            rec["item_embedding"] = [round(float(x), 6) for x in i[k]]
            rec["score"] = float(scores[k])
            f.write(json.dumps(rec) + "\n")
    print(f"Wrote {len(ds)} scored rows (user/item embeddings + cosine) -> {out_path}")


def cmd_itemcf(args) -> None:
    """The non-neural ItemCF recall baseline, on the host: fit on the train
    behaviors, HR@k on (at most ``--max-queries``) dev positives, their
    history from the row itself; writes ``<out_basedir>/itemcf/metrics.json``."""
    import time

    import numpy as np

    from .config import load_config
    from .data.feature_extraction import read_behaviors
    from .models.itemcf import ItemCF, interactions_from_behaviors

    cfg = load_config(args.config)
    pre = os.path.join(cfg.paths.out_basedir, "preprocess")
    t0 = time.time()
    train = read_behaviors(os.path.join(pre, "train_behaviors_processed.csv"))
    dev = read_behaviors(os.path.join(pre, "dev_behaviors_processed.csv"))
    uids, items = interactions_from_behaviors(train["history"], train["user_id"],
                                              train["item_id"], train["label"])
    logger.info(f"ItemCF: {uids.size} train interactions "
                f"({len(train['label'])} behaviors rows) in {time.time() - t0:.1f}s")

    t0 = time.time()
    cf = ItemCF(max_history=args.max_history,
                max_neighbors=args.neighbors).fit_pairs(uids, items)
    fit_s = time.time() - t0
    logger.info(f"ItemCF fit in {fit_s:.1f}s")

    # eval queries: dev positives, history from the row itself; the draw is
    # DataFrame.sample(n=, random_state=0)'s (pandas/core/sample.py)
    pos = np.flatnonzero(dev["label"] == 1)
    if args.max_queries and len(pos) > args.max_queries:
        pos = pos[np.random.RandomState(0).choice(len(pos), size=args.max_queries,
                                                  replace=False)]
    targets = dev["item_id"][pos]
    histories = [_history_ids(h) for h in dev["history"][pos]]

    t0 = time.time()
    ks = sorted({int(k) for k in args.k.split(",")})
    topk = cf.recall_batch(histories, max(ks))
    metrics = {f"HR@{k}": float((topk[:, :k] == targets[:, None]).any(axis=1).mean())
               for k in ks}
    eval_s = time.time() - t0
    out = {"model": "itemcf", "queries": len(histories), "fit_seconds": round(fit_s, 2),
           "eval_seconds": round(eval_s, 2), "neighbors": args.neighbors,
           "max_history": args.max_history, **{k: round(v, 5) for k, v in metrics.items()}}
    out_dir = os.path.join(cfg.paths.out_basedir, "itemcf")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


def cmd_serve(args) -> None:
    _require_device(args.device)
    from .serving import CascadeRecommender, Recommender, build_cascade, serve_http

    with open(os.path.join(args.bundle, "meta.json")) as f:
        is_cascade = json.load(f).get("kind") == "cascade"
    if args.ranker_ckpt:
        if not args.ranker_config:
            raise SystemExit("--ranker-ckpt requires --ranker-config")
        rec = build_cascade(args.bundle, args.ranker_ckpt, args.ranker_config,
                            fetch=args.fetch or 100, backend=args.backend, device=args.device)
    elif is_cascade:
        rec = CascadeRecommender.load(args.bundle, device=args.device,
                                      fetch=args.fetch or None, backend=args.backend)
    else:
        rec = Recommender.load(args.bundle, device=args.device, backend=args.backend)
    server = serve_http(rec, host=args.host, port=args.port)
    print(f"Serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def cmd_convert_ckpt(args) -> None:
    """Convert an ``epoch_*.pt`` checkpoint between the per-table and arena
    embedding layouts (``embeddings.arena_tables``)."""
    if args.input.endswith(".msgpack"):
        _refuse_msgpack(args.input)
    from .config import load_config
    from .training.arena_convert import convert_checkpoint
    convert_checkpoint(load_config(args.config), args.input, args.output,
                       to_arena=args.to == "arena")
    print(f"Converted {args.input} -> {args.output} ({args.to} layout)")


def cmd_log(args) -> None:
    from .utils.log_analysis import format_best_epoch, parse_log
    target = args.target
    if os.path.isdir(target):
        target = os.path.join(target, "val_log.log")
    elif not os.path.exists(target):
        # a model name: the newest experiments/<model>_20* dir
        dirs = sorted(glob.glob(f"experiments/{target}_20*"), reverse=True)
        if not dirs:
            print(f"No experiment dirs match experiments/{target}_20*")
            return
        target = os.path.join(dirs[0], "val_log.log")
    print(f"Parsing: {target}")
    model_name = os.path.basename(os.path.dirname(os.path.abspath(target))).split("_")[0]
    print(format_best_epoch(parse_log(target), model_name))


def cmd_visualize_history(args) -> None:
    from .utils.visualize_history import generate_html_report
    generate_html_report(args.news, args.behaviors, args.output, args.max_users)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="news_recsys_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("synth", help="generate synthetic MIND-format data")
    s.add_argument("--out", required=True)
    s.add_argument("--news", type=int, default=2000)
    s.add_argument("--users", type=int, default=1000)
    s.add_argument("--train-impressions", type=int, default=5000)
    s.add_argument("--dev-impressions", type=int, default=1500)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--adversarial", action="store_true",
                   help="inject real-MIND text quirks (embedded quotes, empty "
                        "abstracts, cross-split divergent duplicates, empty histories)")
    s.set_defaults(fn=cmd_synth)

    s = sub.add_parser("preprocess", help="build ID maps + exploded behaviors")
    s.add_argument("-c", "--config", required=True)
    s.set_defaults(fn=cmd_preprocess)

    s = sub.add_parser("fe", help="feature extraction")
    s.add_argument("-c", "--config", required=True)
    s.add_argument("--text", action="store_true", help="also write reference text format")
    s.add_argument("--limit-rows", type=int, default=0,
                   help="sample: only the first N exploded rows per split, cut on an "
                        "impression boundary (0 = full)")
    s.set_defaults(fn=cmd_fe)

    s = sub.add_parser("train", help="train a ranker or the DSSM")
    s.add_argument("-c", "--config", required=True)
    s.add_argument("-m", "--model", default=None, help="override config model name")
    s.add_argument("--workdir", default=None)
    s.add_argument("--epochs", type=int, default=None)
    s.add_argument("--resume", action="store_true",
                   help="resume from the newest step checkpoint in workdir")
    s.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    s.add_argument("--coordinator", default=None,
                   help="multi-process training: the process group's address host:port "
                        "(run one process per device; omit under torchrun)")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("predict", help="score a feature file with a trained ranker "
                                       "(-m dssm: tower embeddings and their cosine)")
    s.add_argument("-c", "--config", required=True)
    s.add_argument("-m", "--model", default=None, help="override config model name")
    s.add_argument("--checkpoint", required=True,
                   help="epoch_*.pt file or experiment dir (newest epoch used)")
    s.add_argument("--split", default="dev", help="feature split to score (default dev)")
    s.add_argument("--input", default=None,
                   help="explicit .npz feature file instead of --split")
    s.add_argument("--output", default=None, help="output jsonl (default predictions.jsonl)")
    s.add_argument("--decode", action="store_true",
                   help="decode ids back to raw values via FeatureIdMapper")
    s.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    s.add_argument("--no-mesh", action="store_true",
                   help="accepted as the JAX package takes it; predict runs in one process")
    s.set_defaults(fn=cmd_predict)

    s = sub.add_parser("itemcf", help="ItemCF recall baseline: fit train, HR@k on dev "
                                      "(on the host)")
    s.add_argument("-c", "--config", required=True)
    s.add_argument("--neighbors", type=int, default=200, help="per-item similarity prune")
    s.add_argument("--max-history", type=int, default=200)
    s.add_argument("--max-queries", type=int, default=50000,
                   help="subsample dev positives (0 = all)")
    s.add_argument("--k", default="10,50", help="comma-separated HR cutoffs")
    s.set_defaults(fn=cmd_itemcf)

    s = sub.add_parser("serve", help="serve a recall or cascade bundle over HTTP")
    s.add_argument("--bundle", required=True,
                   help="bundle directory of this package: a recall bundle (train of the "
                        "DSSM writes one) or a cascade bundle")
    s.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8321)
    s.add_argument("--backend", default="auto", choices=["auto", "device", "host"],
                   help="recall search on the device or on the host (auto: the device on "
                        "a card, the host on the CPU)")
    s.add_argument("--ranker-ckpt", default=None,
                   help="ranker epoch_*.pt or experiment dir: serve the recall bundle's "
                        "recall -> rank cascade with this ranker")
    s.add_argument("--ranker-config", default=None,
                   help="the ranker's YAML config (required with --ranker-ckpt)")
    s.add_argument("--fetch", type=int, default=0,
                   help="cascade candidates per user (0: the bundle's own; 100 with "
                        "--ranker-ckpt)")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("convert-ckpt", help="convert a checkpoint between per-table and "
                                            "arena embedding layouts")
    s.add_argument("-c", "--config", required=True)
    s.add_argument("--input", required=True, help="source epoch_*.pt")
    s.add_argument("--output", required=True, help="destination .pt")
    s.add_argument("--to", required=True, choices=["arena", "per-table"], help="target layout")
    s.set_defaults(fn=cmd_convert_ckpt)

    s = sub.add_parser("log", help="best-epoch report from val_log.log")
    s.add_argument("target", help="log file, experiment dir, or model name")
    s.set_defaults(fn=cmd_log)

    s = sub.add_parser("visualize-history", help="HTML user-history report")
    s.add_argument("--news", required=True)
    s.add_argument("--behaviors", required=True)
    s.add_argument("--output", default="user_history_report.html")
    s.add_argument("--max-users", type=int, default=200)
    s.set_defaults(fn=cmd_visualize_history)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
