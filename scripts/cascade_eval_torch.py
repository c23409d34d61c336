"""Offline quality of the recall -> rank cascade at MIND scale with the
PyTorch port: the counterpart of ``scripts/cascade_eval.py``. Imports the
port, torch, numpy and PyYAML only.

HR@k of (a) DSSM recall alone and (b) the cascade (DSSM recall of
``--fetch`` candidates, re-scored by the ranker, top-k) over the dev
positives, each one's history from ``dev_behaviors_processed.csv`` excluded.

Usage (a DSSM epoch checkpoint and a ranker run of
``scripts/fullscale_rankers_torch.py``):

    python scripts/cascade_eval_torch.py \\
        --recall-cfg /tmp/fullscale/dssm_aug+logq+ns8.yaml \\
        --recall-ckpt /tmp/fullscale/exp_dssm_aug+logq+ns8/ckpts/epoch_024.pt \\
        --ranker-cfg /tmp/fullscale/dcn.yaml --ranker-ckpt /tmp/fullscale/exp_dcn \\
        --out artifacts/cascade_eval_torch.json
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def dev_queries(cfg, max_queries: int = 0):
    """(query arrays, target item ids, histories) of the dev positives:
    each row's clicked history from ``dev_behaviors_processed.csv``
    (``cli._dev_histories``); at most ``max_queries`` of them, drawn as
    ``scripts/cascade_eval.py`` draws them."""
    from news_recsys_tpu_torch.cli import _dev_histories
    from news_recsys_tpu_torch.data.packed_dataset import PackedDataset

    dev = PackedDataset.open_split(cfg, "dev")
    pos = dev.arrays["label"][:, 0] == 1
    histories = _dev_histories(cfg, pos)
    query = {k: v[pos] for k, v in dev.arrays.items()}
    targets = query["item_id"].astype(np.int64)
    n = len(targets)
    if max_queries and n > max_queries:
        keep = np.random.default_rng(0).choice(n, max_queries, replace=False)
        query = {k: v[keep] for k, v in query.items()}
        targets = targets[keep]
        histories = [histories[i] for i in keep]
    return query, targets, histories


def build(args):
    """(recall, cascade) on ``args.device``."""
    from news_recsys_tpu_torch.cli import _resolve_ckpt
    from news_recsys_tpu_torch.config import load_config
    from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.serving import CascadeRecommender, Recommender
    from news_recsys_tpu_torch.training.checkpoint import load_state, load_weights

    rc_cfg = load_config(args.recall_cfg)
    dssm = load_weights(build_dssm(rc_cfg, device=args.device), load_state(args.recall_ckpt))
    recall = Recommender(rc_cfg, dssm, PackedDataset.open_split(rc_cfg, "item"),
                         device=args.device, backend="device")

    rk_cfg = load_config(args.ranker_cfg)
    ranker = build_ranker(rk_cfg, rk_cfg.name, device=args.device)
    ranker.load_state_dict(load_state(_resolve_ckpt(args.ranker_ckpt))["model"], strict=True)
    casc = CascadeRecommender(recall, rk_cfg, ranker, PackedDataset.open_split(rk_cfg, "item"),
                              fetch=args.fetch)
    return rc_cfg, dssm, recall, casc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recall-cfg", required=True)
    ap.add_argument("--recall-ckpt", required=True,
                    help="the DSSM's weights-only epoch_*.pt")
    ap.add_argument("--ranker-cfg", required=True)
    ap.add_argument("--ranker-ckpt", required=True,
                    help="ranker epoch_*.pt or experiment dir (its newest epoch)")
    ap.add_argument("--fetch", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--max-queries", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    ap.add_argument("--out", default="artifacts/cascade_eval_torch.json")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from scripts.fullscale_rankers_torch import card

    device = card(args.device)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA GPU is visible")
    rc_cfg, dssm, recall, casc = build(args)
    query, targets, histories = dev_queries(rc_cfg, args.max_queries)
    n = len(targets)

    user_cols = [s.name for s in dssm.user_schema.specs] + [
        f"{s.name}_mask" for s in dssm.user_schema.specs if f"{s.name}_mask" in query]
    hits_recall = hits_cascade = 0
    t0 = time.time()
    for lo in range(0, n, args.chunk):
        hi = min(lo + args.chunk, n)
        ub = {c: query[c][lo:hi] for c in user_cols}
        ub["label"] = np.zeros((hi - lo, 1), np.float32)
        h = histories[lo:hi]
        r_ids, _ = recall.recommend(ub, k=args.k, histories=h)
        c_ids, _ = casc.recommend(ub, k=args.k, histories=h)
        for j in range(hi - lo):
            t = int(targets[lo + j])
            hits_recall += t in r_ids[j]
            hits_cascade += t in c_ids[j]
        print(f"{hi}/{n} recall={hits_recall / hi:.5f} "
              f"cascade={hits_cascade / hi:.5f}", flush=True)
    wall = time.time() - t0

    out = {
        "what": "Offline HR@10 of DSSM recall alone vs the full recall->rank cascade (fetch "
                "candidates re-scored by the trained ranker) on the dev positives, on the "
                "PyTorch port",
        "device": device,
        "recall": {"cfg": args.recall_cfg, "ckpt": args.recall_ckpt},
        "ranker": {"cfg": args.ranker_cfg, "ckpt": args.ranker_ckpt},
        "fetch": args.fetch, "k": args.k, "queries": n,
        "wall_seconds": round(wall, 1),
        "HR@10_recall_only": round(hits_recall / n, 5),
        "HR@10_cascade": round(hits_cascade / n, 5),
        "lift": round(hits_cascade / max(hits_recall, 1), 3),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
