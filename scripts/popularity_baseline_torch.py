"""Non-personalised popularity baseline for the retrieval scoreboard, on the
PyTorch port: the port's counterpart of ``scripts/popularity_baseline.py``.
Imports the port, torch and numpy only.

Recommends the globally most-clicked training items, minus each query's
history: the floor any learned retriever must beat. A query is a dev
positive; it is a hit at k when its item is among the first k items of the
popularity order that are not in its history.

    python scripts/popularity_baseline_torch.py --pre <workdir>/tmp/preprocess \\
        --out artifacts/popularity_baseline_torch.json

The two processed behaviour files are read with the port's
``data/preprocess.py::read_tsv`` (``quoting=3`` as pandas reads them). The
order is the original's ``value_counts()``: by clicks, most first, and among
items of equal clicks by their first click in the train file (pandas 3
counts in a hash table that keeps the order of first appearance and then
sorts the counts with a stable sort). The counting and the hits run on
``--device`` (``cuda`` by default; with no card that is an error).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

COLS = ["impression_id", "user_id", "time", "history", "item_id", "label"]
HISTORY, ITEM, LABEL = (COLS.index(c) for c in ("history", "item_id", "label"))
HEAD_SLACK = 50        # the order is cut at the largest k + 50, as in the original


def read_rows(path: str, history: bool) -> tuple:
    """(item ids, labels[, histories]) of a processed behaviour file."""
    from news_recsys_tpu_torch.data.preprocess import read_tsv

    cols = [ITEM, LABEL] + ([HISTORY] if history else [])
    rows = read_tsv(path, len(COLS), usecols=cols)
    items = np.array([int(r[0]) for r in rows], np.int64)
    labels = np.array([int(r[1]) for r in rows], np.int64)
    if not history:
        return items, labels
    return items, labels, [r[2] or "" for r in rows]


def popularity_order(items: torch.Tensor, n: int) -> torch.Tensor:
    """The distinct ids of ``items`` by count, most first, ties by first
    appearance (``Series.value_counts()``)."""
    counts = torch.bincount(items, minlength=n)
    first = torch.full((n,), len(items), dtype=torch.int64, device=items.device)
    first.scatter_reduce_(0, items, torch.arange(len(items), device=items.device), "amin")
    order = torch.argsort(first, stable=True)
    order = order[torch.argsort(counts[order], descending=True, stable=True)]
    return order[: int((counts > 0).sum())]


def hit_rates(head: torch.Tensor, targets: torch.Tensor, histories: list, ks: list,
              n: int) -> dict:
    """HR@k of each k: a target counts where it is among the first k items of
    ``head`` outside its query's history."""
    dev = head.device
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slot[head] = torch.arange(len(head), device=dev)
    lengths = torch.tensor([len(h) for h in histories], dtype=torch.int64)
    flat = torch.tensor([i for h in histories for i in h], dtype=torch.int64).to(dev)
    query = torch.repeat_interleave(torch.arange(len(histories)), lengths).to(dev)
    seen = torch.zeros((len(histories), len(head) + 1), dtype=torch.bool, device=dev)
    seen[query, slot[flat]] = True                      # slot -1: the spare last column
    seen = seen[:, :-1]
    at = slot[targets]
    where = at.clamp(min=0)
    rows = torch.arange(len(targets), device=dev)
    # the target's place among the head's items outside the history
    place = where - torch.cumsum(seen, dim=1)[rows, where] + seen[rows, where].long()
    kept = (at >= 0) & ~seen[rows, where]
    return {f"HR@{k}": round(int((kept & (place < k)).sum()) / len(targets), 5) for k in ks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pre", required=True,
                    help="the processed files' dir: <mind_parity_torch.py's --workdir>/tmp/preprocess")
    ap.add_argument("--out", default="artifacts/popularity_baseline_torch.json")
    ap.add_argument("--k", default="10,50")
    ap.add_argument("--device", default="cuda", help="torch device: cuda or cpu")
    args = ap.parse_args(argv)
    from news_recsys_tpu_torch.cli import _require_device

    _require_device(args.device)
    dev = torch.device(args.device)

    train_items, train_labels = read_rows(
        os.path.join(args.pre, "train_behaviors_processed.csv"), history=False)
    dev_items, dev_labels, dev_hist = read_rows(
        os.path.join(args.pre, "dev_behaviors_processed.csv"), history=True)
    pos = dev_labels == 1
    targets = dev_items[pos]
    histories = [[int(x) for x in s.split(" ")] if s else []
                 for s, p in zip(dev_hist, pos) if p]
    n = 1 + max([int(train_items.max(initial=0)), int(targets.max(initial=0))]
                + [max(h) for h in histories if h])

    ks = sorted(int(k) for k in args.k.split(","))
    clicked = torch.from_numpy(train_items[train_labels == 1]).to(dev)
    head = popularity_order(clicked, n)[: max(ks) + HEAD_SLACK]
    metrics = hit_rates(head, torch.from_numpy(targets).to(dev), histories, ks, n)

    out = {
        "what": "Global click-popularity top-k recall baseline (history "
                "dedup per query) on the fullscale synthetic benchmark",
        "queries": int(len(targets)),
        "comparison": {"itemcf_HR@10": 0.00578,
                       "dssm_r04_HR@10": 0.0014,
                       "source": "artifacts/itemcf_quality_r04.json, "
                                 "rankers_fullscale_r04.json"},
        **metrics,
        "device": card(args.device),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


def card(device: str) -> dict:
    """``scripts/fullscale_rankers_torch.py::card``: the card's ``nvidia-smi``
    name and power limit, or the name ``cpu``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_fullscale_rankers_torch",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "fullscale_rankers_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.card(device)


if __name__ == "__main__":
    main()
