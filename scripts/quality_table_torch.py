"""The full-scale campaign's results against the reference's scoreboard:
each row's target, its value for every seed, their spread, the best epoch,
the wall minutes and whether it lies inside the tolerance; then each row's
curve, epoch by epoch, beside the reference's own val log.

    python scripts/quality_table_torch.py \\
        --runs artifacts/rankers_fullscale_torch_r16.json \\
               artifacts/rankers_fullscale_torch_r16_seed7.json \\
        --logs artifacts/fullscale_torch_r16/seed42 artifacts/fullscale_torch_r16/seed7 \\
        --cascade artifacts/cascade_eval_torch_r16.json

Imports the port's ``utils/log_analysis`` and the standard library only.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (tag, reference value, tolerance, reference val log): Warm AUC for the
# rankers, best-epoch HR@10 for the DSSM (a floor, not a band)
TARGETS = (
    ("lr", 0.574, 0.010, "artifacts/fullscale_r05/lr_val_log.log"),
    ("fm", 0.7824, 0.005, "artifacts/fullscale_r05/fm_val_log.log"),
    ("deepfm", 0.7835, 0.005, "artifacts/fullscale_r05/deepfm_val_log.log"),
    ("dcn_v2", 0.7802, 0.005, "artifacts/fullscale_r05/dcn_v2_val_log.log"),
    ("deep", 0.7793, 0.005, "artifacts/fullscale_r04/deep_val_log.log"),
    ("widedeep", 0.778, 0.005, "artifacts/fullscale_r04/widedeep_val_log.log"),
    ("dcn", 0.7787, 0.005, "artifacts/fullscale_r04/dcn_val_log.log"),
    ("attention", 0.7796, 0.005, "artifacts/fullscale_r04/attention_val_log.log"),
    ("dssm_aug+logq+ns8", 0.0193, 0.003,
     "artifacts/fullscale_r05/dssm_aug+logq+ns8_val_log.log"),
)
CASCADE = (0.0089, 0.002)


def criterion(data: dict):
    """Warm-Start AUC of a parsed val-log block, or its HR@10."""
    if "Warm Start Users" in data:
        return data["Warm Start Users"]["AUC"]
    return data.get("Retrieval", {}).get("HR@10")


def best_value(res: dict):
    """The same of a campaign result's best epoch."""
    best = res["best"]
    return best["Warm_Start"]["AUC"] if "Warm_Start" in best else best["Retrieval"]["HR@10"]


def main(argv=None) -> dict:
    from news_recsys_tpu_torch.utils.log_analysis import parse_log

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", required=True, help="campaign artifacts, one a seed")
    ap.add_argument("--logs", nargs="+", required=True,
                    help="their --val-logs directories, in the same order")
    ap.add_argument("--cascade", nargs="*", default=[], help="cascade_eval_torch artifacts")
    args = ap.parse_args(argv)

    runs = []
    for path in args.runs:
        with open(path) as f:
            runs.append(json.load(f))
    device = {f"{r['device']['name']}, {r['device']['power_limit']}" for r in runs}
    print(f"device: {', '.join(sorted(device))}; seeds {[r['seed'] for r in runs]}, "
          f"jobs {[r['jobs'] for r in runs]}")
    print("| row | target | tolerance | " + " | ".join(f"seed {r['seed']}" for r in runs)
          + " | spread | best epoch | wall min | inside |")
    print("|---|---|---|" + "---|" * len(runs) + "---|---|---|---|")
    table = {}
    for tag, target, tol, _ in TARGETS:
        rows = [next((x for x in r["results"] if x["model"] == tag), None) for r in runs]
        if not all(rows):
            continue
        vals = [best_value(x) for x in rows]
        inside = [(v >= target - tol) if tag.startswith("dssm") else abs(v - target) <= tol
                  for v in vals]
        table[tag] = {"values": vals, "inside": inside,
                      "best_epoch": [x["best_epoch"] for x in rows],
                      "wall_min": [round(x["wall_seconds"] / 60, 1) for x in rows]}
        band = f">= {target - tol:.4f}" if tag.startswith("dssm") else f"± {tol}"
        print(f"| {tag} | {target} | {band} | " + " | ".join(f"{v:.4f}" for v in vals)
              + f" | {max(vals) - min(vals):.4f} | {table[tag]['best_epoch']} | "
              f"{table[tag]['wall_min']} | {inside} |")
    for path in args.cascade:
        with open(path) as f:
            c = json.load(f)
        ok = abs(c["HR@10_cascade"] - CASCADE[0]) <= CASCADE[1] and (
            c["HR@10_cascade"] < c["HR@10_recall_only"])
        print(f"cascade {path}: recall {c['HR@10_recall_only']}, cascade {c['HR@10_cascade']} "
              f"(target {CASCADE[0]} ± {CASCADE[1]}, below recall), lift {c['lift']}, "
              f"{c['queries']} queries, inside {ok}")
        table[os.path.basename(path)] = {"cascade": c["HR@10_cascade"],
                                         "recall": c["HR@10_recall_only"], "inside": ok}

    print("\ncurves (Warm AUC, or HR@10, by epoch): the reference's log, then each seed's")
    for tag, _, _, ref in TARGETS:
        logs = [os.path.join(d, f"{tag}_val_log.log") for d in args.logs]
        if not all(os.path.exists(p) for p in logs):
            continue
        print(f"{tag}:")
        for label, path in [("reference", os.path.join(REPO, ref))] + list(
                zip([f"seed {r['seed']}" for r in runs], logs)):
            curve = [criterion(e["data"]) for e in parse_log(path)]
            print(f"  {label:>10}: " + " ".join(f"{v:.4f}" for v in curve))
    return table


if __name__ == "__main__":
    main()
