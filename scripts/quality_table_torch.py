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
from typing import NamedTuple, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANDOM_HR10 = 0.000153     # a uniform draw's HR@10 (artifacts/itemcf_quality_r04.json)
COLLAPSE_MAX = 0.004       # below half of popularity's 0.00828 (popularity_baseline_r05.json)


class Row(NamedTuple):
    """A scoreboard row: Warm AUC for the rankers, best-epoch HR@10 for the
    DSSM. ``rule``: ``band`` (within ``tol`` of ``target``), ``floor`` (at
    least ``target - tol``) or ``collapse`` (above ``RANDOM_HR10`` and at
    most ``COLLAPSE_MAX``: a DSSM without logQ, as the reference's own
    collapse). ``log``: the reference's val log, where it kept one;
    ``source``: the reference artifact that holds ``target``."""

    tag: str
    target: float
    tol: Optional[float]
    rule: str
    log: Optional[str]
    source: str


R04, R05 = "artifacts/fullscale_r04", "artifacts/fullscale_r05"
TARGETS = (
    # the base scoreboard
    Row("lr", 0.574, 0.010, "band", f"{R05}/lr_val_log.log", "rankers_fullscale_r05.json"),
    Row("fm", 0.7824, 0.005, "band", f"{R05}/fm_val_log.log", "rankers_fullscale_r05.json"),
    Row("deepfm", 0.7835, 0.005, "band", f"{R05}/deepfm_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dcn_v2", 0.7802, 0.005, "band", f"{R05}/dcn_v2_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("deep", 0.7793, 0.005, "band", f"{R04}/deep_val_log.log", "rankers_fullscale_r04.json"),
    Row("widedeep", 0.778, 0.005, "band", f"{R04}/widedeep_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("dcn", 0.7787, 0.005, "band", f"{R04}/dcn_val_log.log", "rankers_fullscale_r04.json"),
    Row("attention", 0.7796, 0.005, "band", f"{R04}/attention_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("dssm_aug+logq+ns8", 0.0193, 0.003, "floor", f"{R05}/dssm_aug+logq+ns8_val_log.log",
        "rankers_fullscale_r05_sweep.json"),
    # the variant rows: large batches, bf16, AdamW, random negatives, the DSSM's ablations
    Row("dcn_b8192", 0.7774, 0.005, "band", f"{R04}/dcn_b8192_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("dcn_b8192+bf16", 0.7781, 0.005, "band", f"{R05}/dcn_b8192+bf16_val_log.log",
        "rankers_fullscale_r05_bf16.json"),
    Row("attention_b2048", 0.7795, 0.005, "band", f"{R04}/attention_b2048_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("lr_adamw", 0.5663, 0.010, "band", f"{R05}/lr_adamw_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("fm_adamw", 0.782, 0.005, "band", f"{R05}/fm_adamw_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dcn_rneg4", 0.7774, 0.005, "band", None, "rankers_fullscale_r05_rneg.json"),
    Row("attention_rneg4", 0.7779, 0.005, "band", None, "rankers_fullscale_r05_rneg_att.json"),
    Row("dssm_aug+logq+adamw", 0.019, 0.003, "band", f"{R05}/dssm_aug+logq+adamw_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dssm_aug+logq", 0.0189, 0.003, "band", f"{R05}/dssm_aug+logq_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dssm_logq", 0.0164, 0.003, "band", f"{R05}/dssm_logq_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dssm_aug+logq+temp0.05", 0.0184, 0.003, "band",
        f"{R05}/dssm_aug+logq+temp0.05_val_log.log", "rankers_fullscale_r05.json"),
    Row("dssm", 0.0014, None, "collapse", f"{R04}/dssm_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("dssm_adamw", 0.0013, None, "collapse", f"{R04}/dssm_adamw_val_log.log",
        "rankers_fullscale_r04.json"),
    Row("dssm_aug", 0.0016, None, "collapse", f"{R05}/dssm_aug_val_log.log",
        "rankers_fullscale_r05.json"),
    Row("dssm_aug+adamw", 0.0012, None, "collapse", f"{R05}/dssm_aug+adamw_val_log.log",
        "rankers_fullscale_r05.json"),
)
# each cascade's ranker (its config's name): the reference's HR@10 and the band
# (artifacts/cascade_disposition_r05.json)
CASCADES = {"dcn": (0.0089, 0.002), "dcn_rneg4": (0.0102, 0.002),
            "attention_rneg4": (0.00956, 0.002)}
ITEMCF = {"HR@10": (0.00578, 0.0001), "HR@50": (0.01706, 0.0001)}   # itemcf_quality_r04.json
ITEMCF_QUERIES = 35992


def inside(row: Row, value: float) -> bool:
    if row.rule == "band":
        return abs(value - row.target) <= row.tol
    if row.rule == "floor":
        return value >= row.target - row.tol
    return RANDOM_HR10 < value <= COLLAPSE_MAX


def band(row: Row) -> str:
    if row.rule == "band":
        return f"± {row.tol}"
    if row.rule == "floor":
        return f">= {row.target - row.tol:.4f}"
    return f"({RANDOM_HR10}, {COLLAPSE_MAX}]"


def criterion(data: dict):
    """Warm-Start AUC of a parsed val-log block, or its HR@10."""
    if "Warm Start Users" in data:
        return data["Warm Start Users"]["AUC"]
    return data.get("Retrieval", {}).get("HR@10")


def best_value(res: dict):
    """The same of a campaign result's best epoch."""
    best = res["best"]
    return best["Warm_Start"]["AUC"] if "Warm_Start" in best else best["Retrieval"]["HR@10"]


def cascade_ranker(c: dict) -> str:
    """The tag of a cascade artifact's ranker: its config file's name."""
    return os.path.splitext(os.path.basename(c["ranker"]["cfg"]))[0]


def main(argv=None) -> dict:
    from news_recsys_tpu_torch.utils.log_analysis import parse_log

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", required=True,
                    help="campaign artifacts; those of one seed are read as one")
    ap.add_argument("--logs", nargs="+", required=True,
                    help="their --val-logs directories, in the same order")
    ap.add_argument("--cascade", nargs="*", default=[], help="cascade_eval_torch artifacts")
    ap.add_argument("--itemcf", default=None, help="the campaign's itemcf artifact")
    args = ap.parse_args(argv)

    seeds, results, logs, devices, jobs = [], {}, {}, set(), []
    for path, log_dir in zip(args.runs, args.logs, strict=True):
        with open(path) as f:
            run = json.load(f)
        if run["seed"] not in seeds:
            seeds.append(run["seed"])
        for res in run["results"]:
            results[(run["seed"], res["model"])] = res
        if log_dir not in logs.setdefault(run["seed"], []):
            logs[run["seed"]].append(log_dir)
        devices.add(f"{run['device']['name']}, {run['device']['power_limit']}")
        jobs.append(run["jobs"])
    print(f"device: {', '.join(sorted(devices))}; seeds {seeds}, jobs {jobs}")
    print("| row | target | tolerance | " + " | ".join(f"seed {s}" for s in seeds)
          + " | spread | best epoch | wall min | inside |")
    print("|---|---|---|" + "---|" * len(seeds) + "---|---|---|---|")
    table = {}
    for row in TARGETS:
        have = [s for s in seeds if (s, row.tag) in results]
        if not have:
            continue
        rows = [results[(s, row.tag)] for s in have]
        vals = [best_value(x) for x in rows]
        table[row.tag] = {"seeds": have, "values": vals,
                          "inside": [inside(row, v) for v in vals],
                          "best_epoch": [x["best_epoch"] for x in rows],
                          "wall_min": [round(x["wall_seconds"] / 60, 1) for x in rows]}
        cells = [f"{best_value(results[(s, row.tag)]):.4f}"
                 if s in have else "—" for s in seeds]
        print(f"| {row.tag} | {row.target} | {band(row)} | " + " | ".join(cells)
              + f" | {max(vals) - min(vals):.4f} | {table[row.tag]['best_epoch']} | "
              f"{table[row.tag]['wall_min']} | {table[row.tag]['inside']} |")
    for path in args.cascade:
        with open(path) as f:
            c = json.load(f)
        ranker = cascade_ranker(c)
        target, tol = CASCADES[ranker]
        ok = abs(c["HR@10_cascade"] - target) <= tol and (
            c["HR@10_cascade"] < c["HR@10_recall_only"])
        print(f"cascade {path} ({ranker}): recall {c['HR@10_recall_only']}, cascade "
              f"{c['HR@10_cascade']} (target {target} ± {tol}, below recall), lift {c['lift']}, "
              f"{c['queries']} queries, inside {ok}")
        table[os.path.basename(path)] = {"ranker": ranker, "cascade": c["HR@10_cascade"],
                                         "recall": c["HR@10_recall_only"], "inside": ok}
    if args.itemcf:
        with open(args.itemcf) as f:
            cf = json.load(f)
        ok = cf["queries"] == ITEMCF_QUERIES and all(
            abs(cf[k] - want) <= tol for k, (want, tol) in ITEMCF.items())
        print(f"itemcf {args.itemcf}: " + ", ".join(
            f"{k} {cf[k]} (target {want} ± {tol})" for k, (want, tol) in ITEMCF.items())
            + f", {cf['queries']} queries, inside {ok}")
        table["itemcf"] = {k: cf[k] for k in ITEMCF} | {"queries": cf["queries"], "inside": ok}

    print("\ncurves (Warm AUC, or HR@10, by epoch): the reference's log, then each seed's")
    for row in TARGETS:
        curves = [(f"seed {s}", p) for s in seeds for p in
                  [os.path.join(d, f"{row.tag}_val_log.log") for d in logs[s]]
                  if os.path.exists(p)]
        if not curves:
            continue
        print(f"{row.tag}:")
        if row.log:
            curves.insert(0, ("reference", os.path.join(REPO, row.log)))
        for label, path in curves:
            curve = [criterion(e["data"]) for e in parse_log(path)]
            print(f"  {label:>10}: " + " ".join(f"{v:.4f}" for v in curve))
    return table


if __name__ == "__main__":
    main()
