"""The readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds a,b,... \
        --control-seeds x,y,z [--seconds 4]

- program: the cell's run on each of ``--seeds`` (a training cell without
  its window: its readings come from the first steps; a serving cell with a
  window of ``--seconds``), each number of ``correct`` as the run judges it;
- control: on each of ``--control-seeds``, the reference put in the
  program's place and computed in the next precision below the
  configuration's (float32 with TF32 off -> TF32), judged against the
  reference in float32;
- fault (training cells): the same with half of each batch left out and
  the mean taken over the rest.

One JSON line a reading; the lower reading of a number is the largest
program reading, the upper the smallest control (or, for a training cell,
fault) reading.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from harness import cli, inputs, judge, program, serving, weights  # noqa: E402
from reference.model import param_specs  # noqa: E402
from reference.train_step import first_steps  # noqa: E402


@contextlib.contextmanager
def tf32():
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _as_program(steps: dict, batches: list, calls: list, bins: int) -> dict:
    """The readings of the reference's ``steps`` on ``batches``, put in the
    program's place."""
    return {"losses": steps["losses"], "change_norms": steps["change_norms"], "feed_rows": 0,
            "grad_norms": steps["grad_norms"], "calls": calls,
            "aucs": [lo for lo, _ in judge.step_aucs(
                steps["logits"], [b["label"] for b in batches], calls, bins, edge=0.0)]}


def training(ctx, control: bool) -> list:
    from traffic import train_epochs

    res = train_epochs.run(ctx, window=False)
    out = [("program", ctx.numbers)]
    if control:
        train, calls = ctx.config["train"], res["prog"]["calls"]
        labels = [b["label"] for b in res["batches"]]
        with tf32():
            low = first_steps(res["params"], ctx.config, res["batches"])
        out.append(("control", judge.training(
            _as_program(low, res["batches"], calls, train["auc_bins"]), res["ref"], labels,
            train)["numbers"]))
        half = [{k: v[: len(v) // 2] for k, v in b.items()} for b in res["batches"]]
        fault = first_steps(res["params"], ctx.config, half)
        out.append(("fault_half_batch", judge.training(
            _as_program(fault, half, calls, train["auc_bins"]), res["ref"], labels,
            train)["numbers"]))
    return out


def serving_control(ctx) -> dict:
    c = ctx.config
    params = weights.draw(param_specs(c["ranker"]) + param_specs(c["recall"], "recall."),
                          ctx.seed, ctx.device)
    items = inputs.items(inputs.World(c, ctx.seed, ctx.params["law"]), c)
    feats, hist = serving.sampled_users(ctx, serving._sample(ctx))
    k = c["serve"]["k"]
    with tf32():
        low = serving.reference(ctx, params, items, feats,
                                torch.zeros((len(hist), k), dtype=torch.long).numpy())
    ref = serving.reference(ctx, params, items, feats, low["ids"].cpu().numpy())
    return judge.serving(low["ids"].cpu().numpy(), low["scores"].double().cpu().numpy(), hist,
                         ref, len(items["item_id"]) - 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    program.start(dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [s for s in controls if s not in seeds]:
        ctx = cli.Context(args.workload, seed, args.seconds, False, dev)
        traffic = ctx.cell["traffic"]
        if traffic == "train_epochs":
            rows = training(ctx, seed in controls)
            if seed not in seeds:
                rows = rows[1:]
        else:
            rows = []
            if seed in seeds:
                serving.run(ctx)
                rows.append(("program", ctx.numbers))
            if seed in controls:
                rows.append(("control", serving_control(ctx)))
        for kind, numbers in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers}), flush=True)
        del ctx
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
