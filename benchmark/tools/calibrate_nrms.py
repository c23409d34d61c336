"""The readings that ``nrms.train-b64``'s limits are set from, on the card
at the cell's own size, many seeds in one process:

    python3 benchmark/tools/calibrate_nrms.py --seeds a,b,... \
        --control-seeds x,y,z [--fault-seeds u,v]

- program: the cell's set-up and judgement on each of ``--seeds`` (its
  readings come from the first steps; no window);
- control: on each of ``--control-seeds``, the reference put in the
  program's place on the same batches and computed in the next precision
  below the configuration's (float32 with TF32 off -> TF32), judged
  against the reference in float32;
- fault (``--fault-seeds``, default the control seeds): the program with
  half of each history's clicks left unencoded (the later half of each
  row's real slots read as padding).

One JSON line a reading; the lower reading of a number is the largest
program reading, the upper the smallest control (or fault) reading.
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

from harness import cli, judge  # noqa: E402
from reference import nrms as ref  # noqa: E402
from tools.calibrate import tf32  # noqa: E402
from traffic import train_impressions  # noqa: E402

CELL = "nrms.train-b64"


def halved(forward):
    """``NRMSRanker.forward`` with half of each history's clicks unencoded."""
    def half(self, batch):
        hist = batch["hist"]
        n = (hist != 0).sum(dim=1, keepdim=True)
        keep = torch.arange(hist.shape[1], device=hist.device)[None, :] < (n + 1) // 2
        return forward(self, dict(batch, hist=torch.where(keep, hist, 0)))
    return half


@contextlib.contextmanager
def history_halved():
    from news_recsys_tpu_torch.models import nrms

    forward = nrms.NRMSRanker.forward
    nrms.NRMSRanker.forward = halved(forward)
    try:
        yield
    finally:
        nrms.NRMSRanker.forward = forward


def control(res: dict, ctx) -> dict:
    """The reference in TF32 in the program's place, judged."""
    train = {"auc_bins": ctx.config["train"]["auc_bins"], "adagrad_init": 0.0}
    labels = [b["label"].reshape(-1) for b in res["batches"]]
    calls = res["prog"]["calls"]
    with tf32():
        low = ref.first_steps(res["params"], ctx.config, res["titles"], res["batches"])
    prog = {"losses": low["losses"], "change_norms": low["change_norms"], "feed_rows": 0,
            "grad_norms": low["grad_norms"], "calls": calls,
            "aucs": [lo for lo, _ in judge.step_aucs(low["logits"], labels, calls,
                                                     train["auc_bins"], edge=0.0)]}
    return judge.training(prog, res["ref"], labels, train)["numbers"]


def readings(seed: int, dev, program: bool, ctrl: bool, fault: bool) -> list:
    out = []
    if program or ctrl:
        ctx = cli.Context(CELL, seed, 1.0, False, dev)
        res = train_impressions.run(ctx, window=False)
        if program:
            out.append(("program", dict(ctx.numbers)))
        if ctrl:
            out.append(("control", control(res, ctx)))
        del res, ctx
    if fault:
        ctx = cli.Context(CELL, seed, 1.0, False, dev)
        with history_halved():
            train_impressions.run(ctx, window=False)
        out.append(("fault_half_history", dict(ctx.numbers)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.set_num_threads(cli.THREADS)
    split = lambda s: [int(x) for x in s.split(",") if x]
    seeds, controls = split(args.seeds), split(args.control_seeds)
    faults = controls if args.fault_seeds is None else split(args.fault_seeds)
    for seed in dict.fromkeys(seeds + controls + faults):
        for kind, numbers in readings(seed, dev, seed in seeds, seed in controls, seed in faults):
            print(json.dumps({"workload": CELL, "seed": seed, "kind": kind, "numbers": numbers}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
