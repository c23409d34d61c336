"""Untraced step time, host launch time and device work of an NRMS training
step on one CUDA GPU, at the ``nrms.train-b64`` cell's shapes and rows.

    python3 scripts/nrms_step_times.py [--root DIR] [--seed N] [--steps 200]

``--root``: the checkout whose ``news_recsys_tpu_torch`` is measured (default
this one; a parent commit unpacked under a gitignored directory measures the
parent with the same script). The rows are the cell's own
(``benchmark/traffic/train_impressions.py``: the click law, the title table,
64 rows of 1 + 4 candidates a batch), uploaded before any timing; the step is
``training/dense_step.make_train_step``'s, the one ``Trainer.train_epoch``
calls. Three readings, after 20 warm-up steps:

1. ``step_ms``: CUDA events around ``--steps`` back-to-back steps, nothing
   traced: the step's time as the window of the cell sees it;
2. ``host_launch_ms``: the host's time to launch one step while the device
   sleeps (``torch.cuda._sleep`` queued first, long enough that the step's
   launches never wait for it; checked), median of 20 steps: the time a
   step would take if the device were free;
3. ``device_ms``: the kernels' summed device time a step over 10 steps under
   ``torch.profiler``, and of it ``attention_ms``, the kernels whose names
   hold ``mhsa`` (the attention kernels; none where the program has them not).

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--seed", type=int, default=2200000052)
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(HERE, "benchmark")]

    import numpy as np
    import torch

    from harness import spec
    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training import dense_step
    from news_recsys_tpu_torch.training.metrics_device import AucHist
    from traffic import train_impressions as ti

    dev = torch.device("cuda")
    conf, cell = spec.config("mind-nrms"), spec.workload("nrms.train-b64")
    B, n_batches = conf["train"]["batch_size"], 32
    rows = ti.training_rows(ti.world(conf, args.seed, cell["params"]["law"]), conf,
                            B * n_batches, args.seed)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(rows[k][i * B:(i + 1) * B])).to(dev)
                for k in ("hist", "item_id", "label")} for i in range(n_batches)]
    cfg = zoo.mind_nrms_config()
    model = build_ranker(cfg, seed=0, device=dev)
    model.set_titles(torch.from_numpy(ti.titles(conf, args.seed)))
    state = dense_step.init_dense_state(model, cfg)
    step = dense_step.make_train_step(model, cfg)
    hist = AucHist.zeros(dev)
    run = lambda i: step(state, batches[i % n_batches], hist)  # noqa: E731
    for i in range(20):
        run(i)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(args.steps):
        run(i)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.steps

    launch = []
    for i in range(20):
        torch.cuda._sleep(int(2e8))                 # about 0.1 s at the card's clocks
        asleep = torch.cuda.Event()
        asleep.record()
        t0 = time.perf_counter()
        run(i)
        launch.append((time.perf_counter() - t0) * 1e3)
        if asleep.query():
            raise RuntimeError("the device woke before the step was launched: sleep longer")
        torch.cuda.synchronize()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        run(0)
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(10):
            run(i)
        torch.cuda.synchronize()
    # device work only: the program's spans show on the device too, as user annotations
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / 10
    device_ms = sum(by_name.values())
    attention_ms = sum(t for n, t in by_name.items() if "mhsa" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"root": root, "card": card(), "seed": args.seed, "step_ms": step_ms,
                      "host_launch_ms": statistics.median(launch),
                      "host_launch_ms_quartiles": statistics.quantiles(launch, n=4),
                      "device_ms": device_ms, "attention_ms": attention_ms,
                      "kernels_a_step": len(kernels) / 10,
                      "top_kernels_ms": [[n[:90], round(t, 4)] for n, t in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
