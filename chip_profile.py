"""Where a cascade request's time goes in the PyTorch port, on one CUDA GPU.

    python3 chip_profile.py [--users 64,256,1024] [--requests 10]

Builds the full-width MIND cascade of ``chip_smoke.py`` (seeded weights,
65,238 items, fetch 100) on the card and, for each request size, calls
``CascadeRecommender.recommend`` directly (no HTTP), in three separate runs
over the same requests after two warm-up requests:

1. plain: wall time per request of parsing the request JSON, ``recommend``
   and encoding the answer, with nothing added to the code;
2. layers: wall time of the user tower, the top-k search, the recall stage
   and the DCN forward, from wrappers that synchronise the card around each
   (removed again before the next run);
3. traced: a ``torch.profiler`` trace of 5 requests, for the device kernel
   time per request and the top kernels.

The device-busy share is the traced device time per request over the
plain run's ``recommend`` time, so neither the tracer's nor the wrappers'
overhead enters it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from news_recsys_tpu_torch.serving import _user_batch_from_json  # noqa: E402


def plain_times(casc, reqs) -> dict:
    """Mean wall ms per request of each step of an unmodified request."""
    totals = collections.defaultdict(float)
    for req in reqs:
        body = json.dumps(req)
        t0 = time.perf_counter()
        parsed = json.loads(body)
        batch = _user_batch_from_json(casc, parsed["users"])
        t1 = time.perf_counter()
        ids, scores = casc.recommend(batch, k=chip_smoke.K, histories=parsed["histories"])
        t2 = time.perf_counter()
        json.dumps({"ids": ids, "scores": scores})
        t3 = time.perf_counter()
        totals["parse request JSON"] += t1 - t0
        totals["cascade.recommend"] += t2 - t1
        totals["encode answer JSON"] += t3 - t2
        totals["whole request, no HTTP"] += t3 - t0
    return {k: v / len(reqs) * 1e3 for k, v in totals.items()}


def layer_times(casc, reqs) -> dict:
    """Mean wall ms per request of each layer, the card synchronised around each."""
    totals = collections.defaultdict(float)
    spans = [(casc.recall, "_encode", "recall: user tower"),
             (casc.recall.searcher, "search", "recall: matmul + topk + copy"),
             (casc.recall, "recommend", "recall: total (incl. dedup loop)"),
             (casc.ranker_model, "forward", "rank: DCN forward")]

    def wrap(fn, label):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[label] += time.perf_counter() - t
            return out
        return timed

    for obj, name, label in spans:
        setattr(obj, name, wrap(getattr(obj, name), label))
    try:
        for req in reqs:
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
    finally:
        for obj, name, _ in spans:
            delattr(obj, name)          # back to the class's own method
    return {k: v / len(reqs) * 1e3 for k, v in totals.items()}


def traced_kernels(casc, reqs) -> list:
    """Device kernels of ``reqs`` under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for req in reqs:
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", default="64,256,1024")
    p.add_argument("--requests", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = chip_smoke.card()
    print(smi, flush=True)
    casc = chip_smoke.build_cascade(torch.device("cuda"))
    for users in map(int, args.users.split(",")):
        chip_smoke.USERS_PER_REQUEST = users
        reqs = chip_smoke.make_requests(2 + args.requests)
        for req in reqs[:2]:                                  # warm-up
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
        plain = plain_times(casc, reqs[2:])
        layers = layer_times(casc, reqs[2:])
        traced = reqs[2:7]
        kernels = traced_kernels(casc, traced)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(traced)
        print(f"\n== {users} users/request, {args.requests} requests, no HTTP ({smi})")
        for k, v in {**plain, **layers}.items():
            print(f"  {k:36s} {v:9.3f} ms")
        print(f"  {'users served per second':36s} "
              f"{users / plain['whole request, no HTTP'] * 1e3:9.0f}")
        print(f"  device kernels (profiler, {len(traced)} requests) {dev_ms:.3f} ms/request "
              f"-> device busy {dev_ms / plain['cascade.recommend'] * 100:.2f}% "
              f"of the plain run's recommend")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.key[:72]:72s} "
                  f"{e.self_device_time_total / len(traced):8.1f} us/request")
    print(smi)


if __name__ == "__main__":
    main()
