"""Device time by the program's own spans: :func:`profiled` runs a function
under ``torch.profiler`` as :func:`trace.profiled` does and reduces the
trace as :func:`trace.reduce` does, and adds ``span_kernels``: for each
named span (a ``record_function`` range the program opens while a session
runs, ``utils/profiling.span``), how many times it ran, and the kernels
launched while it was open on its thread, with their device time. A kernel
belongs to the range in which its launch call (``cudaLaunchKernel`` and
the like, the trace's ``cuda_runtime`` and ``cuda_driver`` events) ran,
matched by the trace's correlation id; it may run on the device later.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from . import trace

LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def attribute(events: list, names: Iterable[str]) -> Dict[str, dict]:
    """{name: {"ranges", "kernels", "seconds"}} for each of ``names`` that
    has a range in ``events`` (a Chrome trace's)."""
    names = set(names)
    ranges = defaultdict(list)                  # (name, pid, tid) -> [(start, end)]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in names:
            ranges[(e["name"], e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e["dur"]))
    kernels = {e["args"]["correlation"]: e["dur"] for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "correlation" in e.get("args", {})}
    launches = defaultdict(list)                # (pid, tid) -> [(ts, correlation)]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[(e.get("pid"), e.get("tid"))].append((e["ts"], corr))
    out = {}
    for (name, pid, tid), spans in ranges.items():
        spans.sort()
        starts = np.array([s for s, _ in spans])
        ends = np.array([t for _, t in spans])
        got = out.setdefault(name, {"ranges": 0, "kernels": 0, "seconds": 0.0})
        got["ranges"] += len(spans)
        for ts, corr in launches.get((pid, tid), ()):
            i = int(np.searchsorted(starts, ts, side="right")) - 1
            if i >= 0 and ts <= ends[i] and corr in kernels:
                got["kernels"] += 1
                got["seconds"] += kernels[corr] * 1e-6
    return out


def profiled(fn: Callable[[], object], device, names: Iterable[str]) -> tuple:
    """(``fn()``, the reduced trace of its run with ``span_kernels`` of the
    program's spans ``names``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    reduced = trace.reduce(events, window)
    reduced["span_kernels"] = attribute(events, names)
    return out, reduced
