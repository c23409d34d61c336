"""Spans on the host clock and the reduction of a ``torch.profiler`` trace.

:class:`Spans` wraps a method of an instance the harness built with a
timer (and a ``record_function`` label, so a trace names the host's work):
the program's code is not touched. :func:`profiled` runs a function under
``torch.profiler`` and reduces its Chrome trace to what the metrics read:
each device kernel's count and time by name, the device's busy time (the
union of kernels, copies and memsets), the traced window's length on the
host clock, and the longest idle gaps labelled by the host's work at the
time.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
TOP = 10
LABELLED_GAPS = 2000
NOTHING = contextlib.nullcontext()
CLOCK_MARK = "bench_host_clock"


class Spans:
    """Host-clock spans by name: ``(start, seconds)`` of every call of each
    wrapped method, and the wrappers to take off again. With ``labelled``
    set (the profiled part of a window), each call is also a
    ``record_function`` range of its name."""

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._wrapped: List[tuple] = []
        self.labelled = False

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)
        calls = self.calls[name]

        def timed(*args, **kwargs):
            with (torch.profiler.record_function(name) if self.labelled else NOTHING):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                calls.append((t, time.perf_counter() - t))
            return out

        timed.__dict__.update(getattr(fn, "__dict__", {}))     # the sparse step's ``flush``
        self._wrapped.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, timed)

    def unwrap(self) -> None:
        for obj, attr, own in reversed(self._wrapped):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._wrapped.clear()

    def between(self, name: str, t0: float, t1: float) -> List[float]:
        """Durations of the calls of ``name`` that started in [t0, t1)."""
        return [d for t, d in self.calls.get(name, ()) if t0 <= t < t1]


def warm_profiler(device) -> None:
    """One short session, so that the measured one is not the process's
    first: a session that follows the kernel library's load can lose its
    kernel records (PERF.md)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1024, device=device).sum().item()


def profiled(fn: Callable[[], object], device, spans: Spans = None) -> tuple:
    """(``fn()``, the reduced trace of its run). The calls of ``spans`` that
    ran in the session join the trace's host events (a ``record_function``
    mark at a known host-clock time aligns the two clocks): threads the
    profiler does not record, such as an HTTP server's, are labelled by
    them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(CLOCK_MARK):
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
    mark = next((e["ts"] for e in events if e.get("name") == CLOCK_MARK), None)
    if spans is not None and mark is not None:
        events += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": mark + (t - t0) * 1e6,
                    "dur": d * 1e6} for name, calls in spans.calls.items()
                   for t, d in calls if t + d >= t0]
    return out, reduce(events, window)


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """Merged [start, end) intervals of the given ones."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def reduce(events: list, window_s: float) -> dict:
    """``kernels`` {name: [count, seconds]}, ``busy_s``, ``window_s``,
    ``device_ops`` and ``idle_gaps`` (the breakdown's two lists)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in dev:
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += e["dur"] * 1e-6
    if not dev:
        return {"kernels": {}, "busy_s": 0.0, "window_s": window_s, "device_ops": [],
                "idle_gaps": []}
    s, e = _union(np.array([x["ts"] for x in dev], float),
                  np.array([x["ts"] + x["dur"] for x in dev], float))
    busy = float((e - s).sum()) * 1e-6
    gap_s, gap_e = e[:-1], s[1:]
    longest = np.argsort(gap_s - gap_e)[:LABELLED_GAPS]
    labels = _labels(host, (gap_s[longest] + gap_e[longest]) / 2)
    idle: Dict[str, float] = defaultdict(float)
    for i, label in zip(longest, labels):
        idle[label] += float(gap_e[i] - gap_s[i]) * 1e-6
    ops = sorted(([n[:120], t] for n, (_, t) in kernels.items()), key=lambda x: -x[1])
    gaps = sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])
    return {"kernels": dict(kernels), "busy_s": busy, "window_s": window_s,
            "device_ops": ops[:TOP], "idle_gaps": gaps[:TOP]}


def _labels(host: list, mids: np.ndarray) -> List[str]:
    """What the host ran at each instant: the innermost of the harness's
    labels and the innermost operator running then, on any thread."""
    if not host:
        return ["host, nothing traced"] * len(mids)
    ts = np.array([h["ts"] for h in host], float)
    te = ts + np.array([h["dur"] for h in host], float)
    ann = np.array([h["cat"] == "user_annotation" for h in host])
    out = []
    for m in mids:
        on = (ts <= m) & (te >= m)
        parts = []
        for kind in (ann, ~ann):
            idx = np.flatnonzero(on & kind)
            if len(idx):
                parts.append(host[idx[np.argmin(te[idx] - ts[idx])]]["name"][:80])
        out.append(" / ".join(parts) or "host, between traced ops")
    return out
