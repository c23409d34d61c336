"""Tracing and profiling hooks on ``torch.profiler``, and the program's own
spans and counters.

- :func:`span` and :func:`count`: named host-clock spans around the parts of
  the sparse step, the epoch loop and the serving path, and counts attached
  to them (a host int, or a function that :func:`recorded` calls, so that a
  count launches nothing where the span runs). A span opened with no span
  open on its thread is a root; a root records (and its whole tree with it)
  only if a ``torch.profiler`` session runs at its entry or
  :func:`recording` is active. Otherwise every span of the tree is one
  shared context that records nothing: the cost is a flag read and a
  thread-local counter, with no clock read and no allocation.
  :func:`recorded` returns what was recorded, :func:`clear` empties the
  store;
- :func:`trace`: a context manager that records the host's operators and,
  with a card, its kernels and copies, and writes a trace TensorBoard loads
  (``<log_dir>/<host>_<pid>.<ns>.pt.trace.json``), which also holds every
  span recorded in the session, of every thread: those of the thread that
  traces are the profiler's own ``record_function`` ranges, those of other
  threads are added to the file;
- :func:`device_memory_stats`: memory in use, its peak and the card's size,
  for every visible card.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import get_logger

logger = get_logger("profiling")

MAX_SPANS = 200_000          # the store's bound; what comes after is dropped and counted
MAX_LATER = 4_096            # counts left to recorded(), each holding its ids; more are dropped
CLOCK_MARK = "profiling_host_clock"


@dataclass
class SpanRecord:
    """One recorded span: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns()``, ``parent`` None for a root, ``root`` the id
    shared by every span of its tree, ``thread`` the thread's native id;
    ``counts`` the counts attached to it, summed by name (host ints once
    :func:`recorded` has returned it)."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, object] = field(default_factory=dict)


class Recorded(NamedTuple):
    spans: List[SpanRecord]
    dropped: int


class _Local(threading.local):
    def __init__(self):
        self.open: List["_Span"] = []     # recorded spans open on this thread, innermost last
        self.quiet = 0                    # spans open on this thread that do not record
        self.thread = threading.get_native_id()     # a system call: read once a thread


_local = _Local()
_ids = itertools.count()
_lock = threading.Lock()          # over the store, ``_dropped``, ``_later`` and ``_forced``
_store: List[SpanRecord] = []
_dropped = 0
_later = 0                        # counts in the store that recorded() has not computed
_forced = 0


class _Quiet:
    """The one context handed out for every span that does not record."""

    __slots__ = ()

    def __enter__(self):
        _local.quiet += 1

    def __exit__(self, *exc):
        _local.quiet -= 1
        return False


_QUIET = _Quiet()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, parent: "_Span | None"):
        i = next(_ids)
        self.rec = SpanRecord(name, i, None if parent is None else parent.rec.id,
                              i if parent is None else parent.rec.root, _local.thread, 0)
        self.rf = None

    def __enter__(self):
        _local.open.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.rec.name)
            self.rf.__enter__()
        self.rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped, _later
        self.rec.end_ns = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.open.pop()
        counts = self.rec.counts
        later = [k for k, v in counts.items() if callable(v)]
        with _lock:
            if len(_store) >= MAX_SPANS:
                _dropped += 1 + len(counts)
                return False
            if _later + len(later) > MAX_LATER:
                for k in later:
                    del counts[k]
                _dropped += len(later)
            else:
                _later += len(later)
            _store.append(self.rec)
        return False


def span(name: str):
    """A context manager around one named part of the work; see the module's
    docstring for when it records."""
    loc = _local
    if loc.open:
        return _Span(name, loc.open[-1])
    if loc.quiet or not (_autograd_profiler._is_profiler_enabled or _forced):
        return _QUIET
    return _Span(name, None)


def active() -> bool:
    """Whether a recorded span is open on this thread: what a caller asks
    before it computes a count."""
    return bool(_local.open)


def count(name: str, value) -> None:
    """Add ``value`` to the count ``name`` of the innermost recorded span open
    on this thread; nothing where none is. ``value`` is a host int, or a
    function of no arguments that returns one: it is kept as it is and called
    only by :func:`recorded`, so a count whose reduction runs on the device
    neither launches nor waits where the span runs (it keeps what it reads
    alive until then)."""
    loc = _local
    if loc.open:
        counts = loc.open[-1].rec.counts
        if name in counts:
            prev = counts[name]
            value = (_sum_later(prev, value) if callable(prev) or callable(value)
                     else prev + value)
        counts[name] = value


def _sum_later(a, b):
    return lambda: (a() if callable(a) else a) + (b() if callable(b) else b)


@contextlib.contextmanager
def recording():
    """Record every span tree whose root opens in the block, on any thread,
    with or without a profiler session."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def recorded() -> Recorded:
    """The recorded spans, finished ones only, each count a host int (the
    functions that :func:`count` kept are called now), and how many spans and
    counts the full store dropped. The store is not emptied."""
    with _lock:
        spans, dropped = list(_store), _dropped
    _compute(spans)
    return Recorded(spans, dropped)


def _compute(spans: List[SpanRecord]) -> None:
    """Call the counts the spans keep as functions, in place."""
    global _later
    done = 0
    for s in spans:
        for k, v in s.counts.items():
            if callable(v):
                s.counts[k] = int(v())
                done += 1
    if done:
        with _lock:
            _later = max(0, _later - done)


def clear() -> None:
    """Empty the store."""
    global _dropped, _later
    with _lock:
        _store.clear()
        _dropped = _later = 0


def _add_spans(path: str, spans: List[SpanRecord], t0_ns: int) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as ``user_annotation``
    events on their own threads, with their ids and counts, on the trace's
    clock: its ``CLOCK_MARK`` event opened at ``t0_ns``."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    mark = next((e for e in events if e.get("name") == CLOCK_MARK), None)
    if mark is None:
        return
    _compute(spans)
    events += [{"ph": "X", "cat": "user_annotation", "name": s.name, "pid": mark.get("pid"),
                "tid": s.thread, "ts": float(mark["ts"]) + (s.start_ns - t0_ns) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"span": s.id, "root": s.root, **s.counts}} for s in spans]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activities, written to ``log_dir`` when the block ends; yields the
    profiler, whose ``key_averages()`` hold the block's sums.

    The profiler records the host ops of this thread only, so the spans
    (:func:`span`) recorded here are in the file as its own ranges; those
    that other threads recorded in the block are added to it (the file is
    read and written again only then)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    me = threading.get_native_id()
    prof.start()
    with torch.profiler.record_function(CLOCK_MARK):
        t0 = time.perf_counter_ns()
    try:
        yield prof
    finally:
        prof.stop()
        t1 = time.perf_counter_ns()
        with _lock:
            others = [s for s in _store
                      if s.thread != me and t0 <= s.start_ns and s.end_ns <= t1]
        os.makedirs(log_dir, exist_ok=True)       # the name tensorboard_trace_handler gives
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        if others:
            _add_spans(path, others, t0)
        logger.info(f"Profiler trace written to {log_dir}")


def device_memory_stats() -> List[Dict[str, float]]:
    """One dict a visible card: ``bytes_in_use`` and ``peak_bytes_in_use``
    (PyTorch's allocator, ``torch.cuda.memory_stats``) and ``bytes_limit``
    (the card's memory, ``torch.cuda.mem_get_info``); none without a card."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": str(torch.device("cuda", i)),
                    "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1]})
    return out
