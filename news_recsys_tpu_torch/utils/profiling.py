"""Tracing and profiling hooks on ``torch.profiler``.

Port of :mod:`news_recsys_tpu.utils.profiling`:

- :func:`trace`: a context manager that records the host's operators and,
  with a card, its kernels and copies, and writes a trace TensorBoard loads
  (``<log_dir>/<host>_<pid>.<ns>.pt.trace.json``);
- :class:`StepTimer`: per-step wall-clock stats with examples/s, an own copy
  (it is backend-free; ``tests/test_torch_shared.py`` holds it to the
  original);
- :func:`device_memory_stats`: memory in use, its peak and the card's size,
  for every visible card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .logging import get_logger

logger = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activities, written to ``log_dir`` when the block ends; yields the
    profiler, whose ``key_averages()`` hold the block's sums."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        logger.info(f"Profiler trace written to {log_dir}")


class StepTimer:
    """Collect per-step durations; report throughput percentiles."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.durations.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "step_ms_p50": float(np.percentile(d, 50) * 1e3),
            "step_ms_p95": float(np.percentile(d, 95) * 1e3),
            "step_ms_mean": float(d.mean() * 1e3),
            "examples_per_sec": float(self.batch_size / d.mean()),
        }


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
