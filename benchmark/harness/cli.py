"""One run of one cell: ``run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.

The run refuses a machine without the cards the cell asks for, runs the
cell's traffic driver, refuses a process in which JAX or the JAX package
was loaded, and prints the result as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end ones
with ``--trace 0``, the per-layer ones with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit, as the last lines of standard error also give
them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

from . import spec

T_START = time.perf_counter()
FORBIDDEN = {"jax", "jaxlib", "flax", "news_recsys_tpu"}
# the host threads of PyTorch's CPU ops: the hot paths are host-bound on one
# thread, and a card's host is shared, so spare threads only add noise
THREADS = 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a driver reads and fills: the cell, its configuration and the
    run's arguments; set-up parts, spans, end-to-end values, what the
    per-layer readers read, the trace, and the numbers that decide
    ``correct``."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device):
        from .trace import Spans

        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.cell = spec.workload(name)
        self.config = spec.config(self.cell["config"])
        self.params = self.cell["params"]
        self.device = device
        self.setup, self.e2e, self.untraced = {}, {}, {}
        self.spans = Spans()
        self.profile = None
        self.numbers = {}
        self.attempted = self.failed = 0
        self.memory_peak = 0

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        yield
        self.setup[name] = time.perf_counter() - t

    def setup_done(self) -> None:
        """The first timed call comes next: set-up ends here."""
        self.e2e["setup_s"] = time.perf_counter() - T_START
        parts = ", ".join(f"{k} {v:.3f}" for k, v in self.setup.items())
        log(f"setup_s {self.e2e['setup_s']:.3f} by part (s): {parts}")

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))


def card() -> dict:
    import torch

    out = {"name": torch.cuda.get_device_name(0)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unknown"
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def per_layer(ctx: Context, entries: list) -> dict:
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"]).read(ctx, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device=None) -> dict:
    """The cell's run on ``device`` (the first card by default); returns the
    result line's object."""
    import torch

    from .judge import verdict

    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        raise SystemExit(f"no cell {args.workload!r} in BENCHMARK.json: {names}")
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            raise SystemExit(3)
        device = torch.device("cuda", 0)
        torch.set_num_threads(THREADS)
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace), device)
    e2e, layers = spec.cell_metrics(bench, args.workload)
    spec.driver(ctx.cell["traffic"]).run(ctx)

    bad = loaded_forbidden()
    if bad:
        log(f"refused: modules {bad} were loaded in the process that measured")
        raise SystemExit(4)
    if args.trace:
        metrics = per_layer(ctx, layers)
    else:
        metrics = {m["name"]: {"value": ctx.e2e[m["name"]], "unit": m["unit"]} for m in e2e}
    for m in metrics.values():
        if not math.isfinite(m["value"]):
            raise SystemExit(f"a metric is not finite: {metrics}")
    correct, checks = verdict(ctx.numbers, ctx.cell["limits"])
    on = card() if device.type == "cuda" else {"name": str(device), "power_limit": "n/a"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": on["name"],
           "count": chips, "memory_peak_bytes": ctx.memory_peak,
           "power_limit": on["power_limit"]}
    result = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.profile is not None:
        dev.update(busy_s=ctx.profile["busy_s"], window_s=ctx.profile["window_s"])
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> None:
    args = parse(argv)
    result = run(args)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
