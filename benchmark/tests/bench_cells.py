"""Cells at a size a CPU test holds, and one run of one on the CPU."""

from harness import spec

WORKLOAD = spec.workload        # the files' reader, before a test patches it

def small_cell(name: str, **over) -> dict:
    """The cell's file at a size a CPU test holds: few steps, requests and
    users; every width as the configuration states."""
    cell = WORKLOAD(name)
    p = cell["params"]
    if "steps_per_epoch" in p:
        p.update(steps_per_epoch=8, warmup_steps=5, trace_steps=3)
    if "closed_requests" in p:
        p.update(users=16, closed_requests=4, closed_sample_from=2, warmup_requests=1,
                 sample_requests=2, trace_seconds=1)
    p.update(over)
    return cell


def run_small(monkeypatch, name: str, seconds: float = 1.0, trace: int = 0, **over) -> dict:
    """One run of cell ``name`` on the CPU at :func:`small_cell`'s size."""
    import torch

    from harness import cli

    cell = small_cell(name, **over)
    monkeypatch.setattr(spec, "workload", lambda n: cell)
    bench = spec.benchmark()
    if name not in [w["name"] for w in bench["workloads"]]:     # a cell kept for later
        bench["workloads"].append({"name": name, "config": cell["config"],
                                   "traffic": cell["traffic"], "chips": 1, "why": cell["why"]})
        monkeypatch.setattr(spec, "benchmark", lambda: bench)
    args = cli.parse(["--workload", name, "--seed", "3000000019", "--seconds", str(seconds),
                      "--trace", str(trace)])
    return cli.run(args, device=torch.device("cpu"))
