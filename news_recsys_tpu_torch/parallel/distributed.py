"""Process start, the main process, host fetches and the collectives of
multi-process training.

Port of :mod:`news_recsys_tpu.parallel.distributed` on ``torch.distributed``:

- :func:`initialize_distributed` joins the process group: over a TCP
  coordinator (``host:port``; a ``file://`` or ``tcp://`` URL passes as
  it is) with the process count and id, or, called with none of them, from
  ``torchrun``'s environment (``env://``), the counterpart of JAX's pod
  auto-detection. A start that fails raises: unlike the JAX package, there
  is no fall-back to one process;
- every rank owns one device (:func:`local_device`): ``cuda:LOCAL_RANK``
  where ``torchrun`` sets it, else ``cuda:(rank % device_count)``, or the
  device the caller names (the CPU in the tests);
- the backend is ``nccl`` for CUDA and ``gloo`` for the CPU unless the
  caller names one. Gloo runs only ``broadcast`` and ``all_reduce`` on CUDA
  tensors, so under gloo the collective helpers here carry a CUDA tensor's
  all-to-all and all-gather through the host: one copy down, the collective
  on CPU tensors, one copy up. That is the transport gloo offers, chosen by
  naming the backend, not a fall-back: the compute stays on the card, and
  :class:`CommStats` counts the host copies and their bytes. NCCL refuses
  two ranks on one card; nothing here catches its error.

The helpers return their input where the group has one rank, so a mesh
axis of size 1 costs no collective.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import get_logger

logger = get_logger("distributed")

DEFAULT_TIMEOUT = timedelta(minutes=10)


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_url(coordinator: str) -> str:
    """A process-group URL: ``host:port`` becomes ``tcp://host:port``; a URL
    (``tcp://``, ``file://``) passes as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           backend: Optional[str] = None,
                           timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device
    (:func:`local_device` of ``device``). With ``coordinator`` the process
    count and id are required; with no arguments ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) names them.
    A second call in a started process returns the device and changes
    nothing. Raises where the group cannot start."""
    if dist.is_initialized():
        return local_device(device)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        kwargs = dict(init_method=init_url(coordinator), world_size=int(num_processes),
                      rank=int(process_id))
    elif num_processes is not None or process_id is not None:
        raise ValueError("--num-processes / --process-id need --coordinator")
    else:
        kwargs = dict(init_method="env://")
    backend = backend or default_backend(device)
    rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
    dev = local_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    logger.info(f"distributed: process {dist.get_rank()}/{dist.get_world_size()} "
                f"({backend}) on {dev}")
    return dev


def local_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` where it names an index or is not CUDA,
    else ``cuda:LOCAL_RANK`` (``torchrun``) or ``cuda:(rank % device_count)``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def broadcast_str(s: str) -> str:
    """Agree on a short string across processes (process 0 wins): the
    timestamped experiment dir, which each process would take from its own
    clock."""
    if process_count() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclass
class CommStats:
    """What a mesh's collectives did: calls, the host copies that gloo
    staging made (a copy down and a copy up count two) and their bytes,
    and, with ``timed``, the wall time inside the helpers (each one then
    waits for the device before and after, so that time is the
    collective's own)."""

    calls: int = 0
    host_copies: int = 0
    host_bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls = self.host_copies = self.host_bytes = 0
        self.seconds = 0.0


class _Call:
    """One collective: counts it, and times it when ``stats.timed``."""

    def __init__(self, stats: Optional[CommStats], device: torch.device):
        self.stats, self.device = stats, device

    def __enter__(self):
        if self.stats is not None and self.stats.timed:
            _sync(self.device)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.stats is not None:
            self.stats.calls += 1
            if self.stats.timed:
                _sync(self.device)
                self.stats.seconds += time.perf_counter() - self.t0
        return False

    def down(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host, counted where it was on the card."""
        if t.device.type != "cuda":
            return t
        if self.stats is not None:
            self.stats.host_copies += 1
            self.stats.host_bytes += t.numel() * t.element_size()
        return t.cpu()

    def up(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` back on the caller's device, counted where that is the card."""
        if self.device.type != "cuda":
            return t
        if self.stats is not None:
            self.stats.host_copies += 1
            self.stats.host_bytes += t.numel() * t.element_size()
        return t.to(self.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t``'s collective on ``group`` goes through the host: a CUDA
    tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_(t: torch.Tensor, group, stats: Optional[CommStats] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo and NCCL both take CUDA
    tensors); returns ``t``."""
    if group_size(group) == 1:
        return t
    with _Call(stats, t.device):
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, stats: Optional[CommStats] = None) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated along dim 0 in
    rank order within ``group``."""
    n = group_size(group)
    if n == 1:
        return t
    with _Call(stats, t.device) as call:
        src = t.contiguous()
        if _staged(group, src):
            src = call.down(src)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
        return call.up(out) if out.device != t.device else out


def all_to_all(t: torch.Tensor, out_splits: List[int], in_splits: List[int], group,
               stats: Optional[CommStats] = None) -> torch.Tensor:
    """``all_to_all_single`` along dim 0: rows ``in_splits[r]`` of ``t`` go
    to rank ``r`` of ``group``, and the result holds ``out_splits[r]`` rows
    from rank ``r``, in rank order."""
    if group_size(group) == 1:
        return t
    with _Call(stats, t.device) as call:
        src = t.contiguous()
        if _staged(group, src):
            src = call.down(src)
        out = src.new_empty((sum(out_splits), *src.shape[1:]))
        dist.all_to_all_single(out, src, out_splits, in_splits, group=group)
        return call.up(out) if out.device != t.device else out


def fetch_to_host(x: torch.Tensor, group=None, stats: Optional[CommStats] = None) -> np.ndarray:
    """A tensor split along dim 0 over ``group`` (a table's shards over the
    model axis, scores over the data axis), whole on every process, as a
    numpy array; one process: ``x`` itself."""
    return all_gather_cat(x.detach(), group, stats).cpu().numpy()


def fetch_pytree_to_host(tree, group=None, stats: Optional[CommStats] = None):
    """:func:`fetch_to_host` over every tensor of nested dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return fetch_to_host(tree, group, stats)
    if isinstance(tree, dict):
        return {k: fetch_pytree_to_host(v, group, stats) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_pytree_to_host(v, group, stats) for v in tree)
    return tree


def host_local_batch_to_global(batch: Dict[str, torch.Tensor], group=None,
                               stats: Optional[CommStats] = None) -> Dict[str, torch.Tensor]:
    """The global batch from each rank's local rows: every array's leading
    dim gathered over ``group`` (the data axis) in rank order, which is
    batch order."""
    return {k: all_gather_cat(v, group, stats) for k, v in batch.items()}


def _rank_main(fn, rank: int, world: int, args, init_method: str, backend: str, device,
               timeout_s: float, threads: Optional[int], results) -> None:
    """A spawned rank: join the group, run ``fn(rank, *args)``, put ``(rank,
    ok, pickled result or traceback)`` on ``results`` (pickled by value: a
    tensor sent as a shared handle would not outlive this process)."""
    import pickle
    import traceback

    try:
        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(init_method, world, rank, device=device, backend=backend,
                               timeout=timedelta(seconds=timeout_s))
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:                        # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(results, procs, failed: Dict[int, str], wait: float = 5.0) -> str:
    """Every failed rank's traceback: ``failed`` and whatever else the queue
    brings within ``wait`` seconds or until every rank has exited (the first
    failure is often another rank's lost connection)."""
    import queue as queue_mod

    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        try:
            rank, ok, val = results.get(timeout=0.2)
        except queue_mod.Empty:
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if not ok:
            failed[rank] = val
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


def spawn_ranks(fn, world: int, args=(), *, init_method: str, backend: str = "gloo",
                device="cpu", timeout: float = 300.0, group_timeout: float = 60.0,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned processes, each joined to
    one process group at ``init_method`` (``file://`` or ``tcp://``) on
    ``device`` with ``backend`` (its collectives time out after
    ``group_timeout`` seconds), and return their results in rank order.
    ``fn`` and its results must pickle. A rank that raises or dies, or a run
    past ``timeout`` seconds, raises here, and every rank still running is
    stopped."""
    import pickle
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, args, init_method, backend, device, group_timeout,
                               threads, results)) for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(_failures(results, procs, {rank: val}))
            out[rank] = pickle.loads(val)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"rank {procs.index(p)} did not exit in time")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [out[r] for r in range(world)]
