"""Sorted row scatter, ``table[rows] = vals`` in place: a CUDA kernel for
Hopper and its plain PyTorch version.

Port of :mod:`news_recsys_tpu.ops.scatter_rows`, with its contract: ``rows``
are int32 and non-decreasing, and duplicate rows carry identical values (the
sparse step's sorted dedup layout gives every duplicate of a row the same
summed gradient, so their updated values are the same). Where the JAX
function returns a new table (donated), this one writes ``table`` in place
and returns it.

Rows outside ``[0, V)`` are dropped, in the kernel and in the plain
version, as XLA's scatter drops rows ``>= V``. (``jnp``'s ``.at[]`` wraps a
negative row to the end of the table; the sorted dedup never emits one,
and the port drops it.) Of a run of equal rows only the last slot writes:
under the contract that changes nothing, and outside it the last slot wins,
as the Pallas grid's order has it, on the card and on the CPU alike.

The kernel (``csrc/scatter_rows.cu``, entry ``nrt_scatter_rows_set``)
replaces the Pallas kernel
``news_recsys_tpu/ops/scatter_rows.py::_scatter_pallas``. It is bound by
memory latency: a thread issues its loads of its slot's row, the next
slot's and its 16 bytes of ``vals`` together, writes only if its slot ends
a run, and never reads the table; 256 threads a block, a float4 a thread
(a float where D % 4 != 0 or a base address is off 16 bytes).
The plain version checks sortedness on the CPU, as the JAX interpret path
does; on the card neither it nor the kernel synchronises.
"""

from __future__ import annotations

import torch

from . import (KernelCost, check_tensor, forward_only, kernel_device, kernel_scope,
               launch_count_lock, stream_ptr)
from ._build import launch


def last_of_run(rows: torch.Tensor) -> torch.Tensor:
    """True at each slot whose next slot holds another row (and at the last)."""
    last = torch.ones_like(rows, dtype=torch.bool)
    last[:-1] = rows[1:] != rows[:-1]
    return last


def scatter_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """``table[rows] = vals`` in place in plain PyTorch, rows outside
    ``[0, V)`` dropped and the last slot of a run of equal rows written: the
    CPU path and the kernel's oracle."""
    rows = rows.long()
    if rows.device.type == "cpu" and bool((rows[1:] < rows[:-1]).any()):
        raise ValueError("scatter_rows_set: rows must be non-decreasing")
    if rows.numel() == 0:
        return table
    # kept slots name distinct rows, so no two writes of one row differ
    return write_kept(table, rows, vals, (rows >= 0) & (rows < table.shape[0])
                      & last_of_run(rows))


def write_kept(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """``table[rows] = vals`` in place for the slots ``keep`` marks (rows
    int64, inside the table where kept, not empty), in plain PyTorch and
    without waiting for the device: a dropped slot repeats the write of the
    first kept one, or, where none is kept, writes what the table holds."""
    first = keep.to(torch.uint8).argmax().reshape(1)
    idx = torch.where(keep, rows, rows.index_select(0, first)).clamp(0, table.shape[0] - 1)
    src = torch.where(keep[:, None], vals, vals.index_select(0, first))
    src = torch.where(keep.any(), src, table[idx])
    return table.index_put_((idx,), src)


def scatter_cost(S: int, D: int, distinct_rows: int) -> KernelCost:
    """The scatter's work, no arithmetic: the S row ids read; of ``vals`` the
    row of one slot a distinct row in ``[0, V)`` (the contract makes the
    others copies of it) read, and that row written."""
    return KernelCost(0, 4 * (S + 2 * distinct_rows * D))


def distinct_rows(rows: torch.Tensor, V: int) -> int:
    """The distinct rows of ``rows`` inside ``[0, V)``: a wait for the device."""
    return int(torch.unique(rows[(rows >= 0) & (rows < V)]).numel())


def scatter_rows_set(table: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """table (V, D) float32, rows (S,) int32 non-decreasing, vals (S, D)
    float32: writes ``table[rows] = vals`` in place, returns ``table``."""
    check_tensor(table, "table", torch.float32, 2)
    check_tensor(rows, "rows", torch.int32, 1)
    check_tensor(vals, "vals", torch.float32, 2)
    (V, D), S = table.shape, rows.shape[0]
    if vals.shape != (S, D):
        raise ValueError(f"vals {tuple(vals.shape)} must be ({S}, {D})")
    on_cpu = kernel_device(table, rows, vals) == "cpu"
    with kernel_scope("scatter_rows_set", lambda: scatter_cost(S, D, distinct_rows(rows, V))):
        if on_cpu:
            return scatter_rows_plain(table, rows, vals)
        forward_only(table, vals)
        if V >= 2 ** 31:
            raise ValueError(f"scatter_rows_set kernel takes V < 2**31; got V={V}")
        if S == 0 or D == 0:
            return table
        launch("nrt_scatter_rows_set", table.data_ptr(), rows.data_ptr(), vals.data_ptr(),
               S, D, V, stream_ptr(table))
    with launch_count_lock:
        scatter_rows_set.launches += 1
    return table


scatter_rows_set.launches = 0
