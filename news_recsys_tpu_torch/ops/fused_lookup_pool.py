"""Fused embedding lookup + masked mean pool: CUDA kernels for Hopper
(forward and backward) and their plain PyTorch versions.

``out[b] = sum_l w[b,l] table[ids[b,l]] / (sum_l w[b,l] + 1e-8)`` with
``w = mask * (ids != 0)``: padding id 0 carries no weight, as in the
reference pooling (``base_model.py:273-282``).

The kernel (``csrc/lookup_pool.cu``, entry ``nrt_lookup_pool_fwd``) replaces
the Pallas kernel ``news_recsys_tpu/ops/fused_lookup_pool.py::_pool_pallas``.
It is bound by the latency of two dependent reads, the ids and then the
rows: one warp per batch row reads the row's ids and mask in one coalesced
load and issues every table-row read of the example (16-byte loads where
D allows) before the first add, and writes only (B, D), so the (B, L, D)
gather never reaches device memory. Rows of at most 8 slots keep the first
design's loop over the slots, which is as fast there.

:func:`fused_lookup_pool` is a ``torch.autograd.Function`` in the table,
as the JAX package's is a ``jax.custom_vjp``. Its backward,
:func:`fused_lookup_pool_bwd` (``csrc/lookup_pool_bwd.cu``, entry
``nrt_lookup_pool_bwd``), replaces the JAX package's XLA ``_bwd``: the dense
(V, D) gradient ``grad_table[ids] += g * w / (sum w + 1e-8)``. It sorts
nothing: every term is added as an integer, scaled by a power of two from
its row's largest term (:func:`fixed_point_bits`), so the order of the
additions cannot change the result: two runs give the same bits, and a hot
id's terms go to one row's integer atomics from every warp at once, not in
a walk. One memset and three launches; the wrapper allocates the kernel's
scratch (:func:`pool_bwd_scratch`).

Ids outside ``[0, V)``: the pooled row is NaN, whatever the mask, as the
JAX package's XLA gather gives (``jnp.take`` fills out-of-range rows with
NaN); the backward drops them, negative ones too, as JAX's scatter-add
drops ids >= V. Negative ids never reach here from a request: the HTTP
boundary rejects them.
"""

from __future__ import annotations

import torch

from . import (KernelCost, check_tensor, kernel_device, kernel_scope, launch_count_lock,
               open_counter, stream_ptr)
from ._build import launch

EPS = 1e-8
MAX_D = 256


def reference_lookup_pool(table: torch.Tensor, ids: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Gather then pool in plain PyTorch: the CPU path and the kernel's oracle."""
    V = table.shape[0]
    bad = (ids < 0) | (ids >= V)
    # F.embedding, not table[ids]: the indexing's backward (index_put_ with
    # accumulate) sums in a run-dependent order on the CPU
    rows = torch.nn.functional.embedding(ids.clamp(0, V - 1).long(), table)   # (B, L, D)
    rows = rows.masked_fill(bad[..., None], float("nan"))
    w = mask * (ids != 0).to(mask.dtype)
    return (rows * w[..., None]).sum(dim=1) / (w.sum(dim=1, keepdim=True) + EPS)


def pool_bwd_plain(ids: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                   V: int) -> torch.Tensor:
    """The table's gradient in plain PyTorch (the JAX package's ``_bwd``):
    ids (B, L), mask (B, L), g (B, D) -> (V, D). Ids outside [0, V) are
    dropped: they add a zero to a row inside, so that nothing here waits
    for the device."""
    keep = (ids >= 0) & (ids < V)
    w = mask * ((ids != 0) & keep).to(mask.dtype)
    denom = (mask * (ids != 0).to(mask.dtype)).sum(dim=1, keepdim=True) + EPS
    contrib = (g / denom)[:, None, :] * w[..., None]                                # (B, L, D)
    grad = g.new_zeros((V, g.shape[1]))
    return grad.index_add_(0, ids.clamp(0, V - 1).reshape(-1).long(),
                           contrib.reshape(-1, g.shape[1]))


def pool_cost(B: int, L: int, D: int, rows: int) -> KernelCost:
    """The forward's work: a multiply and an add an element of each slot's
    row; each of the ``rows`` distinct rows its weighted slots point at read
    once, the ids and mask read, (B, D) written."""
    return KernelCost(2 * B * L * D, 4 * (rows * D + 2 * B * L + B * D))


def pooled_rows(ids: torch.Tensor, mask: torch.Tensor) -> int:
    """The distinct ids of the slots with weight: a wait for the device."""
    return int(torch.unique(ids[(mask * (ids != 0)) > 0]).numel())


def pool_bwd_cost(B: int, L: int, D: int, V: int) -> KernelCost:
    """The backward's work: a multiply and an add an element of each slot's
    term; ``g``, the ids and mask read, the dense (V, D) gradient written."""
    return KernelCost(2 * B * L * D, 4 * (V * D + B * D + 2 * B * L))


def _check(ids, mask):
    check_tensor(ids, "ids", torch.int32, 2)
    check_tensor(mask, "mask", torch.float32, 2)
    if mask.shape != ids.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match ids {tuple(ids.shape)}")


def _kernel_limits(D: int, V: int):
    if not 1 <= D <= MAX_D or V >= 2 ** 31:
        raise ValueError(f"the fused_lookup_pool kernels take 1 <= D <= {MAX_D} and "
                         f"V < 2**31; got D={D}, V={V}")


def _fwd_kernel(table, ids, mask) -> torch.Tensor:
    (V, D), (B, L) = table.shape, ids.shape
    _kernel_limits(D, V)
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    launch("nrt_lookup_pool_fwd", table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
           out.data_ptr(), B, L, D, V, stream_ptr(table))
    with launch_count_lock:
        fused_lookup_pool.launches += 1
    return out


def fixed_point_bits(S: int) -> int:
    """P, the backward kernel's integer grain: a term t of a row whose largest
    term is below 2^e is added as round(t * 2^(P - e)), at most 2^P in size,
    so the S = B*L terms a row can take sum to at most 2^62: P = 62 - (the
    bits of S)."""
    return 62 - max(S, 0).bit_length()


def pool_bwd_scratch(B: int, L: int, D: int, V: int, device) -> tuple:
    """The backward kernel's scratch, uninitialised: (state (2V) int32, each
    row's exponent and accumulator index; coef (B*L) float32; acc (B*L * D)
    int64 and flags (B*L * D) int32: an accumulator row a slot, which the
    first slot to touch a table row lends it)."""
    return (torch.empty(2 * V, dtype=torch.int32, device=device),
            torch.empty(B * L, dtype=torch.float32, device=device),
            torch.empty(B * L * D, dtype=torch.int64, device=device),
            torch.empty(B * L * D, dtype=torch.int32, device=device))


def fused_lookup_pool_bwd(ids: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                          V: int) -> torch.Tensor:
    """ids (B, L) int32, mask (B, L) float32, g (B, D) float32 -> the (V, D)
    gradient of the table. On CUDA tensors it launches ``nrt_lookup_pool_bwd``."""
    check_tensor(g, "g", torch.float32, 2)
    _check(ids, mask)
    if g.shape[0] != ids.shape[0]:
        raise ValueError(f"g {tuple(g.shape)} must have {ids.shape[0]} rows")
    (B, L), D = ids.shape, g.shape[1]
    on_cpu = kernel_device(ids, mask, g) == "cpu"
    with kernel_scope("fused_lookup_pool_bwd", lambda: pool_bwd_cost(B, L, D, V)):
        if on_cpu:
            return pool_bwd_plain(ids, mask, g, V)
        _kernel_limits(D, V)
        if B * L * D >= 2 ** 31:
            raise ValueError(f"the fused_lookup_pool backward takes B*L*D < 2**31; got "
                             f"B={B}, L={L}, D={D}")
        grad = g.new_empty((V, D))
        scratch = pool_bwd_scratch(B, L, D, V, g.device)
        launch("nrt_lookup_pool_bwd", ids.data_ptr(), mask.data_ptr(), g.data_ptr(),
               grad.data_ptr(), *(t.data_ptr() for t in scratch), B, L, D, V,
               fixed_point_bits(B * L), stream_ptr(g))
    with launch_count_lock:
        fused_lookup_pool_bwd.launches += 1
    return grad


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mask):
        ctx.V = table.shape[0]
        ctx.save_for_backward(ids, mask)
        with kernel_scope("fused_lookup_pool", lambda: pool_cost(*ids.shape, table.shape[1],
                                                                 pooled_rows(ids, mask))):
            if table.device.type == "cpu":
                return reference_lookup_pool(table, ids, mask)
            return _fwd_kernel(table, ids, mask)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        return fused_lookup_pool_bwd(ids, mask, g.contiguous(), ctx.V), None, None


def fused_lookup_pool(table: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """table (V, D) float32, ids (B, L) int32, mask (B, L) float32 -> (B, D);
    differentiable in ``table``. On the CPU it is the plain version's own
    autograd, but under an open cost counter, where it takes the kernels'
    autograd path with their plain bodies, as the card runs it."""
    check_tensor(table, "table", torch.float32, 2)
    _check(ids, mask)
    if kernel_device(table, ids, mask) == "cpu" and open_counter() is None:
        return reference_lookup_pool(table, ids, mask)
    return _Pool.apply(table, ids, mask)


fused_lookup_pool.launches = 0
fused_lookup_pool_bwd.launches = 0
