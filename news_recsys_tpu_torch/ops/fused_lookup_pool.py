"""Fused embedding lookup + masked mean pool: a CUDA kernel for Hopper and
its plain PyTorch version.

``out[b] = sum_l w[b,l] table[ids[b,l]] / (sum_l w[b,l] + 1e-8)`` with
``w = mask * (ids != 0)``: padding id 0 carries no weight, as in the
reference pooling (``base_model.py:273-282``).

The kernel (``csrc/lookup_pool.cu``, entry ``nrt_lookup_pool_fwd``) replaces
the Pallas kernel ``news_recsys_tpu/ops/fused_lookup_pool.py::_pool_pallas``.
It is bound by the B*L*D*4 gathered bytes: one warp per batch row reads
whole table rows coalesced (several ids at once when D < 32), sums them in
registers and writes only (B, D), so the (B, L, D) gather never reaches
device memory.

Ids outside ``[0, V)``: the pooled row is NaN, whatever the mask, as the
JAX package's XLA gather gives (``jnp.take`` fills out-of-range rows with
NaN). Negative ids never reach here from a request: the HTTP boundary
rejects them.
"""

from __future__ import annotations

import torch

from . import check_tensor, forward_only, kernel_device, launch_count_lock, stream_ptr

EPS = 1e-8
MAX_D = 256


def reference_lookup_pool(table: torch.Tensor, ids: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Gather then pool in plain PyTorch: the CPU path and the kernel's oracle."""
    V = table.shape[0]
    bad = (ids < 0) | (ids >= V)
    rows = table[ids.clamp(0, V - 1).long()]                       # (B, L, D)
    rows = rows.masked_fill(bad[..., None], float("nan"))
    w = mask * (ids != 0).to(mask.dtype)
    return (rows * w[..., None]).sum(dim=1) / (w.sum(dim=1, keepdim=True) + EPS)


def fused_lookup_pool(table: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """table (V, D) float32, ids (B, L) int32, mask (B, L) float32 -> (B, D)."""
    check_tensor(table, "table", torch.float32, 2)
    check_tensor(ids, "ids", torch.int32, 2)
    check_tensor(mask, "mask", torch.float32, 2)
    if mask.shape != ids.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match ids {tuple(ids.shape)}")
    (V, D), (B, L) = table.shape, ids.shape
    if kernel_device(table, ids, mask) == "cpu":
        return reference_lookup_pool(table, ids, mask)
    forward_only(table, ids, mask)
    if not 1 <= D <= MAX_D or V >= 2 ** 31:
        raise ValueError(f"fused_lookup_pool kernel takes 1 <= D <= {MAX_D} and "
                         f"V < 2**31; got D={D}, V={V}")
    from ._build import launch

    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    launch("nrt_lookup_pool_fwd", table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
           out.data_ptr(), B, L, D, V, stream_ptr(table))
    with launch_count_lock:
        fused_lookup_pool.launches += 1
    return out


fused_lookup_pool.launches = 0
