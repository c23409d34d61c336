"""NRMS's masked multi-head self-attention without bias: a CUDA kernel pair
for Hopper and its plain PyTorch version.

``qkv`` (N, L, 3 H hd) is ``x @ [Q | K | V]`` as it lies, head k in columns
``k hd .. (k + 1) hd`` of each third; ``mask`` (N, L) bool keeps a key.
``alpha = softmax_s(q_t . k_s / sqrt(hd))`` over the kept keys and
``out_t = concat_k sum_s alpha_ts v_s``, (N, L, H hd), the layout
``models/nrms.py::AdditivePool`` reads. A row with no kept key attends
uniformly over its L keys, as the softmax of L scores at -1e9 does.

:func:`masked_mhsa` is a ``torch.autograd.Function``. Forward:
``csrc/nrms_attention.cu``, entry ``nrt_mhsa_fwd``; backward:
:func:`masked_mhsa_bwd`, entry ``nrt_mhsa_bwd``, which recomputes the
scores from ``qkv`` and writes dQ, dK and dV into one packed (N, L, 3 H hd)
gradient. Neither replaces a TPU kernel (the JAX package has no NRMS); they
replace the chain of library calls of :func:`masked_mhsa_plain` (permute,
``q @ k^T``, ``torch.where``, softmax, ``alpha @ v``, transpose and reshape,
and their backward), and never materialise the (N, H, L, L) scores. Both are
bound by memory; the source says how the design moves each byte once. The
kernels take L up to 128, hd 8, 16, 32 or 64 and any number of heads; a CUDA
tensor outside that raises. A block owns one row and the heads of its plan
(:func:`plan_mhsa`), and sums in a fixed order with no atomics, so a run
repeats its bits.

On the CPU :func:`masked_mhsa` runs the plain version's own autograd, but
under an open cost counter the kernels' autograd path with their plain
bodies, as the card runs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import (KernelCost, aligned16, check_tensor, kernel_device, kernel_scope,
               launch_count_lock, open_counter, stream_ptr)
from ._build import launch

NEG = -1e9              # a masked position's score before the softmax
MAX_LEN = 128
HEAD_DIMS = (8, 16, 32, 64)
MAX_WARPS = 4           # a block's warps at most
PAD = 4                 # floats after each staged row (csrc/nrms_attention.cu: kPad)


class MhsaPlan(NamedTuple):
    heads_per_block: int    # G: a divisor of H
    warps_per_head: int     # W = ceil(L / 32): a warp for each 32 query rows
    threads: int            # G W 32
    blocks: int             # N H / G
    fwd_smem_bytes: int     # the row's K and V of the block's heads, and the mask
    bwd_smem_bytes: int     # its Q, K, V and dO, each query row's max, sum and D, the mask


def plan_mhsa(N: int, L: int, H: int, hd: int) -> MhsaPlan:
    """The kernels' launch, a pure function of the shape: as many heads to a
    block as divide H and fit in MAX_WARPS warps. Raises outside the
    kernels' domain."""
    if not 1 <= L <= MAX_LEN or hd not in HEAD_DIMS or H < 1 or N < 0:
        raise ValueError(f"the masked_mhsa kernels take 1 <= L <= {MAX_LEN}, head_dim in "
                         f"{HEAD_DIMS} and H >= 1; got N={N}, L={L}, H={H}, head_dim={hd}")
    if N * L * 3 * H * hd >= 2 ** 62 or N >= 2 ** 31:
        raise ValueError(f"the masked_mhsa kernels take N < 2**31; got N={N}")
    W = -(-L // 32)
    G = max(g for g in range(1, MAX_WARPS // W + 1) if H % g == 0)
    if H // G > 65535:
        raise ValueError(f"the masked_mhsa kernels take at most {65535 * G} heads; got {H}")
    rows = L * (G * hd + PAD) * 4
    return MhsaPlan(G, W, G * W * 32, N * H // G, 16 * -(-(2 * rows + L) // 16),
                    16 * -(-(4 * rows + 3 * G * L * 4 + L) // 16))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, a masked position at -1e9 (``mask``
    broadcasts to ``scores``; True keeps)."""
    return torch.softmax(torch.where(mask, scores, NEG), dim=-1)


def masked_mhsa_plain(qkv: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """The forward in plain PyTorch, the chain of library calls NRMS ran
    before the kernel (the masked softmax :func:`masked_softmax`): the CPU
    path and the kernels' oracle."""
    N, L, width = qkv.shape
    hd = width // (3 * heads)
    q, k, v = qkv.reshape(N, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    alpha = masked_softmax(scores, mask[:, None, None, :])
    return (alpha @ v).transpose(1, 2).reshape(N, L, heads * hd)


def masked_mhsa_bwd_plain(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """The VJP in plain PyTorch: autograd through :func:`masked_mhsa_plain`,
    ``g`` (N, L, H hd) -> the packed (N, L, 3 H hd) gradient of ``qkv``."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        return torch.autograd.grad(masked_mhsa_plain(x, mask, heads), x, g)[0]


def mhsa_cost(N: int, L: int, H: int, hd: int) -> KernelCost:
    """The forward's work: the products ``q k^T`` and ``alpha v``, a multiply
    and an add each (the softmax's few operations a score left out); ``qkv``
    and the mask (a byte a key) read, the output written."""
    return KernelCost(4 * N * H * L * L * hd, 4 * 4 * N * L * H * hd + N * L)


def mhsa_bwd_cost(N: int, L: int, H: int, hd: int) -> KernelCost:
    """The backward's work: the products dP = dO v^T, dS k, dS^T q and
    P^T dO (the scores' recomputation left out); ``qkv``, ``dO`` and the mask
    read, the packed gradient written."""
    return KernelCost(8 * N * H * L * L * hd, 4 * 7 * N * L * H * hd + N * L)


def _check(qkv: torch.Tensor, mask: torch.Tensor, heads: int):
    """(N, L, H, hd) of the inputs; raises on a shape, type or layout the
    kernels do not take."""
    if not isinstance(qkv, torch.Tensor) or qkv.dim() != 3:
        raise ValueError(f"qkv must be a 3-D tensor (N, L, 3 heads head_dim), got "
                         f"{getattr(qkv, 'shape', type(qkv).__name__)}")
    N, L, width = qkv.shape
    if heads < 1 or width % (3 * heads):
        raise ValueError(f"qkv's last dimension {width} must be 3 x heads x head_dim "
                         f"(heads {heads})")
    check_tensor(mask, "mask", torch.bool, 2)
    if tuple(mask.shape) != (N, L):
        raise ValueError(f"mask {tuple(mask.shape)} must be {(N, L)}")
    return N, L, heads, width // (3 * heads)


def _fwd_kernel(qkv: torch.Tensor, mask: torch.Tensor, N: int, L: int, H: int,
                hd: int) -> torch.Tensor:
    check_tensor(qkv, "qkv", torch.float32, 3)
    plan = plan_mhsa(N, L, H, hd)
    out = qkv.new_empty((N, L, H * hd))
    if N == 0:
        return out
    qkv = aligned16(qkv)
    launch("nrt_mhsa_fwd", qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), N, L, H, hd,
           plan.heads_per_block, plan.warps_per_head, 1.0 / math.sqrt(hd), stream_ptr(qkv))
    with launch_count_lock:
        masked_mhsa.launches += 1
    return out


def masked_mhsa_bwd(qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """qkv (N, L, 3 H hd), mask (N, L) bool, g (N, L, H hd) -> the packed
    gradient of ``qkv``. On CUDA tensors it launches ``nrt_mhsa_bwd``."""
    N, L, H, hd = _check(qkv, mask, heads)
    if tuple(g.shape) != (N, L, H * hd):
        raise ValueError(f"g {tuple(g.shape)} must be {(N, L, H * hd)}")
    on_cpu = kernel_device(qkv, mask, g) == "cpu"
    with kernel_scope("masked_mhsa_bwd", lambda: mhsa_bwd_cost(N, L, H, hd)):
        if on_cpu:
            return masked_mhsa_bwd_plain(qkv, mask, g, heads)
        check_tensor(qkv, "qkv", torch.float32, 3)
        check_tensor(g, "g", torch.float32, 3)
        plan = plan_mhsa(N, L, H, hd)
        dqkv = torch.empty_like(qkv)
        if N == 0:
            return dqkv
        qkv, g = aligned16(qkv), aligned16(g)
        launch("nrt_mhsa_bwd", qkv.data_ptr(), mask.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
               N, L, H, hd, plan.heads_per_block, plan.warps_per_head, 1.0 / math.sqrt(hd),
               stream_ptr(qkv))
    with launch_count_lock:
        masked_mhsa_bwd.launches += 1
    return dqkv


class _Mhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv, mask)
        dims = _check(qkv, mask, heads)
        with kernel_scope("masked_mhsa", lambda: mhsa_cost(*dims)):
            if qkv.device.type == "cpu":
                return masked_mhsa_plain(qkv, mask, heads)
            return _fwd_kernel(qkv, mask, *dims)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        return masked_mhsa_bwd(qkv, mask, g.contiguous(), ctx.heads), None, None


def masked_mhsa(qkv: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv (N, L, 3 heads head_dim), mask (N, L) bool -> (N, L, heads
    head_dim); differentiable in ``qkv``. CUDA tensors take the kernels
    (float32, contiguous, in their domain, else it raises); CPU tensors the
    plain version's own autograd, or under an open cost counter the kernels'
    autograd path with their plain bodies."""
    _check(qkv, mask, heads)
    if kernel_device(qkv, mask) == "cpu" and open_counter() is None:
        return masked_mhsa_plain(qkv, mask, heads)
    return _Mhsa.apply(qkv, mask, heads)


masked_mhsa.launches = 0
masked_mhsa_bwd.launches = 0
