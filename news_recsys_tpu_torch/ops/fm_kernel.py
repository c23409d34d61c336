"""FM second-order interaction: CUDA kernels for Hopper and their plain
PyTorch versions.

``out[b] = 0.5 * sum_d [(sum_f v_bfd)^2 - sum_f v_bfd^2]``, the
½[(Σv)² − Σv²] identity of the reference (``fm/model.py:18-26``), with the
analytic gradient ``dv_bfd = (sum_f' v_bf'd - v_bfd) * g_b``.

:func:`fm_second_order` is a ``torch.autograd.Function``, as the JAX
package's is a ``jax.custom_vjp``. Forward: ``csrc/fm_second_order.cu``,
entry ``nrt_fm_fwd``, which replaces the Pallas kernel
``news_recsys_tpu/ops/fm_kernel.py::_fm_pallas``; backward:
:func:`fm_second_order_bwd`, entry ``nrt_fm_bwd``, the JAX package's XLA
``_bwd``. Both are bound by memory and read each element of ``v`` once; at
DeepFM's sizes (a few hundred KB) what they cost is the launch and one trip
to memory, so the designs keep every lane at work and issue a thread's loads
together.

At DeepFM's 5 fields of 15 columns both take a staged path, F and D fixed
at compile time so their loops unroll: a block copies its rows' contiguous
span of ``v`` into shared memory with 16-byte copies. The forward (32 rows
a block) then sums each row over 8 lanes, every 8th column each, which meet
in three shuffles, so one of a row's 8 lanes idles where 17 of a warp's 32
did. The backward (``FM_BWD_ROWS`` rows a block, ``g``'s values copied
beside the span) is an elementwise pass over the span: a table of the
rows' ``sum_f v`` in shared memory, then a float4 of ``dv`` a thread,
written with one 16-byte store.
Every other shape takes the general path, one warp a row, a lane a column
(the first design). The C entries pick the path by shape; :func:`plan_fm_fwd`
and :func:`plan_fm_bwd` state the choice and the block. Every reduction
stays inside a row in a fixed order, so a run repeats its bits. The kernels
take any B (the Pallas path fell back to XLA when B was not a multiple of
its tile).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import KernelCost, check_tensor, kernel_device, kernel_scope, launch_count_lock, stream_ptr

# the forward as csrc/fm_second_order.cu launches it: (F, D) of DeepFM take
# the staged path, a block of FM_ROWS rows of FM_LANES lanes; other shapes
# the general one, a warp a row, FM_GENERAL_ROWS rows a block
FM_STAGED_SHAPE = (5, 15)
FM_ROWS = 32
FM_LANES = 8
FM_GENERAL_ROWS = 8
# the backward's staged block: FM_BWD_ROWS rows (a multiple of 4), a float4 of
# their span a thread
FM_BWD_ROWS = 8


class FmPlan(NamedTuple):
    path: str               # "staged" or "general"
    rows: int               # a block's
    threads: int            # a block's: the forward's FM_LANES (staged) or 32
                            # (general) a row; the staged backward's a float4
                            # of the block's span each, in whole warps
    blocks: int
    smem_bytes: int         # dynamic shared memory a block


def plan_fm_fwd(B: int, F: int, D: int) -> FmPlan:
    """The forward's launch, a pure function of the shape. A staged block's
    shared memory is its span of ``FM_ROWS * F * D`` floats and up to 3 in
    front of it (which put its 16-byte copies on 16-byte boundaries), in
    whole float4s."""
    if (F, D) != FM_STAGED_SHAPE:
        return FmPlan("general", FM_GENERAL_ROWS, 32 * FM_GENERAL_ROWS,
                      -(-B // FM_GENERAL_ROWS), 0)
    return FmPlan("staged", FM_ROWS, FM_ROWS * FM_LANES, -(-B // FM_ROWS),
                  16 * ((FM_ROWS * F * D + 6) // 4))


def plan_fm_bwd(B: int, F: int, D: int) -> FmPlan:
    """The backward's launch, a pure function of the shape. A staged block
    makes a float4 of its span a thread, in whole warps; its shared memory is
    the span as the forward's, ``g``'s FM_BWD_ROWS values and a table of the
    FM_BWD_ROWS x D sums ``sum_f v``."""
    if (F, D) != FM_STAGED_SHAPE:
        return FmPlan("general", FM_GENERAL_ROWS, 32 * FM_GENERAL_ROWS,
                      -(-B // FM_GENERAL_ROWS), 0)
    threads = 32 * -(-(FM_BWD_ROWS * F * D // 4) // 32)
    smem = 16 * ((FM_BWD_ROWS * F * D + 6) // 4) + 4 * FM_BWD_ROWS * (1 + D)
    return FmPlan("staged", FM_BWD_ROWS, threads, -(-B // FM_BWD_ROWS), smem)


def fm_plain(v: torch.Tensor) -> torch.Tensor:
    """The forward in plain PyTorch (the JAX package's ``_fm_xla``): the CPU
    path and the kernel's oracle."""
    sum_v = v.sum(dim=1)
    return 0.5 * (sum_v * sum_v - (v * v).sum(dim=1)).sum(dim=1)


def fm_bwd_plain(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP in plain PyTorch (the JAX package's ``_bwd``)."""
    return (v.sum(dim=1, keepdim=True) - v) * g[:, None, None]


def fm_cost(B: int, F: int, D: int) -> KernelCost:
    """The forward's work: 4 operations an element of ``v`` (its sum, its
    square, their sums); ``v`` read, ``out`` (B,) written."""
    return KernelCost(4 * B * F * D, 4 * (B * F * D + B))


def fm_bwd_cost(B: int, F: int, D: int) -> KernelCost:
    """The backward's work: 3 operations an element (the field sum, the
    difference, the product with ``g``); ``v`` and ``g`` read, ``dv`` written."""
    return KernelCost(3 * B * F * D, 4 * (2 * B * F * D + B))


def _kernel_shape(v: torch.Tensor):
    B, F, D = v.shape
    if B >= 2 ** 31 or F * D >= 2 ** 31:
        raise ValueError(f"the fm_second_order kernels take B, F*D < 2**31; got {tuple(v.shape)}")
    return B, F, D


def _fm_fwd_kernel(v: torch.Tensor) -> torch.Tensor:
    from ._build import launch

    B, F, D = _kernel_shape(v)
    out = v.new_empty((B,))
    if B == 0:
        return out
    launch("nrt_fm_fwd", v.data_ptr(), out.data_ptr(), B, F, D, stream_ptr(v))
    with launch_count_lock:
        fm_second_order.launches += 1
    return out


def fm_second_order_bwd(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v (B, F, D), g (B,), float32 -> dv (B, F, D). On CUDA tensors it
    launches ``nrt_fm_bwd``."""
    check_tensor(v, "v", torch.float32, 3)
    check_tensor(g, "g", torch.float32, 1)
    if g.shape[0] != v.shape[0]:
        raise ValueError(f"g {tuple(g.shape)} must be ({v.shape[0]},)")
    on_cpu = kernel_device(v, g) == "cpu"
    with kernel_scope("fm_second_order_bwd", lambda: fm_bwd_cost(*v.shape)):
        if on_cpu:
            return fm_bwd_plain(v, g)
        from ._build import launch

        B, F, D = _kernel_shape(v)
        dv = torch.empty_like(v)
        if B == 0:
            return dv
        launch("nrt_fm_bwd", v.data_ptr(), g.data_ptr(), dv.data_ptr(), B, F, D, stream_ptr(v))
    with launch_count_lock:
        fm_second_order_bwd.launches += 1
    return dv


class _FM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(v)
        with kernel_scope("fm_second_order", lambda: fm_cost(*v.shape)):
            return fm_plain(v) if v.device.type == "cpu" else _fm_fwd_kernel(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return fm_second_order_bwd(v, g.contiguous())


def fm_second_order(v: torch.Tensor) -> torch.Tensor:
    """(B, F, D) float32 field latent vectors -> (B,) second-order
    interaction; differentiable in ``v``."""
    check_tensor(v, "v", torch.float32, 3)
    kernel_device(v)
    return _FM.apply(v)


fm_second_order.launches = 0
fm_second_order_bwd.launches = 0
