"""DCN-v1 cross stack: CUDA kernels for Hopper and their plain PyTorch versions.

``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l`` for NL layers, with the rank-1
identity ``(x0 x_l^T) w == x0 * (x_l . w)`` in place of the B x D x D outer
product (reference ``dcn_arch.py:14-30``).

:func:`dcn_cross_stack` is a ``torch.autograd.Function``, as the JAX
package's is a ``jax.custom_vjp``. Forward: ``csrc/dcn_cross.cu``, entry
``nrt_dcn_cross_fwd``, which replaces the Pallas kernel
``news_recsys_tpu/ops/dcn_kernel.py::_cross_pallas``. It is bound by memory
(one read of x0, one write of out) and, at the ranker's sizes, by the
latency of that one trip: a row's loads come first, the layer weights
follow into shared memory beside them, and a group of lanes owns a row
(16-byte loads where the shape allows). When a gradient is needed it also
writes ``ss`` (NL, B), each layer's scalar ``s_l = x_l . w_l``, and nothing
else. Backward: :func:`dcn_cross_bwd`, ``csrc/dcn_cross_bwd.cu``, the
analytic VJP of the JAX package's ``_bwd`` in two launches: the first
rebuilds each ``x_l`` from x0, ``ss`` and ``bs`` by the forward's own
recurrence (:func:`rebuild_xs` is the plain version), writes dx0, and sums
each block's dw and db on chip into a partial a block; the second, by
programmatic dependent launch (its launch overlaps the first's tail), sums
the partials in an order fixed by the plan. :func:`plan_cross` lays out both
kernels' launches from the shape alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import KernelCost, check_tensor, kernel_device, kernel_scope, launch_count_lock, stream_ptr
from ._build import launch

MAX_D = 256                    # a row in at most 32 lanes of 8 floats
FWD_SMEM_BYTES = 48 * 1024     # the forward's weights in shared memory
MAX_LAYERS = 32                # the backward holds a row's NL scalars in its lanes
SMEM_BYTES = 232448            # a block's shared memory on the H100
FWD_WARPS = 4
BWD_WARPS = 8


class CrossPlan(NamedTuple):
    """How a launch of the cross stack's kernels is laid out (:func:`plan_cross`)."""
    vector: bool       # float4 chunks (16-byte loads and stores), else one float a chunk
    group: int         # lanes a row; 32 // group rows share a warp
    slots: int         # chunks a lane
    warps: int         # warps a block
    blocks: int
    partials: int      # block partials the backward writes to device memory
    smem_bytes: int    # dynamic shared memory a block: the weights, and the
                       # backward's dw/db sums, a row of them a warp


def plan_cross(B: int, D: int, NL: int, aligned: bool, sms: int, backward: bool) -> CrossPlan:
    """The launch of a (B, D) cross stack of NL layers on a card of ``sms``
    multiprocessors: a pure function of the shape and of ``aligned`` (every
    row pointer 16-byte aligned). A row is cut into chunks (float4s, or
    floats on the scalar path) over a power of two of lanes, so a dot
    product is a shuffle sum over the row's lanes alone. The forward takes
    the fewest lanes that hold a row at up to 4 float4s (8 floats) a lane,
    so rows share warps (at D 112, 8 lanes and 4 rows a warp), and gives
    every row its lanes at once, FWD_WARPS warps a block. The backward takes
    one chunk a lane, up to 32 lanes (several a lane past 32 chunks), and at
    least NL lanes (they hold the row's NL scalars), which keeps each lane's
    chain of dependent steps short; BWD_WARPS warps a block (more rows loop,
    past two blocks an SM), each writing its dw/db partial for the second
    launch to sum (``csrc/dcn_cross_bwd.cu``)."""
    vector = aligned and D % 4 == 0
    chunks = D // 4 if vector else D
    weights = 4 * 2 * NL * D
    if not backward:
        per_lane = 4 if vector else 8
        group = min(32, 1 << (-(-chunks // per_lane) - 1).bit_length())
        slots = 1 << (-(-chunks // group) - 1).bit_length()
        warps_needed = max(1, -(-B // (32 // group)))
        warps = min(FWD_WARPS, warps_needed)
        return CrossPlan(vector, group, slots, warps, -(-warps_needed // warps), 0, weights)
    group = min(32, 1 << (max(chunks, NL) - 1).bit_length())
    slots = 1 << (-(-chunks // group) - 1).bit_length()
    warps_needed = max(1, -(-B // (32 // group)))
    fit = SMEM_BYTES // weights - 1                 # dw/db rows beside the weights
    warps = max(1, min(BWD_WARPS, warps_needed, fit))
    blocks = min(-(-warps_needed // warps), 2 * sms)
    return CrossPlan(vector, group, slots, warps, blocks, cross_partials(blocks),
                     weights * (warps + 1))


def cross_partials(blocks: int) -> int:
    """The partials (2*NL*D floats each) the backward writes to device
    memory: one a block; none with one block, whose partial is the answer."""
    return blocks if blocks > 1 else 0


def cross_cost(B: int, D: int, NL: int, residuals: bool = False) -> KernelCost:
    """The forward's work: 5 operations an element a layer (the dot product's
    two, then ``x0 * s + b + x``'s three); x0 read, out written, the weights
    and biases read, and with ``residuals`` ``ss`` (NL, B) written."""
    return KernelCost(5 * NL * B * D, 4 * (2 * B * D + 2 * NL * D + (NL * B if residuals else 0)))


def cross_bwd_cost(B: int, D: int, NL: int) -> KernelCost:
    """The backward's work: 8 operations an element a layer; x0, g, ss, ws
    and bs read, dx0, dws and dbs written."""
    return KernelCost(8 * NL * B * D, 4 * (3 * B * D + NL * B + 4 * NL * D))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _plan(x0: torch.Tensor, NL: int, aligned: bool, backward: bool) -> CrossPlan:
    sms = torch.cuda.get_device_properties(x0.device).multi_processor_count
    return plan_cross(x0.shape[0], x0.shape[1], NL, aligned, sms, backward)


def cross_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The cross stack in plain PyTorch: the kernel's oracle."""
    x = x0
    for l in range(ws.shape[0]):
        s = x @ ws[l]                                   # (B,)
        x = x0 * s[:, None] + bs[l] + x
    return x


def cross_fwd_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor):
    """:func:`cross_plain` that also returns each layer's input and scalar:
    (out (B, D), xs (NL, B, D), ss (NL, B)). The CPU path's forward, which
    keeps ``ss`` for the backward."""
    x = x0
    xs, ss = [], []
    for l in range(ws.shape[0]):
        xs.append(x)
        s = x @ ws[l]
        ss.append(s)
        x = x0 * s[:, None] + bs[l] + x
    return x, torch.stack(xs), torch.stack(ss)


def rebuild_xs(x0: torch.Tensor, bs: torch.Tensor, ss: torch.Tensor) -> torch.Tensor:
    """Each layer's input x_l (NL, B, D) from x0, the biases and the
    forward's scalars ``ss``, by :func:`cross_fwd_plain`'s own recurrence, so
    it gives its ``xs`` bit for bit (the backward kernel does the same in
    registers)."""
    x, xs = x0, []
    for l in range(ss.shape[0]):
        xs.append(x)
        x = x0 * ss[l][:, None] + bs[l] + x
    return torch.stack(xs) if xs else x0.new_empty((0, *x0.shape))


def cross_bwd_plain(x0, ws, xs, ss, g):
    """The VJP of the cross stack in plain PyTorch, a transliteration of
    the JAX package's ``_bwd`` on its residuals (x0, ws, xs, ss):
    (dx0, dws, dbs)."""
    dx0_extra = torch.zeros_like(x0)
    dws, dbs = [], []
    for l in range(ws.shape[0] - 1, -1, -1):
        ds = (g * x0).sum(dim=1)                        # (B,)
        dws.append(xs[l].T @ ds)                        # (D,)
        dbs.append(g.sum(dim=0))                        # (D,)
        dx0_extra = dx0_extra + g * ss[l][:, None]
        g = g + ws[l][None, :] * ds[:, None]            # dL/dx_l
    return g + dx0_extra, torch.stack(dws[::-1]), torch.stack(dbs[::-1])


def cross_bwd_rebuild_plain(x0, ws, bs, ss, g):
    """:func:`cross_bwd_plain` on the port's residuals (x0, ws, bs, ss): the
    layer inputs rebuilt by :func:`rebuild_xs`. The oracle of
    :func:`dcn_cross_bwd` and its CPU path."""
    return cross_bwd_plain(x0, ws, rebuild_xs(x0, bs, ss), ss, g)


def reference_cross_stack(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Direct transliteration of the per-layer reference math:
    cross = (x0 x_l^T) w, with the outer product materialised."""
    x = x0
    for l in range(ws.shape[0]):
        outer = torch.einsum("bi,bj->bij", x0, x)       # (B, D, D)
        x = torch.einsum("bij,j->bi", outer, ws[l]) + bs[l] + x
    return x


def _check_limits(D: int, NL: int, backward: bool) -> None:
    if not 1 <= D <= MAX_D or 4 * 2 * NL * D > FWD_SMEM_BYTES:
        raise ValueError(f"the dcn_cross_stack kernels take 1 <= D <= {MAX_D} and "
                         f"2*NL*D*4 <= {FWD_SMEM_BYTES} bytes; got D={D}, NL={NL}")
    if backward and not 1 <= NL <= MAX_LAYERS:
        raise ValueError(f"the dcn_cross_stack backward kernel takes 1 <= NL <= {MAX_LAYERS}; "
                         f"got NL={NL}")


def _cross_fwd_kernel(x0, ws, bs, residuals: bool):
    """(out, ss) from ``nrt_dcn_cross_fwd``; ss (NL, B) only with ``residuals``."""
    B, D = x0.shape
    NL = ws.shape[0]
    _check_limits(D, NL, residuals)
    out = torch.empty_like(x0)
    ss = x0.new_empty((NL, B)) if residuals else None
    plan = _plan(x0, NL, _aligned(x0, ws, bs, out), False)
    launch("nrt_dcn_cross_fwd", x0.data_ptr(), ws.data_ptr(), bs.data_ptr(), out.data_ptr(),
           ss.data_ptr() if residuals else None, B, D, NL, int(plan.vector), plan.group,
           plan.slots, plan.warps, plan.blocks, stream_ptr(x0))
    with launch_count_lock:
        dcn_cross_stack.launches += 1
    return out, ss


def dcn_cross_bwd(x0, ws, bs, ss, g):
    """The cross stack's VJP from the forward's residuals: x0 (B, D), ws and
    bs (NL, D), ss (NL, B), g (B, D), float32 -> (dx0, dws, dbs).

    On CUDA tensors it calls ``nrt_dcn_cross_bwd``, which launches two
    kernels (one with one block): the layer inputs are rebuilt from ``ss``
    and ``bs``, and dws/dbs are summed in an order fixed by
    :func:`plan_cross`, so a run repeats its bits and nothing carries from
    one call to the next."""
    for t, name in ((x0, "x0"), (ws, "ws"), (bs, "bs"), (ss, "ss"), (g, "g")):
        check_tensor(t, name, torch.float32, 2)
    B, D = x0.shape
    NL = ws.shape[0]
    if (ws.shape[1] != D or bs.shape != ws.shape or ss.shape != (NL, B)
            or g.shape != x0.shape):
        raise ValueError(f"shapes do not match x0 {tuple(x0.shape)}, ws {tuple(ws.shape)}: "
                         f"bs {tuple(bs.shape)}, ss {tuple(ss.shape)}, g {tuple(g.shape)}")
    on_cpu = kernel_device(x0, ws, bs, ss, g) == "cpu"
    with kernel_scope("dcn_cross_bwd", lambda: cross_bwd_cost(B, D, NL)):
        if on_cpu:
            return cross_bwd_rebuild_plain(x0, ws, bs, ss, g)
        _check_limits(D, NL, backward=True)
        out = _launch_cross_bwd(lambda *a: launch("nrt_dcn_cross_bwd", *a), x0, ws, bs, ss, g)
    with launch_count_lock:
        dcn_cross_bwd.launches += 1
    return out


def _launch_cross_bwd(entry, x0, ws, bs, ss, g):
    """The body of :func:`dcn_cross_bwd` on checked CUDA tensors: allocates
    the outputs and the partials, lays out the launch by :func:`plan_cross`
    and calls ``entry`` (a callable that takes ``nrt_dcn_cross_bwd``'s
    arguments and raises if the launch fails) -> (dx0, dws, dbs). It counts
    nothing; ``chip_profile.py`` passes the entry of a copy of the source."""
    B, D = x0.shape
    NL = ws.shape[0]
    dx0 = torch.empty_like(x0)
    dws, dbs = torch.empty_like(ws), torch.empty_like(ws)
    plan = _plan(x0, NL, _aligned(x0, ws, bs, g, dx0), True)
    partial = x0.new_empty((plan.partials, 2, NL, D))          # none with one block
    entry(x0.data_ptr(), ws.data_ptr(), bs.data_ptr(), ss.data_ptr(), g.data_ptr(),
          dx0.data_ptr(), dws.data_ptr(), dbs.data_ptr(), partial.data_ptr(), B, D, NL,
          int(plan.vector), plan.group, plan.slots, plan.warps, plan.blocks, stream_ptr(x0))
    return dx0, dws, dbs


class _CrossStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, ws, bs):
        need = any(ctx.needs_input_grad)
        with kernel_scope("dcn_cross_stack", lambda: cross_cost(*x0.shape, ws.shape[0], need)):
            if x0.device.type == "cpu":
                out, _, ss = cross_fwd_plain(x0, ws, bs)
            else:
                out, ss = _cross_fwd_kernel(x0, ws, bs, residuals=need)
        if need:
            ctx.save_for_backward(x0, ws, bs, ss)
        return out

    @staticmethod
    def backward(ctx, g):
        return dcn_cross_bwd(*ctx.saved_tensors, g.contiguous())


def dcn_cross_stack(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """x0 (B, D), ws (NL, D), bs (NL, D), float32 -> (B, D) after NL cross
    layers; differentiable in all three."""
    check_tensor(x0, "x0", torch.float32, 2)
    check_tensor(ws, "ws", torch.float32, 2)
    check_tensor(bs, "bs", torch.float32, 2)
    if ws.shape[1] != x0.shape[1] or bs.shape != ws.shape:
        raise ValueError(f"ws {tuple(ws.shape)} and bs {tuple(bs.shape)} must both be "
                         f"(NL, {x0.shape[1]})")
    kernel_device(x0, ws, bs)
    return _CrossStack.apply(x0, ws, bs)


dcn_cross_stack.launches = 0
dcn_cross_bwd.launches = 0
