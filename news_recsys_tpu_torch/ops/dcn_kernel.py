"""DCN-v1 cross stack: CUDA kernels for Hopper and their plain PyTorch versions.

``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l`` for NL layers, with the rank-1
identity ``(x0 x_l^T) w == x0 * (x_l . w)`` in place of the B x D x D outer
product (reference ``dcn_arch.py:14-30``).

:func:`dcn_cross_stack` is a ``torch.autograd.Function``, as the JAX
package's is a ``jax.custom_vjp``. Forward: ``csrc/dcn_cross.cu``, entry
``nrt_dcn_cross_fwd``, which replaces the Pallas kernel
``news_recsys_tpu/ops/dcn_kernel.py::_cross_pallas``. It is bound by memory
(one read of x0, one write of out): one warp per row keeps x0 and x in
registers, the layer weights sit in shared memory, and each ``s_l`` is a
warp-shuffle sum, so no intermediate x reaches device memory. When a
gradient is needed it also writes the per-layer inputs ``xs`` and scalars
``ss``. Backward: :func:`dcn_cross_bwd`, ``csrc/dcn_cross_bwd.cu``, the
analytic VJP of the JAX package's ``_bwd`` from those residuals.
"""

from __future__ import annotations

import torch

from . import check_tensor, kernel_device, launch_count_lock, stream_ptr

MAX_D = 256                    # 8 values per lane
MAX_SHARED_FLOATS = 48 * 1024 // 4
# the backward kernel: 8 warps per block, each with its own dw/db slice of
# shared memory beside the weights; up to 2 blocks per SM of the H100's 132
BWD_WARPS = 8
BWD_MAX_SHARED_FLOATS = 232448 // 4
BWD_MAX_BLOCKS = 264


def cross_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The cross stack in plain PyTorch: the kernel's oracle."""
    x = x0
    for l in range(ws.shape[0]):
        s = x @ ws[l]                                   # (B,)
        x = x0 * s[:, None] + bs[l] + x
    return x


def cross_fwd_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor):
    """:func:`cross_plain` that also returns the backward's residuals:
    (out (B, D), xs (NL, B, D), ss (NL, B)). The CPU path's forward."""
    x = x0
    xs, ss = [], []
    for l in range(ws.shape[0]):
        xs.append(x)
        s = x @ ws[l]
        ss.append(s)
        x = x0 * s[:, None] + bs[l] + x
    return x, torch.stack(xs), torch.stack(ss)


def cross_bwd_plain(x0, ws, xs, ss, g):
    """The VJP of the cross stack in plain PyTorch, a transliteration of
    the JAX package's ``_bwd``: (dx0, dws, dbs)."""
    dx0_extra = torch.zeros_like(x0)
    dws, dbs = [], []
    for l in range(ws.shape[0] - 1, -1, -1):
        ds = (g * x0).sum(dim=1)                        # (B,)
        dws.append(xs[l].T @ ds)                        # (D,)
        dbs.append(g.sum(dim=0))                        # (D,)
        dx0_extra = dx0_extra + g * ss[l][:, None]
        g = g + ws[l][None, :] * ds[:, None]            # dL/dx_l
    return g + dx0_extra, torch.stack(dws[::-1]), torch.stack(dbs[::-1])


def reference_cross_stack(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Direct transliteration of the per-layer reference math:
    cross = (x0 x_l^T) w, with the outer product materialised."""
    x = x0
    for l in range(ws.shape[0]):
        outer = torch.einsum("bi,bj->bij", x0, x)       # (B, D, D)
        x = torch.einsum("bij,j->bi", outer, ws[l]) + bs[l] + x
    return x


def _cross_fwd_kernel(x0, ws, bs, residuals: bool):
    B, D = x0.shape
    NL = ws.shape[0]
    if not 1 <= D <= MAX_D or 2 * NL * D > MAX_SHARED_FLOATS:
        raise ValueError(f"dcn_cross_stack kernel takes 1 <= D <= {MAX_D} and "
                         f"2*NL*D <= {MAX_SHARED_FLOATS}; got D={D}, NL={NL}")
    if residuals and (NL < 1 or (1 + 2 * BWD_WARPS) * NL * D > BWD_MAX_SHARED_FLOATS):
        raise ValueError(f"dcn_cross_bwd kernel takes NL >= 1 and "
                         f"{1 + 2 * BWD_WARPS}*NL*D <= {BWD_MAX_SHARED_FLOATS}; "
                         f"got D={D}, NL={NL}")
    from ._build import launch

    out = torch.empty_like(x0)
    xs = x0.new_empty((NL, B, D)) if residuals else None
    ss = x0.new_empty((NL, B)) if residuals else None
    launch("nrt_dcn_cross_fwd", x0.data_ptr(), ws.data_ptr(), bs.data_ptr(), out.data_ptr(),
           xs.data_ptr() if residuals else None, ss.data_ptr() if residuals else None,
           B, D, NL, stream_ptr(x0))
    with launch_count_lock:
        dcn_cross_stack.launches += 1
    return out, xs, ss


def dcn_cross_bwd(x0, ws, xs, ss, g):
    """The cross stack's VJP from the forward's residuals: x0 (B, D), ws
    (NL, D), xs (NL, B, D), ss (NL, B), g (B, D), float32 -> (dx0, dws, dbs).

    On CUDA tensors it launches ``nrt_dcn_cross_bwd``; dws/dbs are reduced
    over per-block partials in a fixed order, so a run repeats its bits."""
    for t, name, ndim in ((x0, "x0", 2), (ws, "ws", 2), (xs, "xs", 3), (ss, "ss", 2),
                          (g, "g", 2)):
        check_tensor(t, name, torch.float32, ndim)
    B, D = x0.shape
    NL = ws.shape[0]
    if (ws.shape[1] != D or xs.shape != (NL, B, D) or ss.shape != (NL, B)
            or g.shape != x0.shape):
        raise ValueError(f"shapes do not match x0 {tuple(x0.shape)}, ws {tuple(ws.shape)}: "
                         f"xs {tuple(xs.shape)}, ss {tuple(ss.shape)}, g {tuple(g.shape)}")
    if kernel_device(x0, ws, xs, ss, g) == "cpu":
        return cross_bwd_plain(x0, ws, xs, ss, g)
    from ._build import launch

    nblk = max(1, min(-(-B // BWD_WARPS), BWD_MAX_BLOCKS))
    dx0 = torch.empty_like(x0)
    dws, dbs = torch.empty_like(ws), torch.empty_like(ws)
    partial = x0.new_empty((nblk, 2, NL, D))
    launch("nrt_dcn_cross_bwd", x0.data_ptr(), ws.data_ptr(), xs.data_ptr(), ss.data_ptr(),
           g.data_ptr(), dx0.data_ptr(), dws.data_ptr(), dbs.data_ptr(), partial.data_ptr(),
           B, D, NL, nblk, stream_ptr(x0))
    with launch_count_lock:
        dcn_cross_bwd.launches += 1
    return dx0, dws, dbs


class _CrossStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, ws, bs):
        need = any(ctx.needs_input_grad)
        if x0.device.type == "cpu":
            out, xs, ss = cross_fwd_plain(x0, ws, bs)
        else:
            out, xs, ss = _cross_fwd_kernel(x0, ws, bs, residuals=need)
        if need:
            ctx.save_for_backward(x0, ws, xs, ss)
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
