"""DCN-v1 cross stack: a CUDA kernel for Hopper and its plain PyTorch version.

``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l`` for NL layers, with the rank-1
identity ``(x0 x_l^T) w == x0 * (x_l . w)`` in place of the B x D x D outer
product (reference ``dcn_arch.py:14-30``).

The kernel (``csrc/dcn_cross.cu``, entry ``nrt_dcn_cross_fwd``) replaces the
Pallas kernel ``news_recsys_tpu/ops/dcn_kernel.py::_cross_pallas``. It is
bound by memory (one read of x0, one write of out): one warp per row keeps
x0 and x in registers, the layer weights sit in shared memory, and each
``s_l`` is a warp-shuffle sum, so no intermediate x reaches device memory.
"""

from __future__ import annotations

import torch

from . import check_tensor, kernel_device, launch_count_lock, stream_ptr

MAX_D = 256                    # 8 values per lane
MAX_SHARED_FLOATS = 48 * 1024 // 4


def cross_plain(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """The cross stack in plain PyTorch: the CPU path and the kernel's oracle."""
    x = x0
    for l in range(ws.shape[0]):
        s = x @ ws[l]                                   # (B,)
        x = x0 * s[:, None] + bs[l] + x
    return x


def reference_cross_stack(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """Direct transliteration of the per-layer reference math:
    cross = (x0 x_l^T) w, with the outer product materialised."""
    x = x0
    for l in range(ws.shape[0]):
        outer = torch.einsum("bi,bj->bij", x0, x)       # (B, D, D)
        x = torch.einsum("bij,j->bi", outer, ws[l]) + bs[l] + x
    return x


def dcn_cross_stack(x0: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """x0 (B, D), ws (NL, D), bs (NL, D), float32 -> (B, D) after NL cross layers."""
    check_tensor(x0, "x0", torch.float32, 2)
    check_tensor(ws, "ws", torch.float32, 2)
    check_tensor(bs, "bs", torch.float32, 2)
    B, D = x0.shape
    NL = ws.shape[0]
    if ws.shape[1] != D or bs.shape != ws.shape:
        raise ValueError(f"ws {tuple(ws.shape)} and bs {tuple(bs.shape)} must both be "
                         f"(NL, {D})")
    if kernel_device(x0, ws, bs) == "cpu":
        return cross_plain(x0, ws, bs)
    if not 1 <= D <= MAX_D or 2 * NL * D > MAX_SHARED_FLOATS:
        raise ValueError(f"dcn_cross_stack kernel takes 1 <= D <= {MAX_D} and "
                         f"2*NL*D <= {MAX_SHARED_FLOATS}; got D={D}, NL={NL}")
    from ._build import launch

    out = torch.empty_like(x0)
    launch("nrt_dcn_cross_fwd", x0.data_ptr(), ws.data_ptr(), bs.data_ptr(),
           out.data_ptr(), None, None, B, D, NL, stream_ptr(x0))
    with launch_count_lock:
        dcn_cross_stack.launches += 1
    return out


dcn_cross_stack.launches = 0
