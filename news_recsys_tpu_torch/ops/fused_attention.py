"""One post-norm Transformer block as one op: CUDA kernels for Hopper
(forward and backward) and their plain PyTorch version.

``qkv = x Wqkv + b`` split (B, L, 3, H, hd) -> masked multi-head self
attention (scores / sqrt(hd), ``-1e9`` on invalid keys, softmax) -> output
projection -> ``LN(x + attn)`` -> ``Linear, ReLU, Linear`` ->
``LN(y1 + ffn)``: the JAX package's ``models.layers.TransformerBlock``.
LayerNorm is flax's: eps 1e-6 and the fast variance ``E[z^2] - E[z]^2``.

The 12 parameters travel in the order of the JAX kernel's operands
(:data:`PARAM_NAMES`): ``wqkv (D, 3D), bqkv, wo (D, D), bo, g1, b1,
w1 (D, F), c1, w2 (F, D), c2, g2, b2``. Kernels are stored (in, out), as
flax stores them: the CUDA kernels read a weight's row coalesced over the
output columns.

:func:`fused_transformer_block` is a ``torch.autograd.Function``, as the JAX
package's is a ``jax.custom_vjp``. Forward: ``csrc/fused_attention.cu``,
entry ``nrt_fused_block_fwd``, which replaces the Pallas kernel
``news_recsys_tpu/ops/fused_attention.py::_fused_fwd_call``; backward:
:func:`fused_transformer_block_bwd`, entry ``nrt_fused_block_bwd``, which
replaces ``_fused_block_bwd``. Both are bound by float32 operations (about
80 flops per byte moved). The backward recomputes the forward from
``(x, mask, parameters)``, the only tensors saved, and sums the parameter
gradients in per-block partials and a second pass in block order, so two
runs give the same bits.

An example whose mask is all zero attends uniformly over its L keys, kernel
and plain version alike, as the flax block does (the Pallas kernel leaves
garbage rows there); its masked scores get no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from . import check_tensor, kernel_device, launch_count_lock, stream_ptr

NEG = -1e9          # score of an invalid key
LN_EPS = 1e-6       # flax nn.LayerNorm's default
PARAM_NAMES = ("wqkv", "bqkv", "wo", "bo", "g1", "b1", "w1", "c1", "w2", "c2", "g2", "b2")
# what the kernels take: the Pallas kernel's domain, whose far corner
# (128, 128, 512) the GPU tests run
MAX_L, MAX_D, MAX_F = 128, 128, 512
SMEM_BYTES = 227 * 1024     # above this a block's workspace lies in device memory


def layer_norm_plain(z: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm`` with ``use_fast_variance``: eps 1e-6, var = E[z^2] - E[z]^2."""
    mean = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mean * mean
    return (z - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def mhsa_plain(x, mask, wqkv, bqkv, wo, bo, num_heads: int) -> torch.Tensor:
    """Fused-qkv multi-head self attention, (B, L, D) -> (B, L, D); ``mask``
    (B, L) marks the valid keys (> 0), None means all."""
    B, L, D = x.shape
    hd = D // num_heads
    qkv = (x @ wqkv + bqkv).reshape(B, L, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))          # (B, H, L, hd)
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(B, L, D)
    return out @ wo + bo


def block_plain(x, mask, wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2, b2,
                num_heads: int) -> torch.Tensor:
    """The block in plain PyTorch, step by step as the flax module: the CPU
    path and the kernels' oracle (its gradients come from autograd)."""
    y1 = layer_norm_plain(x + mhsa_plain(x, mask, wqkv, bqkv, wo, bo, num_heads), g1, b1)
    ffn = torch.relu(y1 @ w1 + c1) @ w2 + c2
    return layer_norm_plain(y1 + ffn, g2, b2)


def block_bwd_plain(params: Sequence[torch.Tensor], x, mask, dy, num_heads: int):
    """(dx, the 12 parameter gradients) by autograd through :func:`block_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        out = block_plain(leaves[0], mask, *leaves[1:], num_heads=num_heads)
        grads = torch.autograd.grad(out, leaves, dy)
    return grads[0], tuple(grads[1:])


def _check(params, x, mask, num_heads: int) -> Tuple[int, int, int, int]:
    check_tensor(x, "x", torch.float32, 3)
    check_tensor(mask, "mask", torch.float32, 2)
    B, L, D = x.shape
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"mask {tuple(mask.shape)} must be {(B, L)}")
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"the block takes {len(PARAM_NAMES)} parameters {PARAM_NAMES}, "
                         f"got {len(params)}")
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"D={D} must be a multiple of num_heads={num_heads}")
    F = params[6].shape[-1]
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,), (F, D), (D,), (D,),
              (D,))
    for name, p, shape in zip(PARAM_NAMES, params, shapes):
        check_tensor(p, name, torch.float32, len(shape))
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} {tuple(p.shape)} must be {shape}")
    return B, L, D, F


def _kernel_shape(B, L, D, F) -> None:
    if not (1 <= L <= MAX_L and 1 <= D <= MAX_D and 1 <= F <= MAX_F) or B * L * D >= 2 ** 31:
        raise ValueError(f"the fused block kernels take L <= {MAX_L}, D <= {MAX_D}, "
                         f"F <= {MAX_F} and B*L*D < 2**31; got B={B}, L={L}, D={D}, F={F}")


def _plan(x: torch.Tensor, L, D, F, backward: bool):
    """(thread blocks, the device-memory workspace or None) for a launch:
    as many blocks as the card keeps resident, each walking its share of
    the examples."""
    from ._build import library

    ws_floats = library().nrt_fused_block_ws_floats(L, D, F, int(backward))
    in_smem = ws_floats * 4 <= SMEM_BYTES
    per_sm = max(1, min(8, SMEM_BYTES // (ws_floats * 4))) if in_smem else 2
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nblk = min(x.shape[0], sms * per_sm)
    ws = None if in_smem else x.new_empty((nblk * ws_floats,))
    return nblk, ws


def _param_pointers(params):
    """The parameters' device addresses as a C array (kept alive by the caller)."""
    return (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))


def _fwd_kernel(params, x, mask, num_heads: int) -> torch.Tensor:
    from ._build import launch

    B, L, D, F = _check(params, x, mask, num_heads)
    _kernel_shape(B, L, D, F)
    out = torch.empty_like(x)
    if B == 0:
        return out
    nblk, ws = _plan(x, L, D, F, backward=False)
    ptrs = _param_pointers(params)
    launch("nrt_fused_block_fwd", x.data_ptr(), mask.data_ptr(), ctypes.addressof(ptrs),
           out.data_ptr(), None if ws is None else ws.data_ptr(), B, L, D, F, num_heads, nblk,
           stream_ptr(x))
    with launch_count_lock:
        fused_transformer_block.launches += 1
    return out


def fused_transformer_block_bwd(params: Sequence[torch.Tensor], x, mask, dy, num_heads: int):
    """The block's VJP: ``dy`` (B, L, D) -> (dx, the 12 parameter gradients in
    :data:`PARAM_NAMES` order). On CUDA tensors it launches
    ``nrt_fused_block_bwd``, which recomputes the forward."""
    params = tuple(params)
    B, L, D, F = _check(params, x, mask, num_heads)
    check_tensor(dy, "dy", torch.float32, 3)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be {tuple(x.shape)}")
    if kernel_device(x, mask, dy, *params) == "cpu":
        return block_bwd_plain(params, x, mask, dy, num_heads)
    from ._build import launch, library

    _kernel_shape(B, L, D, F)
    dx = torch.empty_like(x)
    n_params = library().nrt_fused_block_param_floats(D, F)
    dflat = x.new_zeros((n_params,)) if B == 0 else x.new_empty((n_params,))
    if B > 0:
        nblk, ws = _plan(x, L, D, F, backward=True)
        wt = x.new_empty((4 * D * D + 2 * D * F,))
        partial = x.new_empty((nblk * n_params,))
        ptrs = _param_pointers(params)
        launch("nrt_fused_block_bwd", x.data_ptr(), mask.data_ptr(), dy.data_ptr(),
               ctypes.addressof(ptrs), dx.data_ptr(), dflat.data_ptr(), wt.data_ptr(),
               partial.data_ptr(), None if ws is None else ws.data_ptr(), B, L, D, F, num_heads,
               nblk, stream_ptr(x))
        with launch_count_lock:
            fused_transformer_block_bwd.launches += 1
    grads, at = [], 0
    for p in params:
        grads.append(dflat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return dx, tuple(grads)


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, num_heads, *params):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, mask, *params)
        return _fwd_kernel(params, x, mask, num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, mask, *params = ctx.saved_tensors
        dx, dparams = fused_transformer_block_bwd(params, x, mask, dy.contiguous(), ctx.num_heads)
        return (dx, None, None, *dparams)


def fused_transformer_block(params, x: torch.Tensor, mask: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """``params``: the 12 tensors in :data:`PARAM_NAMES` order, or a module
    with ``fused_params()`` (``models.layers.TransformerBlock``); ``x``
    (B, L, D) float32; ``mask`` (B, L) float32 validity of the keys. Returns
    (B, L, D); differentiable in ``x`` and every parameter. CPU tensors take
    :func:`block_plain`, CUDA tensors the kernels."""
    params = tuple(params.fused_params() if hasattr(params, "fused_params") else params)
    _check(params, x, mask, num_heads)
    if kernel_device(x, mask, *params) == "cpu":
        return block_plain(x, mask, *params, num_heads=num_heads)
    return _FusedBlock.apply(x, mask, num_heads, *params)


fused_transformer_block.launches = 0
fused_transformer_block_bwd.launches = 0
