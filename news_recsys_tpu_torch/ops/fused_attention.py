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
replaces ``_fused_block_bwd``. The backward recomputes the forward from
``(x, mask, parameters)``, the only tensors saved, and sums the parameter
gradients in per-block partials and a second pass in a fixed order, so two
runs give the same bits.

Two routes, chosen by :func:`plan_shape` from the shape alone. The *tiled*
route (``csrc/fused_attention_tiled_{fwd,bwd}.cu``) takes the attention
ranker's family of shapes (:func:`tiled_takes`: 16 < L <= 32, D 32, F 64,
heads of 16): the parameters stay in shared memory, a thread block walks
tiles of two examples (64 rows) and every product runs on the tensor cores
in 3xTF32, which keeps float32 accuracy. Every other shape of the domain
(L <= 128, D <= 128, F <= 512) takes the *general* route
(``csrc/fused_attention.cu``: float32 FMAs, one example a block-iteration).
A route is no fallback for the other: a launch that fails raises.

An example whose mask is all zero attends uniformly over its L keys, kernel
and plain version alike, as the flax block does (the Pallas kernel leaves
garbage rows there); its masked scores get no gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import (KernelCost, aligned16, check_tensor, kernel_device, kernel_scope,
               launch_count_lock, open_counter, stream_ptr)

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
                num_heads: int, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block in plain PyTorch, step by step as the flax module: the CPU
    path and the kernels' oracle (its gradients come from autograd).
    ``gate`` (B, L, F), 0 or 1, replaces the feed-forward's ReLU gate
    ``pre-activation > 0`` when given: a kernel that decides a pre-activation
    within rounding of 0 the other way is held to this version with its own
    gate."""
    y1 = layer_norm_plain(x + mhsa_plain(x, mask, wqkv, bqkv, wo, bo, num_heads), g1, b1)
    z = y1 @ w1 + c1
    ffn = (torch.relu(z) if gate is None else z * gate) @ w2 + c2
    return layer_norm_plain(y1 + ffn, g2, b2)


def block_bwd_plain(params: Sequence[torch.Tensor], x, mask, dy, num_heads: int,
                    gate: Optional[torch.Tensor] = None):
    """(dx, the 12 parameter gradients) by autograd through :func:`block_plain`
    (with ``gate``, if given, as the ReLU's)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, *params)]
        out = block_plain(leaves[0], mask, *leaves[1:], num_heads=num_heads, gate=gate)
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


ROUTES = ("general", "tiled")
# the tiled route's tile: an example fills a slot of 32 rows, two examples a tile
TILED_SLOT, TILED_EXAMPLES, TILED_WARPS = 32, 2, 4


def param_floats(D: int, F: int) -> int:
    """Floats of the 12 parameters (and of their flat gradient)."""
    return 4 * D * D + 2 * D * F + 9 * D + F


def block_cost(B: int, L: int, D: int, F: int, units: str = "float32") -> KernelCost:
    """The forward's work: per row 2*(4*D*D + 2*D*F) operations for the four
    projections and 4*L*D for q k^T and p v; x read and y written, the mask
    and the parameters read. ``units``: :func:`route_units` of the route
    that runs it."""
    proj, attn = 2 * (4 * D * D + 2 * D * F), 4 * L * D
    return KernelCost(B * L * (proj + attn), 4 * (2 * B * L * D + B * L + param_floats(D, F)),
                      units)


def block_bwd_cost(B: int, L: int, D: int, F: int, units: str = "float32") -> KernelCost:
    """The backward's work: it recomputes the forward, then takes two products
    for each of the forward's; x, dy, the mask and the parameters read, dx and
    the parameters' gradients written. ``units`` as in :func:`block_cost`."""
    fwd = block_cost(B, L, D, F).flops
    return KernelCost(3 * fwd, 4 * (3 * B * L * D + B * L + 2 * param_floats(D, F)), units)


def route_units(route: str) -> str:
    """The units a route's products run on: the tiled route's ``mma.sync``
    on the tensor cores in TF32 (its float32 operations counted once, not
    the three products of the 3xTF32 split), the general route's outside
    them in float32."""
    return "tf32" if route == "tiled" else "float32"


def tiled_takes(L: int, D: int, F: int, H: int) -> bool:
    """The shapes the tiled kernels are built for: the widths are compile-time
    constants of ``csrc/fused_attention_tiled.cuh`` (D 32, F 64, heads of
    16), and an example must fill more than half of its 32-row slot."""
    return TILED_SLOT // 2 < L <= TILED_SLOT and D == 32 and F == 64 and H > 0 and D == 16 * H


def taken_route(L: int, D: int, F: int, H: int, route: Optional[str] = None) -> str:
    """The route a launch takes: ``route`` where one is forced (``"tiled"``
    on a shape it does not take raises), else the tiled one where
    :func:`tiled_takes` says so, else the general one."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be None or one of {ROUTES}, got {route!r}")
    takes = tiled_takes(L, D, F, H)
    if route == "tiled" and not takes:
        raise ValueError(f"the tiled route takes 16 < L <= 32, D = 32, F = 64 and heads of 16; "
                         f"got L={L}, D={D}, F={F}, H={H}")
    return route or ("tiled" if takes else "general")


def _tiled_smem_floats(D: int, F: int, backward: bool) -> int:
    """A tiled block's shared memory, as ``S_TOTAL`` of the two sources lays
    it out: the kernels with padded strides (the backward: their transposes
    too), the small vectors, and the tile's activations."""
    rows = TILED_SLOT * TILED_EXAMPLES
    ldx, ldq, ldh, ldp = D + 4, 3 * D + 4, F + 4, TILED_SLOT + 4
    ld_qkv, ld_d, ld_f = 3 * D + 8, D + 8, F + 8
    kernels = D * ld_qkv + D * ld_d + D * ld_f + F * ld_d
    vectors = 9 * D + F
    if not backward:    # x (ao and y1 in its place), q|k|v, a copy of the key codes a warp
        return kernels + vectors + rows * (ldx + ldq) + TILED_WARPS * TILED_SLOT
    transposed = 3 * D * ld_d + D * ld_d + F * ld_d + D * ld_f
    sums = param_floats(D, F) + TILED_WARPS * vectors
    return (kernels + transposed + vectors + sums
            + rows * (4 * ldx + ldq + ldh + 2 * ldp + 1))


def _general_ws_floats(L: int, D: int, F: int, backward: bool) -> int:
    """Floats of workspace an example takes on the general route
    (``fwd_ws_floats`` / ``bwd_ws_floats`` of ``csrc/fused_attention.cu``)."""
    ldq = (3 * D) | 1
    if backward:
        return L * (7 * D + 2 * ldq + 2 * L + 2 * F + 3)
    return L * (2 * D + ldq + L + F + 1)


class Plan(NamedTuple):
    """How a launch of one shape is laid out (:func:`plan_shape`)."""
    route: str              # "general" or "tiled"
    tile_examples: int      # examples a tile; tile t goes to block t % blocks
    blocks: int             # persistent thread blocks
    smem_bytes: int         # dynamic shared memory a block
    workspace_floats: int   # device-memory workspace of the launch (general route)

    def tiles(self, B: int) -> int:
        return -(-B // self.tile_examples)


def plan_shape(B: int, L: int, D: int, F: int, H: int, sms: int, backward: bool,
               route: Optional[str] = None) -> Plan:
    """The launch of a (B, L, D) block with feed-forward width F and H heads
    on a card of ``sms`` multiprocessors: a pure function of the shape, on
    the route of :func:`taken_route`. As many blocks as the card keeps resident, at most one per tile; tiles
    are dealt round-robin, so two blocks' counts differ by at most one."""
    if taken_route(L, D, F, H, route) == "tiled":
        smem = 4 * _tiled_smem_floats(D, F, backward)
        per_sm = max(1, SMEM_BYTES // (smem + 1024))      # 1 KB a block is the system's
        tiles = -(-B // TILED_EXAMPLES)
        return Plan("tiled", TILED_EXAMPLES, max(1, min(tiles, sms * per_sm)), smem, 0)
    ws_floats = _general_ws_floats(L, D, F, backward)
    in_smem = ws_floats * 4 <= SMEM_BYTES
    per_sm = max(1, min(8, SMEM_BYTES // (ws_floats * 4))) if in_smem else 2
    blocks = max(1, min(B, sms * per_sm))
    return Plan("general", 1, blocks, ws_floats * 4 if in_smem else 0,
                0 if in_smem else blocks * ws_floats)


def _plan(x: torch.Tensor, L, D, F, H, backward: bool, route) -> Plan:
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan_shape(x.shape[0], L, D, F, H, sms, backward, route)


def _param_pointers(params):
    """The parameters' device addresses as a C array (kept alive by the caller)."""
    return (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))


def _fwd_kernel(params, x, mask, num_heads: int, route=None) -> torch.Tensor:
    from ._build import launch

    B, L, D, F = _check(params, x, mask, num_heads)
    _kernel_shape(B, L, D, F)
    out = torch.empty_like(x)
    if B == 0:
        return out
    plan = _plan(x, L, D, F, num_heads, False, route)
    if plan.route == "tiled":
        x, params = aligned16(x), tuple(map(aligned16, params))
        ptrs = _param_pointers(params)
        launch("nrt_fused_block_tiled_fwd", x.data_ptr(), mask.data_ptr(),
               ctypes.addressof(ptrs), out.data_ptr(), B, L, plan.blocks, stream_ptr(x))
    else:
        ws = x.new_empty((plan.workspace_floats,)) if plan.workspace_floats else None
        ptrs = _param_pointers(params)
        launch("nrt_fused_block_fwd", x.data_ptr(), mask.data_ptr(), ctypes.addressof(ptrs),
               out.data_ptr(), None if ws is None else ws.data_ptr(), B, L, D, F, num_heads,
               plan.blocks, stream_ptr(x))
    with launch_count_lock:
        fused_transformer_block.launches += 1
    return out


def fused_transformer_block_bwd(params: Sequence[torch.Tensor], x, mask, dy, num_heads: int,
                                route: Optional[str] = None):
    """The block's VJP: ``dy`` (B, L, D) -> (dx, the 12 parameter gradients in
    :data:`PARAM_NAMES` order). On CUDA tensors it launches
    ``nrt_fused_block_tiled_bwd`` or ``nrt_fused_block_bwd`` (``route`` as in
    :func:`fused_transformer_block`), which recompute the forward."""
    params = tuple(params)
    B, L, D, F = _check(params, x, mask, num_heads)
    check_tensor(dy, "dy", torch.float32, 3)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be {tuple(x.shape)}")
    units = route_units(taken_route(L, D, F, num_heads, route))  # raises on a route not taken
    on_cpu = kernel_device(x, mask, dy, *params) == "cpu"
    with kernel_scope("fused_transformer_block_bwd", lambda: block_bwd_cost(B, L, D, F, units)):
        if on_cpu:
            return block_bwd_plain(params, x, mask, dy, num_heads)
        return _bwd_kernel(params, x, mask, dy, num_heads, route, B, L, D, F)


def _bwd_kernel(params, x, mask, dy, num_heads: int, route, B, L, D, F):
    from ._build import launch

    _kernel_shape(B, L, D, F)
    dx = torch.empty_like(x)
    n_params = param_floats(D, F)
    dflat = x.new_zeros((n_params,)) if B == 0 else x.new_empty((n_params,))
    if B > 0:
        plan = _plan(x, L, D, F, num_heads, True, route)
        partial = x.new_empty((plan.blocks * n_params,))
        if plan.route == "tiled":
            x, dy, params = aligned16(x), aligned16(dy), tuple(map(aligned16, params))
            ptrs = _param_pointers(params)
            launch("nrt_fused_block_tiled_bwd", x.data_ptr(), mask.data_ptr(), dy.data_ptr(),
                   ctypes.addressof(ptrs), dx.data_ptr(), dflat.data_ptr(), partial.data_ptr(),
                   B, L, plan.blocks, stream_ptr(x))
        else:
            ws = x.new_empty((plan.workspace_floats,)) if plan.workspace_floats else None
            wt = x.new_empty((4 * D * D + 2 * D * F,))
            ptrs = _param_pointers(params)
            launch("nrt_fused_block_bwd", x.data_ptr(), mask.data_ptr(), dy.data_ptr(),
                   ctypes.addressof(ptrs), dx.data_ptr(), dflat.data_ptr(), wt.data_ptr(),
                   partial.data_ptr(), None if ws is None else ws.data_ptr(), B, L, D, F,
                   num_heads, plan.blocks, stream_ptr(x))
        with launch_count_lock:
            fused_transformer_block_bwd.launches += 1
    grads, at = [], 0
    for p in params:
        grads.append(dflat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return dx, tuple(grads)


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, num_heads, route, *params):
        ctx.num_heads, ctx.route = num_heads, route
        ctx.save_for_backward(x, mask, *params)
        units = route_units(taken_route(*x.shape[1:], params[6].shape[-1], num_heads, route))
        with kernel_scope("fused_transformer_block",
                          lambda: block_cost(*x.shape, params[6].shape[-1], units)):
            if x.device.type == "cpu":
                return block_plain(x, mask, *params, num_heads=num_heads)
            return _fwd_kernel(params, x, mask, num_heads, route)

    @staticmethod
    def backward(ctx, dy):
        x, mask, *params = ctx.saved_tensors
        dx, dparams = fused_transformer_block_bwd(params, x, mask, dy.contiguous(),
                                                  ctx.num_heads, ctx.route)
        return (dx, None, None, None, *dparams)


def fused_transformer_block(params, x: torch.Tensor, mask: torch.Tensor, num_heads: int,
                            route: Optional[str] = None) -> torch.Tensor:
    """``params``: the 12 tensors in :data:`PARAM_NAMES` order, or a module
    with ``fused_params()`` (``models.layers.TransformerBlock``); ``x``
    (B, L, D) float32; ``mask`` (B, L) float32 validity of the keys. Returns
    (B, L, D); differentiable in ``x`` and every parameter. CPU tensors take
    :func:`block_plain`, CUDA tensors the kernels. ``route`` is for tests and
    measurements that run both kernels at one shape: ``None`` (the route of
    :func:`plan_shape`), ``"general"`` or ``"tiled"``. On the CPU autograd goes
    through :func:`block_plain`, but under an open cost counter through the
    kernels' autograd path with their plain bodies, as the card runs it."""
    params = tuple(params.fused_params() if hasattr(params, "fused_params") else params)
    B, L, D, F = _check(params, x, mask, num_heads)
    taken_route(L, D, F, num_heads, route)                  # raises on a route not taken
    if kernel_device(x, mask, *params) == "cpu" and open_counter() is None:
        return block_plain(x, mask, *params, num_heads=num_heads)
    return _FusedBlock.apply(x, mask, num_heads, route, *params)


fused_transformer_block.launches = 0
fused_transformer_block_bwd.launches = 0
