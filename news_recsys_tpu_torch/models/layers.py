"""Core layers with torch-default initialisation drawn from a ``torch.Generator``.

Port of :mod:`news_recsys_tpu.models.layers` (``Linear``, ``MLP``,
``MultiHeadSelfAttention``, ``TransformerBlock``). The JAX package already
draws torch's default ``U(+-1/sqrt(fan_in))`` for weight and bias; a flax
kernel is (in, out) where a torch weight is (out, in), which
:mod:`news_recsys_tpu_torch.convert` transposes. The attention layers keep
their kernels (in, out), as flax does: the fused block's CUDA kernels read
them that way (:mod:`news_recsys_tpu_torch.ops.fused_attention`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.fused_attention import fused_transformer_block, mhsa_plain


class Linear(nn.Linear):
    """``nn.Linear`` initialised U(+-1/sqrt(fan_in)) from ``generator``.

    ``compute_dtype`` is flax's ``dtype``: the parameters stay float32, and
    the input, weight and bias are cast to it for the matmul and the bias
    add (rounded after each, as flax's ``Dense`` rounds them)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        return x.to(dt) @ self.weight.to(dt).t() + self.bias.to(dt)


class MLP(nn.Module):
    """Linear+ReLU stack, no activation after the last layer (``dims`` are
    the hidden and output sizes; the input size is given). With a
    ``compute_dtype`` (bfloat16 towers) the matmuls run in it and the last
    output is cast back to float32, as the JAX package's ``MLP``."""

    def __init__(self, in_features: int, dims: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        sizes = [in_features, *dims]
        self.layers = nn.ModuleList(Linear(a, b, generator, compute_dtype)
                                    for a, b in zip(sizes, sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x.float()


def _uniform(shape, fan_in: int, generator: Optional[torch.Generator]) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class MultiHeadSelfAttention(nn.Module):
    """Fused-qkv multi-head self attention, (B, N, C) -> (B, N, C): one
    ``Linear(C, 3C)`` split (B, N, 3, H, hd), scores / sqrt(hd), ``-1e9`` on
    invalid keys (so a row whose keys are all invalid attends uniformly),
    softmax, output projection. ``wqkv`` (C, 3C) and ``wo`` (C, C) are stored
    (in, out). Inside a :class:`TransformerBlock` it only holds the
    parameters: the block runs as one fused op."""

    def __init__(self, embed_dim: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim={embed_dim} must be a multiple of "
                             f"num_heads={num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.wqkv = _uniform((embed_dim, 3 * embed_dim), embed_dim, generator)
        self.bqkv = _uniform((3 * embed_dim,), embed_dim, generator)
        self.wo = _uniform((embed_dim, embed_dim), embed_dim, generator)
        self.bo = _uniform((embed_dim,), embed_dim, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mask: optional (B, N) validity of the keys (> 0 = attend)."""
        return mhsa_plain(x, mask, self.wqkv, self.bqkv, self.wo, self.bo, self.num_heads)


class TransformerBlock(nn.Module):
    """Post-norm block: ``y1 = LN(x + MHSA(x))``, ``LN(y1 + FF(y1))`` with a
    ReLU feed-forward; LayerNorm as flax's (eps 1e-6, fast variance). It runs
    as :func:`~news_recsys_tpu_torch.ops.fused_attention.fused_transformer_block`:
    the CUDA kernels on CUDA tensors, ``block_plain`` on CPU tensors.
    ``dropout`` must be 0.0: the rankers never set it and the fused kernel
    has none."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dropout != 0.0:
            raise ValueError(f"TransformerBlock runs as a fused kernel without dropout; "
                             f"got dropout={dropout}")
        self.embed_dim, self.num_heads, self.ff_dim = embed_dim, num_heads, ff_dim
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads, generator)
        self.g1 = nn.Parameter(torch.ones(embed_dim))
        self.b1 = nn.Parameter(torch.zeros(embed_dim))
        self.w1 = _uniform((embed_dim, ff_dim), embed_dim, generator)
        self.c1 = _uniform((ff_dim,), embed_dim, generator)
        self.w2 = _uniform((ff_dim, embed_dim), ff_dim, generator)
        self.c2 = _uniform((embed_dim,), ff_dim, generator)
        self.g2 = nn.Parameter(torch.ones(embed_dim))
        self.b2 = nn.Parameter(torch.zeros(embed_dim))

    def fused_params(self):
        """The 12 parameters in the fused op's order (``PARAM_NAMES``)."""
        a = self.attn
        return (a.wqkv, a.bqkv, a.wo, a.bo, self.g1, self.b1, self.w1, self.c1, self.w2,
                self.c2, self.g2, self.b2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = x.new_ones(x.shape[:2])
        return fused_transformer_block(self, x.contiguous(),
                                       mask.to(torch.float32).contiguous(), self.num_heads)
