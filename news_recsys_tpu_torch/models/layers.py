"""Core layers with torch-default initialisation drawn from a ``torch.Generator``.

Port of :mod:`news_recsys_tpu.models.layers` (``Linear``, ``MLP``). The JAX
package already draws torch's default ``U(+-1/sqrt(fan_in))`` for weight and
bias; a flax kernel is (in, out) where a torch weight is (out, in), which
:mod:`news_recsys_tpu_torch.convert` transposes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` initialised U(+-1/sqrt(fan_in)) from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        bound = 1.0 / math.sqrt(in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    """Linear+ReLU stack, no activation after the last layer (``dims`` are
    the hidden and output sizes; the input size is given)."""

    def __init__(self, in_features: int, dims: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = [in_features, *dims]
        self.layers = nn.ModuleList(Linear(a, b, generator) for a, b in zip(sizes, sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
