"""A cell's parameters, drawn from the run's seed on the device.

The laws are the reference's (:func:`reference.model.param_specs`): tables
N(0, init_scale) with row 0 zero, Linear and attention weights
U(+-1/sqrt(fan_in)), the cross weights Xavier-uniform, LayerNorm scales one
and shifts zero. Two calls of one ``torch.Generator`` on the card draw them
all: one normal draw for every table, one uniform draw for the rest.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def draw(specs: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    sizes = {law: sum(math.prod(shape) for _, shape, l, _ in specs if l == law)
             for law in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g, device=device).mul_(2).sub_(1)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, law, scale in specs:
        if law in pools:
            n = math.prod(shape)
            t = pools[law][at[law]:at[law] + n].view(shape).mul_(scale)
            at[law] += n
            if law == "normal":
                t[0] = 0.0
        else:
            t = (torch.ones if law == "ones" else torch.zeros)(shape, device=device)
        out[name] = t
    return out
