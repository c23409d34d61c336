"""The one path by which parameters enter and leave the port's modules.

Parameters travel as the JAX package's flax tree, as numpy arrays keyed by
flax path (``embedder/user_id``, ``user_fc/Linear_0/Dense_0/kernel``,
``cross/w_0``): a nested dict from ``model.init`` / ``jax.device_get``, or
the flat ``params.npz`` of a bundle. The mapping to a port module:

=========================================  ==================================
flax path                                  port parameter
=========================================  ==================================
``embedder/<table>`` (V, D)                ``embedder.tables.<table>``
``<m>/Linear_<i>/Dense_0/kernel`` (in,out) ``<m>.layers.<i>.weight`` (out,in)
``<m>/Linear_<i>/Dense_0/bias``            ``<m>.layers.<i>.bias``
``cross/w_<l>`` (D, 1), ``cross/b_<l>``    row l of ``cross.ws``, ``cross.bs``
=========================================  ==================================
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LINEAR = re.compile(r"^(.+)/Linear_(\d+)/Dense_0/(kernel|bias)$")
_CROSS = re.compile(r"^cross/([wb])_(\d+)$")
_LAYER = re.compile(r"^(.+)\.layers\.(\d+)\.(weight|bias)$")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested flax params (with or without the top ``params`` level) or an
    already flat mapping -> {"a/b/c": array}."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def params_from_flax(tree: Mapping, model: nn.Module) -> nn.Module:
    """Copy flax parameters into ``model`` in place (strict: every parameter
    of the model must be given, and nothing else); returns ``model``."""
    state: Dict[str, np.ndarray] = {}
    cross: Dict[str, Dict[int, np.ndarray]] = {"w": {}, "b": {}}
    for path, value in flatten(tree).items():
        value = np.asarray(value, np.float32)
        if m := _LINEAR.match(path):
            module, i, kind = m.groups()
            name = "weight" if kind == "kernel" else "bias"
            state[f"{module.replace('/', '.')}.layers.{i}.{name}"] = (
                value.T if kind == "kernel" else value)
        elif m := _CROSS.match(path):
            cross[m.group(1)][int(m.group(2))] = value.reshape(-1)
        elif path.startswith("embedder/"):
            state[f"embedder.tables.{path[len('embedder/'):]}"] = value
        else:
            raise KeyError(f"no port parameter for flax path {path!r}")
    for kind, layers in cross.items():
        if layers:
            state[f"cross.{kind}s"] = np.stack([layers[i] for i in range(len(layers))])
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def params_to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_flax`: flat {flax path: array}."""
    flat: Dict[str, np.ndarray] = {}
    for name, tensor in model.state_dict().items():
        value = tensor.detach().cpu().numpy()
        if m := _LAYER.match(name):
            module, i, kind = m.groups()
            leaf = "kernel" if kind == "weight" else "bias"
            flat[f"{module.replace('.', '/')}/Linear_{i}/Dense_0/{leaf}"] = (
                value.T.copy() if kind == "weight" else value)
        elif name in ("cross.ws", "cross.bs"):
            kind = name[len("cross."):-1]                   # "w" | "b"
            for l, row in enumerate(value):
                flat[f"cross/{kind}_{l}"] = row[:, None] if kind == "w" else row
        elif name.startswith("embedder.tables."):
            flat[f"embedder/{name[len('embedder.tables.'):]}"] = value
        else:
            raise KeyError(f"no flax path for port parameter {name!r}")
    return flat
