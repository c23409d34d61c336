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
``bias`` (1,)                              ``bias``
``blocks_<i>/<flax leaf>``                 ``blocks.<i>.<name>``, as it is
=========================================  ==================================

The ``Linear`` row covers the MLP towers (``tower``, ``user_fc``, ...) and
DCN-v2's cross layers (``cross/Linear_<i>``); ``cross/w_<l>`` is DCN-v1's.
A Transformer block's 12 leaves (:data:`BLOCK_LEAVES`) keep their (in, out)
kernels, which the port's attention layers store as flax does.

A sparse training state travels the same way (:func:`sparse_state_from_jax`,
:func:`sparse_state_to_jax`): AdamW's moments are keyed by their
parameter's flax path, the rowwise optimizer's state by table. So does the
all-dense state (:func:`dense_state_from_jax`, :func:`dense_state_to_jax`),
whose moments cover the whole tree.

A bfloat16 table (``mesh.param_dtype: bfloat16``) leaves ``jax.device_get``
as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses, and
numpy has no bfloat16 of its own: it crosses as its uint16 bit pattern.
Coming in, a bfloat16 or uint16 leaf widens exactly to float32 and loads
into the bfloat16 parameter; going out, a bfloat16 parameter is a uint16
array (JAX takes it back with ``.view(jnp.bfloat16)``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from .training.dense_step import init_dense_state
from .training.sparse_step import dense_parameters, init_sparse_state

_LINEAR = re.compile(r"^(.+)/Linear_(\d+)/Dense_0/(kernel|bias)$")
_CROSS = re.compile(r"^cross/([wb])_(\d+)$")
_LAYER = re.compile(r"^(.+)\.layers\.(\d+)\.(weight|bias)$")
_FLAX_BLOCK = re.compile(r"^blocks_(\d+)/(.+)$")
_PORT_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)$")
# a flax TransformerBlock's leaves -> the port's TransformerBlock parameters
BLOCK_LEAVES = {
    "MultiHeadSelfAttention_0/Linear_0/Dense_0/kernel": "attn.wqkv",
    "MultiHeadSelfAttention_0/Linear_0/Dense_0/bias": "attn.bqkv",
    "MultiHeadSelfAttention_0/Linear_1/Dense_0/kernel": "attn.wo",
    "MultiHeadSelfAttention_0/Linear_1/Dense_0/bias": "attn.bo",
    "LayerNorm_0/scale": "g1", "LayerNorm_0/bias": "b1",
    "Linear_0/Dense_0/kernel": "w1", "Linear_0/Dense_0/bias": "c1",
    "Linear_1/Dense_0/kernel": "w2", "Linear_1/Dense_0/bias": "c2",
    "LayerNorm_1/scale": "g2", "LayerNorm_1/bias": "b2",
}
_BLOCK_PATHS = {name: leaf for leaf, name in BLOCK_LEAVES.items()}


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


def is_bf16(a) -> bool:
    """A bfloat16 leaf: ``ml_dtypes.bfloat16``, or its bits as uint16."""
    a = np.asarray(a)
    return a.dtype.name == "bfloat16" or a.dtype == np.uint16


def as_float32(value) -> np.ndarray:
    """A leaf as float32; a bfloat16 one (:func:`is_bf16`) widens exactly."""
    a = np.asarray(value)
    if is_bf16(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bfloat16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def port_arrays(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{flax path: array} -> {port parameter name: float32 array}: kernels
    transposed, the per-layer cross vectors stacked."""
    state: Dict[str, np.ndarray] = {}
    cross: Dict[str, Dict[int, np.ndarray]] = {"w": {}, "b": {}}
    for path, value in flat.items():
        value = as_float32(value)
        if m := _FLAX_BLOCK.match(path):
            if m.group(2) not in BLOCK_LEAVES:
                raise KeyError(f"no port parameter for flax path {path!r}")
            state[f"blocks.{m.group(1)}.{BLOCK_LEAVES[m.group(2)]}"] = value
        elif m := _LINEAR.match(path):
            module, i, kind = m.groups()
            name = "weight" if kind == "kernel" else "bias"
            state[f"{module.replace('/', '.')}.layers.{i}.{name}"] = (
                value.T if kind == "kernel" else value)
        elif m := _CROSS.match(path):
            cross[m.group(1)][int(m.group(2))] = value.reshape(-1)
        elif path.startswith("embedder/"):
            state[f"embedder.tables.{path[len('embedder/'):]}"] = value
        elif path == "bias":
            state["bias"] = value
        else:
            raise KeyError(f"no port parameter for flax path {path!r}")
    for kind, layers in cross.items():
        if layers:
            state[f"cross.{kind}s"] = np.stack([layers[i] for i in range(len(layers))])
    return state


def flax_arrays(named: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`port_arrays`: {port parameter name: array} ->
    {flax path: array}."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in named.items():
        if m := _PORT_BLOCK.match(name):
            flat[f"blocks_{m.group(1)}/{_BLOCK_PATHS[m.group(2)]}"] = value
        elif m := _LAYER.match(name):
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
        elif name == "bias":
            flat["bias"] = value
        else:
            raise KeyError(f"no flax path for port parameter {name!r}")
    return flat


def params_from_flax(tree: Mapping, model: nn.Module) -> nn.Module:
    """Copy flax parameters into ``model`` in place (strict: every parameter
    of the model must be given, and nothing else, a bfloat16 table into a
    bfloat16 one); returns ``model``."""
    flat = flatten(tree)
    own = model.state_dict()
    for path, value in flat.items():
        name = f"embedder.tables.{path[len('embedder/'):]}"
        if path.startswith("embedder/") and name in own and \
                is_bf16(value) != (own[name].dtype == torch.bfloat16):
            raise ValueError(f"{path}: a {np.asarray(value).dtype} table does not load into "
                             f"a {own[name].dtype} one (mesh.param_dtype differs?)")
    state = port_arrays(flat)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return model


def params_to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_flax`: flat {flax path: array}, a
    bfloat16 table as its uint16 bits."""
    return flax_arrays({name: tensor_to_numpy(t) for name, t in model.state_dict().items()})


def flatten_sparse_state(state) -> Dict:
    """The JAX package's ``SparseTrainState`` (numpy leaves, from
    ``jax.device_get``) as the plain dict that :func:`sparse_state_to_jax`
    gives; a dict of that form passes through as it is::

        {"params": {flax path: array},
         "dense_opt": {"count": (), "mu": {flax path: array}, "nu": {...}},
         "emb_mu": {table: array}, "emb_nu": {table: array}, "step": ()}

    ``dense_opt`` is optax's ``adamw`` state: the ``ScaleByAdamState`` of
    the dense parameters and the small tables (its ``count`` also counts the
    schedule), keyed by the parameters' flax paths. ``emb_mu`` holds the
    AdaGrad accumulators (V,) with ``emb_nu`` empty (``rowwise_adagrad``),
    or Adam's first moments (V, D) with the second in ``emb_nu``
    (``sparse_adamw``)."""
    if isinstance(state, Mapping):
        return state
    adam = state.dense_opt[0]

    def moments(tree) -> Dict[str, np.ndarray]:
        return flatten({**tree["dense"], "embedder": dict(tree["small"])})

    return {"params": flatten(state.params),
            "dense_opt": {"count": np.asarray(adam.count), "mu": moments(adam.mu),
                          "nu": moments(adam.nu)},
            "emb_mu": {k: np.asarray(v) for k, v in state.emb_mu.items()},
            "emb_nu": {k: np.asarray(v) for k, v in state.emb_nu.items()},
            "step": np.asarray(state.step)}


def _rowwise_state(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port state's rowwise optimizer state under the JAX names: AdaGrad's
    accumulators as ``emb_mu``, or Adam's moments as ``emb_mu`` / ``emb_nu``."""
    if state.emb_acc:
        return {"emb_mu": state.emb_acc, "emb_nu": {}}
    return {"emb_mu": state.emb_mu, "emb_nu": state.emb_nu}


def sparse_state_from_jax(state, model: nn.Module, cfg):
    """A JAX ``SparseTrainState`` (or :func:`flatten_sparse_state`'s dict)
    as the port's: ``model`` takes the parameters in place, AdamW its
    moments and step count per parameter (optax ``count`` / ``mu`` / ``nu``
    -> torch ``step`` / ``exp_avg`` / ``exp_avg_sq``), the rowwise
    optimizer's state (AdaGrad's accumulators, or Adam's moments) and the
    step carry over. Training then continues as the JAX state would. The
    JAX state has no apply counter for K-step write-back: the port's starts
    at ``step // K``, as the JAX package derives it at a chunk's entry."""
    s = flatten_sparse_state(state)
    params_from_flax(s["params"], model)
    out = init_sparse_state(model, cfg)
    params = dict(dense_parameters(model))
    mu, nu = port_arrays(s["dense_opt"]["mu"]), port_arrays(s["dense_opt"]["nu"])
    if set(mu) != set(params) or set(nu) != set(params):
        raise KeyError(f"AdamW moments {sorted(mu)} do not match the dense parameters "
                       f"{sorted(params)}")
    count = float(np.asarray(s["dense_opt"]["count"]))
    for name, p in params.items():
        out.dense_opt.state[p] = {
            "step": torch.tensor(count),
            "exp_avg": torch.tensor(mu[name], device=p.device),
            "exp_avg_sq": torch.tensor(nu[name], device=p.device)}
    for key, live in _rowwise_state(out).items():
        saved = s.get(key, {})
        if set(saved) != set(live):
            raise KeyError(f"{key} {sorted(saved)} does not match the large tables' "
                           f"{sorted(live)} ({cfg.train_hparams.embedding_optimizer})")
        for name, t in live.items():
            if tuple(np.shape(saved[name])) != tuple(t.shape):
                raise ValueError(f"{key} {name}: shape {np.shape(saved[name])}, the state "
                                 f"has {tuple(t.shape)}")
            t.copy_(torch.from_numpy(as_float32(saved[name]).copy()))
    out.step = int(np.asarray(s["step"]))
    out.applies = out.step // cfg.train_hparams.embedding_update_period
    return out


def sparse_state_to_jax(state) -> Dict:
    """Inverse of :func:`sparse_state_from_jax`, as the dict of
    :func:`flatten_sparse_state` (numpy leaves)."""
    params = dense_parameters(state.model)
    opt = [state.dense_opt.state.get(p, {}) for _, p in params]
    steps = {float(o["step"]) for o in opt if o}
    if len(steps) > 1:
        raise ValueError(f"AdamW step counts differ between parameters: {sorted(steps)}")
    if not params:
        steps = {state.step}      # optax counts its updates of an empty tree too

    def moments(key) -> Dict[str, np.ndarray]:
        return flax_arrays({n: (o[key] if o else torch.zeros_like(p)).detach().cpu().numpy()
                            for (n, p), o in zip(params, opt)})

    return {"params": params_to_flax(state.model),
            "dense_opt": {"count": np.asarray(int(steps.pop()) if steps else 0, np.int32),
                          "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")},
            **{key: {k: tensor_to_numpy(v) for k, v in live.items()}
               for key, live in _rowwise_state(state).items()},
            "step": np.asarray(state.step, np.int32)}


def flatten_dense_state(state) -> Dict:
    """The JAX package's all-dense ``TrainState`` (numpy leaves, from
    ``jax.device_get``) as the plain dict that :func:`dense_state_to_jax`
    gives; a dict of that form passes through as it is::

        {"params": {flax path: array},
         "opt": {"count": (), "mu": {flax path: array}, "nu": {...}},
         "step": ()}

    ``opt`` is the ``ScaleByAdamState`` of optax's ``adamw`` over the whole
    parameter tree (its ``count`` also counts the schedule)."""
    if isinstance(state, Mapping):
        return state
    adam = state.opt_state[0]
    return {"params": flatten(state.params),
            "opt": {"count": np.asarray(adam.count), "mu": flatten(adam.mu),
                    "nu": flatten(adam.nu)},
            "step": np.asarray(state.step)}


def dense_state_from_jax(state, model: nn.Module, cfg):
    """A JAX all-dense ``TrainState`` (or :func:`flatten_dense_state`'s
    dict) as the port's: ``model`` takes the parameters in place, AdamW its
    moments and step count per parameter (optax ``count`` / ``mu`` / ``nu``
    -> torch ``step`` / ``exp_avg`` / ``exp_avg_sq``)."""
    s = flatten_dense_state(state)
    params_from_flax(s["params"], model)
    out = init_dense_state(model, cfg)
    params = dict(model.named_parameters())
    mu, nu = port_arrays(s["opt"]["mu"]), port_arrays(s["opt"]["nu"])
    if set(mu) != set(params) or set(nu) != set(params):
        raise KeyError(f"AdamW moments {sorted(mu)} do not match the parameters "
                       f"{sorted(params)}")
    count = float(np.asarray(s["opt"]["count"]))
    for name, p in params.items():
        out.opt.state[p] = {"step": torch.tensor(count),
                            "exp_avg": torch.tensor(mu[name], device=p.device),
                            "exp_avg_sq": torch.tensor(nu[name], device=p.device)}
    out.step = int(np.asarray(s["step"]))
    return out


def dense_state_to_jax(state) -> Dict:
    """Inverse of :func:`dense_state_from_jax`, as the dict of
    :func:`flatten_dense_state` (numpy leaves)."""
    params = list(state.model.named_parameters())
    opt = [state.opt.state.get(p, {}) for _, p in params]
    steps = {float(o["step"]) for o in opt if o}
    if len(steps) > 1:
        raise ValueError(f"AdamW step counts differ between parameters: {sorted(steps)}")

    def moments(key) -> Dict[str, np.ndarray]:
        return flax_arrays({n: (o[key] if o else torch.zeros_like(p)).detach().cpu().numpy()
                            for (n, p), o in zip(params, opt)})

    return {"params": params_to_flax(state.model),
            "opt": {"count": np.asarray(int(steps.pop()) if steps else 0, np.int32),
                    "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")},
            "step": np.asarray(state.step, np.int32)}
