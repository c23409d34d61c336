"""Checkpoint conversion between the per-table and arena embedding layouts.

Port of :mod:`news_recsys_tpu.training.arena_convert`, on the port's
checkpoints (``epoch_*.pt``, :mod:`.checkpoint`). ``embeddings.arena_tables``
changes the parameters (same-dim large tables pack into one ``arena_d<D>``
table, :func:`~news_recsys_tpu_torch.config.arena_layout`), so a checkpoint
written under one layout does not load under the other. Conversion maps
rows as the JAX package does:

- member ``m`` with logical vocab ``v`` and arena offset ``o`` maps rows
  ``[1, v) -> [o+1, o+v)``; row 0 is the shared padding row;
- every per-table tensor converts the same way: the model's tables, the
  rowwise optimizer's state (``emb_acc`` (V,), ``emb_mu`` / ``emb_nu``
  (V, D)) and AdamW's moments of a table that AdamW steps (the all-dense
  ``adamw`` step's tables); a bfloat16 table stays bfloat16;
- arena rows above the last member are filled from the source table's own
  padded tail row; no lookup reads them.

A converted checkpoint predicts as the source does and trains on as the
target layout would have from the start: updates are row-local and the
mapping is a bijection on real rows.

AdamW's ``state_dict`` numbers its parameters by their place in the
optimizer, which the layout changes; the checkpoint is converted by
parameter name (:func:`checkpoint_tree`), its tables nested as
``{"embedder": {"tables": {...}}}`` for :func:`convert_tree`, and numbered
again in the target model's order (:func:`checkpoint_from_tree`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..config import Config, arena_layout, table_specs
from ..models.embedding import padded_vocab
from .checkpoint import load_state, save_state_dict

ADAMW_MOMENTS = ("exp_avg", "exp_avg_sq")


def _member_vocabs(cfg: Config) -> Dict[str, int]:
    emb = cfg.embeddings
    return {m: int(emb.embedding_table_size[m]) for m in arena_layout(cfg)}


def to_arena_dict(cfg: Config, tables: Dict[str, Any]) -> Dict[str, Any]:
    """Pack a {table name: tensor} dict's member tables into arena tensors.
    Works for any per-row tensor keyed by table name: tables (V, D), Adam
    moments (V, D), AdaGrad accumulators (V,)."""
    layout = arena_layout(cfg)
    vocabs = _member_vocabs(cfg)
    specs = table_specs(cfg)
    out = {k: v for k, v in tables.items() if k not in layout}
    members_by_arena: Dict[str, list] = {}
    for m, (aname, off, _) in sorted(layout.items()):
        members_by_arena.setdefault(aname, []).append((m, off))
    for aname, members in members_by_arena.items():
        present = [m for m, _ in members if m in tables]
        if not present:
            continue
        if len(present) != len(members):
            missing = [m for m, _ in members if m not in tables]
            raise ValueError(f"Cannot pack {aname}: missing member tables {missing}")
        avocab = specs[aname][0]
        first = tables[members[0][0]]
        arena = first.new_zeros((padded_vocab(avocab),) + tuple(first.shape[1:]))
        arena[0] = first[0]                               # shared padding row
        for m, off in members:
            v = vocabs[m]
            arena[off + 1: off + v] = tables[m][1:v]
        arena[avocab:] = first[-1]                        # inert rows above the members
        out[aname] = arena
    return out


def from_arena_dict(cfg: Config, tables: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`to_arena_dict`: split arena tensors back into
    per-table tensors (the target: the same config, ``arena_tables`` off)."""
    layout = arena_layout(cfg)
    vocabs = _member_vocabs(cfg)
    arena_names = {aname for aname, _, _ in layout.values()}
    out = {k: v for k, v in tables.items() if k not in arena_names}
    for m, (aname, off, _) in sorted(layout.items()):
        if aname not in tables:
            continue
        arena = tables[aname]
        v = vocabs[m]
        tbl = arena.new_zeros((padded_vocab(v),) + tuple(arena.shape[1:]))
        tbl[0] = arena[0]
        tbl[1:v] = arena[off + 1: off + v]
        tbl[v:] = arena[-1]
        out[m] = tbl
    return out


def convert_tree(cfg: Config, tree: Any, to_arena: bool) -> Any:
    """Convert every table-keyed dict in a nested tree: a dict holding all
    of an arena's member tables (or the arena itself, for the reverse) as
    tensors is converted; everything else passes through. ``cfg`` has
    ``arena_tables`` on: it defines the arena for both directions."""
    layout = arena_layout(cfg)
    if not layout:
        return tree
    members = set(layout)
    arena_names = {aname for aname, _, _ in layout.values()}

    def walk(node):
        if not isinstance(node, dict):
            return node
        keys = set(node)
        if to_arena and (members & keys) and all(
                isinstance(node[m], torch.Tensor) for m in members & keys):
            return to_arena_dict(cfg, {k: walk(v) if isinstance(v, dict) else v
                                       for k, v in node.items()})
        if not to_arena and (arena_names & keys) and all(
                isinstance(node[a], torch.Tensor) for a in arena_names & keys):
            return from_arena_dict(cfg, {k: walk(v) if isinstance(v, dict) else v
                                         for k, v in node.items()})
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def _nest(flat: Dict[str, Any]) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _flat(tree: dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _build_model(cfg: Config):
    """The model a checkpoint of ``cfg`` belongs to, on the CPU (its
    parameters' names and order; the values are not used)."""
    if cfg.name == "dssm":
        from ..models.dssm import build_dssm
        return build_dssm(cfg, device="cpu")
    from ..models.rankers import build_ranker
    return build_ranker(cfg, cfg.name, device="cpu")


def adamw_names(model, kind: str) -> List[str]:
    """The names of the parameters AdamW steps, in its order: every one in
    an all-dense state, all but the large tables in a sparse one."""
    if kind == "dense":
        return [n for n, _ in model.named_parameters()]
    from .sparse_step import dense_parameters
    return [n for n, _ in dense_parameters(model)]


def _adamw_tree(opt: Optional[dict], names: List[str]) -> Optional[dict]:
    """AdamW's ``state_dict`` by parameter name: its one group's
    hyperparameters, the step (one count for every parameter, as optax's)
    and the two moments nested by name."""
    if opt is None:
        return None
    (group,) = opt["param_groups"]
    if len(group["params"]) != len(names):
        raise ValueError(f"AdamW holds {len(group['params'])} parameters, the model's "
                         f"{len(names)} (another model or layout?)")
    by_name = {names[group["params"].index(i)]: s for i, s in opt["state"].items()}
    steps = {float(s["step"]) for s in by_name.values()}
    if len(steps) > 1:
        raise ValueError(f"AdamW step counts differ between parameters: {sorted(steps)}")
    return {"group": {k: v for k, v in group.items() if k != "params"},
            "step": next(iter(by_name.values()))["step"] if by_name else None,
            **{m: _nest({n: s[m] for n, s in by_name.items()}) for m in ADAMW_MOMENTS}}


def _adamw_from_tree(tree: Optional[dict], names: List[str]) -> Optional[dict]:
    if tree is None:
        return None
    moments = {m: _flat(tree[m]) for m in ADAMW_MOMENTS}
    if set(moments["exp_avg"]) - set(names):
        raise ValueError(f"AdamW moments of {sorted(set(moments['exp_avg']) - set(names))} "
                         "have no parameter in the target model")
    state = {i: {"step": tree["step"].clone(),
                 **{m: moments[m][n] for m in ADAMW_MOMENTS}}
             for i, n in enumerate(names) if n in moments["exp_avg"]}
    return {"state": state, "param_groups": [{**tree["group"], "params": list(range(len(names)))}]}


OPT_KEYS = {"dense": "opt", "sparse": "dense_opt"}


def checkpoint_tree(blob: dict, model) -> dict:
    """A checkpoint dict (:func:`.checkpoint.state_dict`'s) with every
    tensor keyed by name: the model's parameters and AdamW's moments nested
    by their dotted names, the rowwise state by table; ``model`` is the
    model it was written from (for AdamW's parameter order)."""
    kind = blob["kind"]
    tree = {**blob, "model": _nest(blob["model"])}
    if kind in OPT_KEYS:
        tree[OPT_KEYS[kind]] = _adamw_tree(blob[OPT_KEYS[kind]], adamw_names(model, kind))
    return tree


def checkpoint_from_tree(tree: dict, model) -> dict:
    """Inverse of :func:`checkpoint_tree` for the (target) ``model``: the
    parameters in its ``state_dict`` order, AdamW's numbered in its order."""
    kind = tree["kind"]
    flat = _flat(tree["model"])
    want = list(model.state_dict())
    if set(flat) != set(want):
        raise ValueError(f"the converted checkpoint holds {sorted(set(flat) ^ set(want))} "
                         "where the target model does not, or lacks them")
    blob = {**tree, "model": {n: flat[n] for n in want}}
    if kind in OPT_KEYS:
        blob[OPT_KEYS[kind]] = _adamw_from_tree(tree[OPT_KEYS[kind]], adamw_names(model, kind))
    return blob


def layout_configs(cfg: Config):
    """(per-table config, arena config) of ``cfg``."""
    def with_arena(on: bool) -> Config:
        return dataclasses.replace(cfg, embeddings=dataclasses.replace(cfg.embeddings,
                                                                       arena_tables=on))
    return with_arena(False), with_arena(True)


def convert_checkpoint_dict(cfg: Config, blob: dict, to_arena: bool) -> dict:
    """A checkpoint dict converted to the arena layout (``to_arena``) or to
    per-table tables; ``cfg`` is the model's config in either layout."""
    per_table, arena = layout_configs(cfg)
    src, dst = (per_table, arena) if to_arena else (arena, per_table)
    tree = convert_tree(arena, checkpoint_tree(blob, _build_model(src)), to_arena)
    return checkpoint_from_tree(tree, _build_model(dst))


def convert_checkpoint(cfg: Config, in_path: str, out_path: str, to_arena: bool) -> str:
    """Convert an ``epoch_*.pt`` (or step) checkpoint file between the
    layouts; returns ``out_path``."""
    return save_state_dict(out_path, convert_checkpoint_dict(cfg, load_state(in_path), to_arena))
