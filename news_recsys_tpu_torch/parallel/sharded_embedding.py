"""Lookups from row-sharded tables through an all-to-all id exchange.

Port of :mod:`news_recsys_tpu.parallel.sharded_embedding`. JAX reads a
``P('model', None)`` table with a masked local gather and a ``psum`` over
``model`` (its ``shard_map`` route; the GSPMD route, ``explicit_collectives``
off, inserts a gather/psum pair of the same traffic). The port takes neither:
a ``psum`` moves the whole (N, D) result through every rank. Both settings
of ``mesh.explicit_collectives`` take the exchange here, with the same
values:

1. each rank buckets its ids by owner (shard ``s`` owns rows
   ``[s*V/n, (s+1)*V/n)``) and sends every owner its ids (after the
   counts, so each rank knows what it receives);
2. each owner gathers those rows from its shard and sends them back;
3. the rows land in the slots they were asked for; an id outside
   ``[0, V)`` has no owner and reads a NaN row, as the one-device
   :func:`~news_recsys_tpu_torch.models.embedding.take` reads it (JAX's
   masked ``psum`` reads zeros there: a named divergence, held by the
   tests).

:func:`sharded_lookup` is a ``torch.autograd.Function`` in the shard. Its
backward sends nothing: the ranks of a model group hold the same ids and
the same cotangent (the batch splits over ``data`` only, and the dense
compute is replicated over ``model``), so each owner adds the gradients of
its own rows from its own copy, in slot order, as JAX's transposed ``psum``
does and as ``F.embedding``'s backward does on one device. A backward that
sent every rank's row gradients to their owners would count each slot
``model`` times.

Pooled array features (:func:`sharded_lookup_pool`) keep the pool kernel:
the exchange returns the distinct rows a rank asked for as a compact
``(U, D)`` table and the ``(B, L)`` ids remapped into it, the pool kernel
(:func:`~news_recsys_tpu_torch.ops.fused_lookup_pool.fused_lookup_pool`)
runs on that table, and its backward kernel writes the ``(U, D)`` gradient
whose owned rows the exchange's backward puts into the shard's gradient.

A model's tables learn their mesh from :func:`set_active_mesh` (an
attribute of its embedding collection, where JAX keeps one module-level
mesh); :func:`shard_parameters` cuts a model's tables to its rank's rows and
:func:`full_state_dict` gathers them back.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.fused_lookup_pool import fused_lookup_pool
from .mesh import Mesh, sharded_names


def set_active_mesh(embedder: nn.Module, mesh: Optional[Mesh]) -> None:
    """Route ``embedder``'s lookups through ``mesh``'s model axis; a mesh
    with one rank on it (or None) leaves them local, as JAX's does."""
    embedder.mesh = mesh if mesh is not None and mesh.model > 1 else None


def active_mesh(embedder: nn.Module) -> Optional[Mesh]:
    return getattr(embedder, "mesh", None)


class _ExchangeLookup(torch.autograd.Function):
    """rows (N, D) of the global ids (N,) from this rank's shard (Vl, D)."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh):
        n, m = mesh.model, mesh.model_index
        Vl, D = shard.shape
        valid = (ids >= 0) & (ids < Vl * n)
        owner = torch.where(valid, torch.div(ids, Vl, rounding_mode="floor"), n)
        order = torch.argsort(owner, stable=True)          # by owner, slot order within
        counts = torch.bincount(owner, minlength=n + 1)[:n]
        recv_counts = mesh.all_to_all(counts, [1] * n, [1] * n, "model")
        both = torch.cat([counts, recv_counts]).tolist()    # the split sizes, on the host
        send, recv = both[:n], both[n:]
        sel = order[: sum(send)]
        asked = mesh.all_to_all(ids.index_select(0, sel), recv, send, "model")
        rows = torch.nn.functional.embedding(asked - m * Vl, shard)
        back = mesh.all_to_all(rows, send, recv, "model")
        out = shard.new_full((ids.shape[0], D), float("nan"))
        out.index_copy_(0, sel, back)
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.rows = mesh, Vl
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        Vl = ctx.rows
        local = ids - ctx.mesh.model_index * Vl
        mine = (local >= 0) & (local < Vl)
        # a foreign slot goes to row Vl, the padding index, which adds nothing
        g = torch.ops.aten.embedding_dense_backward(
            grad.contiguous(), torch.where(mine, local, Vl), Vl + 1, Vl, False)
        return g[:Vl], None, None


def sharded_lookup(shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows ``(*ids.shape, D)`` of a table row-sharded over ``mesh``'s model
    axis, ``shard`` this rank's part, for global ``ids``; ids outside
    ``[0, V)`` read NaN. Differentiable in ``shard``."""
    out = _ExchangeLookup.apply(shard, ids.reshape(-1).long(), mesh)
    return out.reshape(*ids.shape, shard.shape[1])


def sharded_lookup_pool(shard: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """The masked mean pool (B, D) of ``fused_lookup_pool`` over a row-sharded
    table: the distinct ids of the (B, L) ``ids`` (padding 0 first) through
    the exchange into a compact table, the pool kernel over it with the ids
    remapped; an example holding an id outside ``[0, V)`` pools to NaN, as
    on one device."""
    V = shard.shape[0] * mesh.model
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, V, flat)       # negative ids read NaN, as ids >= V do
    uniq, inv = torch.unique(torch.cat([flat.new_zeros(1), flat]), return_inverse=True)
    compact = _ExchangeLookup.apply(shard, uniq, mesh)
    local = inv[1:].reshape(ids.shape).to(torch.int32).contiguous()
    pooled = fused_lookup_pool(compact, local, mask.to(torch.float32).contiguous())
    bad = ((ids < 0) | (ids >= V)).any(dim=1)
    return pooled.masked_fill(bad[:, None], float("nan"))


# -- parameters on shards --------------------------------------------------------


def _owner_of(model: nn.Module, name: str):
    prefix, _, leaf = name.rpartition(".")
    return model.get_submodule(prefix), leaf


def shard_parameters(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Cut every table :func:`~.mesh.param_shardings` row-shards to this
    rank's rows (in place: new parameters, so build optimizers after), and
    route the model's lookups through ``mesh``; returns ``model``."""
    embedder = getattr(model, "embedder", None)
    if embedder is not None:
        set_active_mesh(embedder, mesh)
    for name in sharded_names(model, mesh):
        mod, leaf = _owner_of(model, name)
        p = getattr(mod, leaf)
        start, stop = mesh.row_range(p.shape[0])
        mod.register_parameter(leaf, nn.Parameter(p.detach()[start:stop].clone(),
                                                  requires_grad=p.requires_grad))
    return model


def full_state_dict(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded table gathered whole over
    the model axis: what one process holds."""
    sd = model.state_dict()
    for name in sharded_names(model, mesh):
        sd[name] = mesh.all_gather(sd[name].detach(), "model")
    return sd


def shard_state_dict(sd: Dict[str, torch.Tensor], model: nn.Module,
                     mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A whole state dict (one process's) cut to this rank's rows of every
    sharded table of ``model``."""
    out = dict(sd)
    for name in sharded_names(model, mesh):
        start, stop = mesh.row_range(sd[name].shape[0])
        out[name] = sd[name][start:stop]
    return out
