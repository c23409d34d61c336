"""The ``('data', 'model')`` mesh over the process group, and the placement
rule of the parameters.

Port of :mod:`news_recsys_tpu.parallel.mesh`, with its layout: ranks are
laid out data-major, so rank ``r`` sits at ``(r // model, r % model)``, and
``data = -1`` means every rank the model axis leaves. Batches split their
leading dimension over ``data``; every rank of one model group (one data
coordinate) holds the same batch slice and runs the same dense compute, as
GSPMD replicates it over ``model``. Every 2-D table under ``embedder`` is
row-sharded over ``model`` when ``model > 1`` (:func:`param_shardings`):
shard ``s`` owns rows ``[s*V/n, (s+1)*V/n)`` (``padded_vocab`` makes ``V``
a multiple of 128, so a power-of-two axis divides it); everything else is
replicated.

Where the JAX mesh is a device array, this one is a rank's view of the
process group: its coordinates, the process groups of its model group (the
ranks that share its data coordinate) and data group (those that share its
model coordinate), made with ``dist.new_group`` on every rank in one order,
and the :class:`~.distributed.CommStats` of its collectives. Without a
started process group a mesh only knows its coordinates (``rank`` and
``world`` given): what the placement tests read.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import (CommStats, all_gather_cat, all_reduce_, all_to_all, process_count,
                          process_index)

class Mesh:
    """A rank's place in a ``data x model`` grid of ``world`` ranks."""

    def __init__(self, data: int = -1, model: int = 1, *, rank: Optional[int] = None,
                 world: Optional[int] = None):
        world = process_count() if world is None else world
        rank = process_index() if rank is None else rank
        if model < 1 or world % model:
            raise ValueError(f"{world} processes not divisible by model={model}")
        data = world // model if data == -1 else data
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        self.data, self.model, self.world, self.rank = data, model, world, rank
        self.data_index, self.model_index = divmod(rank, model)
        self.stats = CommStats()
        self.groups: Dict[str, object] = {"data": None, "model": None}
        if world > 1 and dist.is_initialized():
            # every rank creates every group, in one order
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == self.data_index:
                    self.groups["model"] = g
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == self.model_index:
                    self.groups["data"] = g

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def coords(self) -> Tuple[int, int]:
        return self.data_index, self.model_index

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model}, rank={self.rank})"

    # -- placement -------------------------------------------------------------

    def row_range(self, rows: int) -> Tuple[int, int]:
        """This rank's rows ``[start, stop)`` of a table of ``rows`` rows
        row-sharded over ``model``."""
        if rows % self.model:
            raise ValueError(f"{rows} rows do not split over model={self.model}")
        n = rows // self.model
        return self.model_index * n, (self.model_index + 1) * n

    def batch_slice(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.data:
            raise ValueError(f"batch_size {batch_size} is not divisible by the mesh's "
                             f"data axis ({self.data})")
        n = batch_size // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    # -- collectives over one axis --------------------------------------------

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return all_reduce_(t, self.groups[axis], self.stats)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        return all_gather_cat(t, self.groups[axis], self.stats)

    def all_to_all(self, t: torch.Tensor, out_splits, in_splits, axis: str) -> torch.Tensor:
        return all_to_all(t, out_splits, in_splits, self.groups[axis], self.stats)


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh of this process over the started process group."""
    return Mesh(data, model)


def mesh_from_config(cfg) -> Mesh:
    return make_mesh(cfg.mesh.data, cfg.mesh.model)


def is_embedding_table(name: str, param: torch.Tensor) -> bool:
    return "embedder" in name.split(".") and param.dim() == 2


def param_shardings(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, Optional[str]]:
    """Parameter name -> ``"model"`` for a table row-sharded over the model
    axis (when it has more than one rank), else None (replicated)."""
    sharded = mesh is not None and mesh.model > 1
    return {n: "model" if sharded and is_embedding_table(n, p) else None
            for n, p in model.named_parameters()}


def sharded_names(model: nn.Module, mesh: Optional[Mesh]) -> list:
    """The row-sharded parameters' names, sorted: every rank walks them in one
    order (a set's order follows each process's string hashing)."""
    return sorted(n for n, axis in param_shardings(model, mesh).items() if axis)


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, t.shape[0]
        return mesh.all_gather(t, axis)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, axis, n = ctx.mesh, ctx.axis, ctx.rows
        total = mesh.all_reduce_(grad.contiguous().clone(), axis)
        i = mesh.data_index if axis == "data" else mesh.model_index
        return total[i * n:(i + 1) * n], None, None


def all_gather_with_grad(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated in rank order, whose
    backward sums the gradient over the axis and returns the rank's rows:
    the DSSM's in-batch negatives over the global batch."""
    return _GatherWithGrad.apply(t, mesh, axis)
