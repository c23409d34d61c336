"""Checkpoints of the port's training states: save, strict restore, resume.

Port of :mod:`news_recsys_tpu.training.checkpoint` (Orbax) on
``torch.save``. A state is stored as a plain dict (:func:`state_dict`):

- all-dense (:class:`~.dense_step.DenseTrainState`): ``kind`` "dense", the
  model's ``state_dict``, AdamW's ``state_dict`` and ``step``;
- sparse (:class:`~.sparse_step.SparseTrainState`): ``kind`` "sparse", the
  model's ``state_dict`` (a bfloat16 table as bfloat16), ``dense_opt``
  (AdamW's ``state_dict``, or None when the state has no AdamW), the rowwise
  optimizer's state (``rowwise_adagrad``: the accumulators ``emb_acc``;
  ``sparse_adamw``: the moments ``emb_mu`` and ``emb_nu``), ``step`` and the
  K-step write-back's apply counter ``applies``. A checkpoint holds no
  pending rows: the trainer saves only where it has flushed them. One
  written before ``sparse_adamw`` and K-step write-back were ported (no
  ``emb_mu``, ``emb_nu`` or ``applies``) loads as a state with none of them.

A weights-only checkpoint (:func:`save_weights`, the DSSM's per-epoch
file, as the JAX package's ``save_weights_only`` writes) has ``kind``
"weights" and the model's ``state_dict`` alone.

A file is read onto the CPU with ``torch.load(weights_only=True)`` and copied
into a live state of the same kind and shapes (:func:`load_state_dict`). AdamW
is loaded from the CPU on purpose: its ``load_state_dict`` moves the moments
to the parameters' device and leaves the ``step`` counts where they are, on
the CPU, where a non-capturable AdamW requires them (loaded onto the card it
refuses them: "state_steps should not be CUDA tensors").

:class:`CheckpointManager` keeps step-indexed files under one directory and
deletes none, as the JAX package's ``max_to_keep=None`` keeps every step.
:func:`resolve_ckpt` finds the checkpoint that a command names: a file, or
an experiment dir's newest ``ckpts/epoch_<NNN>.pt``; a JAX ``.msgpack`` is
refused with the script that converts it.

Under a mesh whose model axis shards the tables (``mesh=``), every rank
gathers the sharded tensors (the tables, their rowwise optimizer state and
AdamW's moments of a sharded small table) over the model axis in one order,
and process 0 writes the file: the format one process writes, whatever the
layout. Loading, every rank reads the whole file and keeps its rows, so a
checkpoint moves between layouts (JAX's Orbax step checkpoints restore onto
the mesh that wrote them; its epoch files are host-format).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import torch

from ..parallel.mesh import sharded_names
from ..parallel.sharded_embedding import full_state_dict, shard_state_dict
from .sparse_step import sparse_state_shardings

STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
EXPORT_SCRIPT = "scripts/export_torch_checkpoint.py"
MOMENTS = ("emb_acc", "emb_mu", "emb_nu")       # a sparse state's rowwise optimizer state


def state_kind(state) -> str:
    """"sparse" for a state with rowwise optimizer state, else "dense"."""
    return "sparse" if hasattr(state, "emb_acc") else "dense"


def state_shardings(state, mesh) -> dict:
    """The sharded tensors of ``state``'s checkpoint, by part: the model's
    parameter names, AdamW's parameter indices and the rowwise optimizer's
    tables (:func:`~.sparse_step.sparse_state_shardings`)."""
    if state_kind(state) == "sparse":
        return sparse_state_shardings(state, mesh)
    sharded = sharded_names(state.model, mesh)
    return {"model": sharded,
            "opt": {i for i, (n, _) in enumerate(state.model.named_parameters()) if n in sharded}}


def _map_sharded(blob: dict, shardings: dict, fn) -> dict:
    """``blob`` with ``fn`` applied to each sharded tensor of AdamW's state
    and the rowwise optimizer's, in a fixed order (``fn`` may be a
    collective)."""
    out = dict(blob)
    for key in ("opt", "dense_opt"):
        if out.get(key) is None or not shardings.get(key):
            continue
        opt = dict(out[key])
        opt["state"] = {i: ({k: fn(v) if k in ("exp_avg", "exp_avg_sq") else v
                             for k, v in st.items()} if i in shardings[key] else st)
                        for i, st in sorted(opt["state"].items())}
        out[key] = opt
    for key in MOMENTS:
        if key in out and shardings.get(key):
            out[key] = {t: fn(v) if t in shardings[key] else v for t, v in sorted(out[key].items())}
    return out


def state_dict(state, mesh=None) -> dict:
    """The checkpoint of ``state``: its tensors (on their devices) and step;
    under a mesh that shards the tables, every sharded tensor gathered whole
    (a collective: every rank calls it)."""
    out = _local_state_dict(state)
    shardings = state_shardings(state, mesh)
    if not shardings["model"]:
        return out
    out["model"] = full_state_dict(state.model, mesh)
    return _map_sharded(out, shardings, lambda t: mesh.all_gather(t, "model"))


def _local_state_dict(state) -> dict:
    out = {"kind": state_kind(state), "model": state.model.state_dict(), "step": int(state.step)}
    if out["kind"] == "sparse":
        if state.pending is not None and state.pending.count:
            raise ValueError(f"a checkpoint at step {state.step} would lose "
                             f"{state.pending.count} steps of pending rows: flush them first")
        out["dense_opt"] = None if state.dense_opt is None else state.dense_opt.state_dict()
        for key in MOMENTS:
            out[key] = dict(getattr(state, key))
        out["applies"] = int(state.applies)
    else:
        out["opt"] = state.opt.state_dict()
    return out


def _load_adamw(opt, saved, what: str) -> None:
    if (opt is None) != (saved is None):
        raise ValueError(f"{what}: AdamW is {'absent' if saved is None else 'present'} in the "
                         f"checkpoint, {'absent' if opt is None else 'present'} in the state")
    if opt is None:
        return
    opt.load_state_dict(saved)
    for group in opt.param_groups:
        for p in group["params"]:
            for key in ("exp_avg", "exp_avg_sq"):
                m = opt.state.get(p, {}).get(key)
                if m is not None and m.shape != p.shape:
                    raise ValueError(f"{what}: AdamW's {key} has shape {tuple(m.shape)} for a "
                                     f"parameter of shape {tuple(p.shape)}")


def load_state_dict(state, blob: dict, mesh=None):
    """Copy the checkpoint ``blob`` into ``state`` in place and return it.
    Strict: the kinds must match, the model's parameters by name and shape
    (``load_state_dict(strict=True)``), AdamW's parameters by count and its
    moments by shape, the accumulators by table and shape. Under a mesh that
    shards the tables ``blob`` is whole (one process's) and each rank keeps
    its rows."""
    kind = state_kind(state)
    if blob.get("kind") != kind:
        raise ValueError(f"a {blob.get('kind')!r} checkpoint does not load into a {kind!r} "
                         "training state")
    shardings = state_shardings(state, mesh)
    if shardings["model"]:
        blob = _map_sharded({**blob, "model": shard_state_dict(blob["model"], state.model, mesh)},
                            shardings, lambda t: t[slice(*mesh.row_range(t.shape[0]))])
    _check_dtypes(state.model, blob["model"])
    state.model.load_state_dict(blob["model"], strict=True)
    if kind == "sparse":
        _load_adamw(state.dense_opt, blob["dense_opt"], "dense_opt")
        for key in MOMENTS:
            saved, live = blob.get(key, {}), getattr(state, key)
            if set(saved) != set(live):
                raise ValueError(f"{key} {sorted(saved)} does not match the state's "
                                 f"{sorted(live)} (another embedding_optimizer?)")
            for name, t in live.items():
                if saved[name].shape != t.shape:
                    raise ValueError(f"{key} {name}: shape {tuple(saved[name].shape)}, the "
                                     f"state has {tuple(t.shape)}")
                t.copy_(saved[name])
        state.applies = int(blob.get("applies", 0))
        if state.pending is not None:
            state.pending.valid.zero_()
            state.pending.count = 0
    else:
        _load_adamw(state.opt, blob["opt"], "opt")
    state.step = int(blob["step"])
    return state


def _check_dtypes(model, saved: dict) -> None:
    """A table's dtype must match (``load_state_dict`` would cast a float32
    table into a bfloat16 one without a word)."""
    for name, t in model.state_dict().items():
        if name in saved and saved[name].dtype != t.dtype:
            raise ValueError(f"{name}: the checkpoint holds {saved[name].dtype}, the model "
                             f"{t.dtype} (mesh.param_dtype differs?)")


def save_state_dict(path: str, blob: dict) -> str:
    """Write the checkpoint dict ``blob`` to ``path`` (through a temporary
    file, so a reader never sees half a checkpoint); returns ``path``."""
    tmp = f"{path}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_state(path: str, state, mesh=None) -> str:
    """Write ``state``'s checkpoint to ``path`` (under a mesh: gathered by
    every rank, written by process 0); returns ``path``."""
    blob = state_dict(state, mesh)
    if mesh is None or mesh.rank == 0:
        save_state_dict(path, blob)
    return path


def load_state(path: str) -> dict:
    """A checkpoint file's dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_weights(path: str, model, mesh=None) -> str:
    """``model``'s parameters alone as a ``kind`` "weights" checkpoint at
    ``path`` (under a mesh: gathered, written by process 0); returns
    ``path``."""
    blob = {"kind": "weights", "model": full_state_dict(model, mesh)}
    if mesh is None or mesh.rank == 0:
        save_state_dict(path, blob)
    return path


def load_weights(model, blob: dict, mesh=None):
    """Copy a weights-only checkpoint ``blob`` into ``model`` in place
    (strict, by name and shape; under a mesh each rank keeps its rows);
    returns ``model``."""
    if blob.get("kind") != "weights":
        raise ValueError(f"a {blob.get('kind')!r} checkpoint is not a weights-only one")
    model.load_state_dict(shard_state_dict(blob["model"], model, mesh), strict=True)
    return model


class CheckpointManager:
    """Step-indexed checkpoint files ``step_<step>.pt`` under ``directory``,
    of a state on ``mesh`` (or one process's)."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def save(self, step: int, state) -> None:
        save_state(self.path(step), state, self.mesh)

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default: the latest) into ``state``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        return load_state_dict(state, load_state(self.path(step)), self.mesh)

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def refuse_msgpack(path: str) -> None:
    raise SystemExit(f"{path}: a checkpoint of the JAX package (flax msgpack); convert it "
                     f"with {EXPORT_SCRIPT} (where JAX is installed) and pass the .pt it writes")


def resolve_ckpt(ckpt: str) -> str:
    """A checkpoint file, or an experiment dir's newest ``epoch_*.pt``."""
    if os.path.isdir(ckpt):
        cands = sorted(glob.glob(os.path.join(ckpt, "ckpts", "epoch_*.pt"))
                       or glob.glob(os.path.join(ckpt, "epoch_*.pt")))
        if cands:
            return cands[-1]
        if (glob.glob(os.path.join(ckpt, "ckpts", "epoch_*.msgpack"))
                or glob.glob(os.path.join(ckpt, "epoch_*.msgpack"))):
            refuse_msgpack(ckpt)
        raise FileNotFoundError(f"No epoch_*.pt under {ckpt}")
    if ckpt.endswith(".msgpack"):
        refuse_msgpack(ckpt)
    return ckpt
