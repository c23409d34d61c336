"""The row scatter's inputs as the training steps lay them out, for holding
:func:`~news_recsys_tpu_torch.ops.scatter_rows.scatter_rows_set` against its
plain version and timing it at the shapes the main paths give it.

A DCN step scatters 1,024 slots into its arena (on a model axis of 2,
each rank the same slots into its shard of it); the sparse attention step
hands each of its two large tables all 16,384 joint slots of a batch of
512, the other table's clamped to row 0 or the spare row
(:func:`~news_recsys_tpu_torch.training.sparse_step._joint_dedup`), and so
does the rowwise DSSM step (``item_id`` and ``hist`` in the item table,
``user_id`` in the user table, D 16).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.dssm import build_dssm
from ..models.embedding import padded_vocab
from ..models.rankers import build_ranker
from .sparse_step import _joint_dedup, _large_tables, collect_per_table


def arena_scatter_case(seed: int, slots: int = 1024) -> tuple:
    """(table, rows, vals) as numpy of a DCN step's scatter: the arena
    159,360 x 32, ``slots`` sorted slots with a duplicate every 7th, equal
    rows carrying equal values (the dedup's layout)."""
    rng = np.random.default_rng(seed)
    V, D = 159360, 32
    table = rng.standard_normal((V, D), np.float32)
    rows = np.sort(rng.integers(1, V, slots)).astype(np.int32)
    rows[1::7] = rows[0::7][: len(rows[1::7])]          # duplicates, still sorted
    rows.sort()
    vals = rng.standard_normal((slots, D)).astype(np.float32)[np.searchsorted(rows, rows)]
    return table, rows, vals


def arena_shard_scatter_case(seed: int, shard: int, shards: int = 2,
                             slots: int = 1024) -> tuple:
    """:func:`arena_scatter_case` as one rank of a model axis of ``shards``
    writes it: the shard's rows of the arena (79,680 of 159,360 at 2), the
    same sorted slots translated into the shard (``rows - shard * rows``, the
    other shards' slots outside it, which the scatter drops)."""
    table, rows, vals = arena_scatter_case(seed, slots)
    n = table.shape[0] // shards
    return table[shard * n:(shard + 1) * n].copy(), (rows - shard * n).astype(np.int32), vals


def attention_scatter_layouts(cfg, arrays: dict, seed: int) -> dict:
    """{table: (table (V, D), rows (S,) int32, vals (S, D))} as numpy: the
    sparse attention step's two scatters on one batch of ``arrays``, laid
    out by ``collect_per_table`` and ``_joint_dedup`` as its step does (each
    table gets every joint slot, the other table's clamped to row 0 or its
    spare row). Seeded row gradients; the values are the table's rows less
    0.01 of the summed gradient, equal on every slot of a row as the
    rowwise update leaves them."""
    model = build_ranker(cfg, seed=seed, device="cpu")
    return _layouts(model, [model.schema], arrays, seed)


def dssm_scatter_layouts(cfg, arrays: dict, seed: int) -> dict:
    """:func:`attention_scatter_layouts` of the rowwise DSSM step: the user
    tower's features, then the item tower's not in it (each collected once,
    as ``training/retrieval.py`` collects them)."""
    model = build_dssm(cfg, seed=seed, device="cpu")
    seen = {s.name for s in model.user_schema.specs}
    i_only = model.item_schema.subset([s.name for s in model.item_schema.specs
                                       if s.name not in seen])
    return _layouts(model, [model.user_schema, i_only], arrays, seed)


def _layouts(model, schemas, arrays: dict, seed: int) -> dict:
    batch = {k: torch.from_numpy(a) for k, a in arrays.items()}
    large = _large_tables(model.tables)
    rng = np.random.default_rng(seed)
    grads = {s.name: torch.from_numpy(rng.standard_normal(
        (*batch[s.name].shape, model.tables[s.table][1]), np.float32))
        for schema in schemas for s in schema.specs if s.table in large}
    spare = {t: padded_vocab(v) - 1 for t, (v, _) in model.tables.items()}
    per_table: dict = {}
    for schema in schemas:
        for t, pairs in collect_per_table(schema, batch, grads, large).items():
            per_table.setdefault(t, []).extend(pairs)
    layouts = _joint_dedup(per_table, dict(model.tables), spare)
    out = {}
    for t, (rows, g) in sorted(layouts.items()):
        table = model.embedder.tables[t].detach()
        vals = table[rows.long()] - 0.01 * g
        out[t] = (table.numpy().copy(), rows.numpy(), vals.numpy())
    return out


def update_route_case(cfg, arrays: dict, seed: int, table: str) -> tuple:
    """(table (V, D), ids (S,), grads (S, D)) as numpy: one large table's
    touched slots of a batch of ``arrays`` as ``collect_per_table`` hands
    them to the rowwise update (every feature's ids in the table's rows,
    seeded row gradients): the input of both AdaGrad routes."""
    model = build_ranker(cfg, seed=seed, device="cpu")
    batch = {k: torch.from_numpy(a) for k, a in arrays.items()}
    large = _large_tables(model.tables)
    rng = np.random.default_rng(seed)
    grads = {s.name: torch.from_numpy(rng.standard_normal(
        (*batch[s.name].shape, model.tables[s.table][1]), np.float32))
        for s in model.schema.specs if s.table in large}
    pairs = collect_per_table(model.schema, batch, grads, large)[table]
    return (model.embedder.tables[table].detach().numpy().copy(),
            torch.cat([p[0] for p in pairs]).numpy(), torch.cat([p[1] for p in pairs]).numpy())


def scatter_layout_stats(rows: np.ndarray, V: int) -> dict:
    """Distinct in-range rows, the longest run of one row, slots outside [0, V)."""
    starts = np.flatnonzero(np.diff(rows, prepend=rows[0] - 1))
    runs = np.diff(np.append(starts, rows.size))
    inside = (rows >= 0) & (rows < V)
    return {"distinct_rows": int(np.unique(rows[inside]).size),
            "longest_run": int(runs.max()), "out_of_range": int((~inside).sum())}
