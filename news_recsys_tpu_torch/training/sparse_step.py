"""Sparse (rowwise) embedding training step for the rankers.

Port of :mod:`news_recsys_tpu.training.sparse_step`: the body of its
``make_sparse_chunk_fn``, one step per call and eager, with both rowwise
optimizers, K-step lazy write-back and bfloat16 tables.

1. the step gathers the touched rows of every LARGE table (vocab >=
   ``SMALL_VOCAB_THRESHOLD``) itself, one gather per feature (a bfloat16
   table's rows upcast to float32 right after it), and differentiates the
   loss with respect to those gathered rows (detached copies that require
   grad), so no (V, D) gradient exists; the small tables, the cross stack
   and the MLP are differentiated directly;
2. AdamW (``torch.optim.AdamW``, optax's ``adamw`` formula) steps the dense
   parameters and the small tables;
3. the touched ids of all large tables are deduplicated, and the rowwise
   optimizer writes the touched rows back (:func:`make_table_updater`):
   ``rowwise_adagrad`` (one (V,) accumulator a table) or ``sparse_adamw``
   (per-element (V, D) float32 moments, bias correction from the step).

The dedup layout follows the JAX package's gate on ``mesh.param_dtype``:

- float32 (the sorted layout, :func:`_joint_dedup`): one joint id space, rows
  non-decreasing, every duplicate slot carrying its row's summed gradient,
  invalid slots at a spare row above the vocab with zero gradient; every
  (V, D) write goes through the row scatter kernel
  (:func:`~news_recsys_tpu_torch.ops.scatter_rows.scatter_rows_set`): the
  table for AdaGrad, the table, ``mu`` and ``nu`` for Adam;
- bfloat16 (the unique-row layout, :func:`_unique_rows`, JAX's ``"xla"``):
  each distinct row on one slot, its first occurrence, written once by a
  plain ``index_put_``, so each row is rounded once. A bfloat16 table's
  updated rows are stochastically rounded (:func:`stochastic_round_bf16`)
  with 16-bit noise from :func:`rounding_noise`; the moments and
  accumulators stay float32.

With ``embedding_update_period`` K > 1 the step only buffers its (ids,
grads) at slot ``step mod K`` of preallocated (K, S) / (K, S, D) device
buffers (:class:`PendingRows`); the step's ``flush`` applies one combined
update of everything pending, with the lr at the apply step and Adam's bias
correction and the rounding noise counted by the state's apply counter.
:class:`~.trainer.Trainer` flushes every K steps counted from a chunk's
start and at the chunk's end, where the JAX trainer's scanned chunks end.

A table takes the dense full-table AdaGrad route
(:func:`dense_rowwise_adagrad_update`) where an update's touched slots reach
``DENSE_UPDATE_MIN_SHARE`` of its rows, a threshold measured on the H100
(``PERF.md``): the sparse attention step's and the rowwise DSSM step's item
tables take it, the DCN's arena does not.

Under a :class:`~news_recsys_tpu_torch.parallel.mesh.Mesh` (``mesh=``):

- every rank runs its slice of the global batch (the data axis); a
  row-sharded table (the model axis) is read through the id exchange
  (:func:`~news_recsys_tpu_torch.models.embedding.take_rows`), for the
  gathered large-table rows and the small tables alike;
- the loss is the global batch's mean: each rank divides its sum by the
  global weight sum, and the gradients of the replicated parameters (and
  of a small table's shard) are summed over the data axis in one flat
  buffer (:func:`sum_over_data`), the step's loss with them;
- each rank's (ids, row grads) slots are gathered over the data axis in
  batch order (:func:`gather_slots`), so every rank dedups the global
  batch's slots as one device does; a sharded table's update then writes
  only its own rows (:func:`make_sharded_adagrad_update`,
  :func:`make_sharded_rowwise_update`) with no collective: the slots
  translate to shard-local rows, and the foreign ones fall outside the
  shard and are dropped. In the sorted layout the row scatter kernel is
  that shard-local write (it drops rows outside ``[0, V)``, and sorted rows
  minus a constant stay sorted): one launch a table a step on each rank,
  three for ``sparse_adamw``. JAX keeps its Pallas scatter off this route
  because its window walk needs every row in range; the port's kernel has
  no such limit. Other tables' slots of the joint dedup and invalid slots
  route out of every shard (``OOB_ROW``, or -1 below a table's range), so
  Adam's weight decay never moves a padding or spare row, as JAX's
  ``OOB_ROW`` has it; on one device they clip onto those rows. The dense
  AdaGrad route is taken on unsharded tables only, as in JAX;
- the AUC histogram stays per rank; the trainer sums it over the data axis
  where it reads it.

Where JAX rebuilt arrays, the port updates in place under
``torch.no_grad()``: the tables, the optimizer state and the AUC histogram.
The gathered rows are copies, so writing a table after ``backward()`` is
safe. An unpooled array feature (the attention ranker's ``hist``) keeps its
gathered rows (B, L, D) as the field; their gradient flattens into the
table's B*L slots in :func:`collect_per_table`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ARRAY, DENSE, SPARSE, Config

from ..models.embedding import SMALL_VOCAB_THRESHOLD, offset_ids, padded_vocab, take_rows
from ..ops.scatter_rows import scatter_rows_set, write_kept
from ..parallel.mesh import sharded_names
from ..parallel.sharded_embedding import active_mesh
from ..utils.logging import get_logger
from ..utils.profiling import active, count, span
from .schedule import hold_cosine_floor
from .trainer import AucHist, binned_auc_update

EPS_POOL = 1e-8
ADAGRAD_INIT_ACC = 0.1   # TF/TPUEmbedding default initial accumulator
ADAM_EPS = 1e-8
OOB_ROW = 2 ** 29        # the joint dedup's spare row, above every joint id: out of every shard
SENTINEL = 2 ** 30       # sort key of an invalid slot: after every real id
DENSE_ROUTE_INDEX = 1000  # the dense route's noise index: 1000 + its table's index
# Rowwise AdaGrad takes the dense full-table route for a table whose touched
# slots in an update reach this share of its rows. The JAX package compares
# the slots alone with 4,096 (TPU tuning); on the H100 the dense route's cost
# follows the rows it streams and the sorted route's the slots. Measured by
# ``chip_profile.py --routes`` (PERF.md, "Update routes"): the dense route
# wins eager and on the card at 15,872 slots of the attention item table's
# 65,280 rows (a share of 0.24), loses on the card at 1,024 of the arena's
# 159,360 (0.006) and ties at 16,384 (0.10), the two device times crossing
# near 0.12.
DENSE_UPDATE_MIN_SHARE = 1 / 8
ROWWISE = ("rowwise_adagrad", "sparse_adamw")

logger = get_logger("sparse_step")


def _large_tables(tables_spec) -> set:
    return {t for t, (v, d) in dict(tables_spec).items() if v >= SMALL_VOCAB_THRESHOLD}


def check_sparse(cfg: Config) -> None:
    """The optimizer must be one of this module's."""
    if cfg.train_hparams.embedding_optimizer not in ROWWISE:
        raise ValueError(f"the sparse step runs embedding_optimizer in {ROWWISE}; "
                         f"{cfg.train_hparams.embedding_optimizer!r} trains on the all-dense "
                         "step (training/dense_step.py)")


@dataclass
class PendingRows:
    """K-step write-back buffers on the device: per large table the ids (K,
    S) and row gradients (K, S, D) of the steps since the last apply, at
    slot ``step mod K``; ``valid`` (K,) marks the filled slots and ``count``
    counts them on the host."""

    ids: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]
    valid: torch.Tensor
    count: int = 0


@dataclass
class SparseTrainState:
    """The model (its parameters are the training state), one AdamW over the
    dense parameters and the small tables (None when there are none: an LR
    whose every table is large), the large tables' rowwise optimizer state
    (``rowwise_adagrad``: the (V,) accumulators ``emb_acc``; ``sparse_adamw``:
    the (V, D) float32 moments ``emb_mu`` and ``emb_nu``), the number of
    steps taken and, for K-step write-back, the number of combined updates
    applied and the pending rows."""

    model: nn.Module
    dense_opt: Optional[torch.optim.AdamW]
    emb_acc: Dict[str, torch.Tensor]
    step: int = 0
    emb_mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    emb_nu: Dict[str, torch.Tensor] = field(default_factory=dict)
    applies: int = 0
    pending: Optional[PendingRows] = None


def dense_parameters(model: nn.Module) -> list:
    """(name, parameter) for every parameter but the large tables, in
    ``named_parameters`` order: the ones AdamW steps."""
    large = {f"embedder.tables.{t}" for t in _large_tables(model.tables)}
    return [(n, p) for n, p in model.named_parameters() if n not in large]


def make_dense_tx(cfg: Config, params) -> Optional[torch.optim.AdamW]:
    """AdamW with the config's betas and weight decay, eps 1e-8: optax's
    ``adamw`` formula (decay scaled by the lr, 1-based bias correction, eps
    after the square root) in one group, as optax applies no mask. The lr is
    set on the group before every step (:func:`make_sparse_train_step`).
    None for an empty ``params``: ``torch.optim`` refuses an empty list
    where optax steps an empty tree."""
    params = list(params)
    if not params:
        return None
    hp = cfg.train_hparams
    return torch.optim.AdamW(params, lr=hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)(0),
                             betas=(hp.b1, hp.b2), eps=ADAM_EPS, weight_decay=hp.weight_decay)


def init_sparse_state(model: nn.Module, cfg: Config) -> SparseTrainState:
    """The training state of ``model``'s current parameters. The large
    tables stop requiring grad: the step differentiates their gathered rows.
    The optimizer state is float32 whatever the tables' dtype."""
    check_sparse(cfg)
    tables = model.embedder.tables
    emb_acc, emb_mu, emb_nu = {}, {}, {}
    adagrad = cfg.train_hparams.embedding_optimizer == "rowwise_adagrad"
    for name in sorted(_large_tables(model.tables)):
        t = tables[name].requires_grad_(False)
        if adagrad:
            emb_acc[name] = torch.full((t.shape[0],), ADAGRAD_INIT_ACC, device=t.device)
        else:
            emb_mu[name] = torch.zeros(t.shape, device=t.device)
            emb_nu[name] = torch.zeros(t.shape, device=t.device)
    return SparseTrainState(model, make_dense_tx(cfg, [p for _, p in dense_parameters(model)]),
                            emb_acc, emb_mu=emb_mu, emb_nu=emb_nu)


def gather_large_rows(schema, batch, tables, large, mesh=None) -> Dict[str, torch.Tensor]:
    """Per-feature gathered LARGE-table rows in float32, one gather per
    feature (even for features sharing a table); ids outside a table read
    NaN. ``mesh``: the model axis that shards the tables (the id exchange),
    or None."""
    return {spec.name: take_rows(tables[spec.table], offset_ids(spec, batch[spec.name]),
                                 mesh).float()
            for spec in schema.specs if spec.kind in (SPARSE, ARRAY) and spec.table in large}


def fields_from_rows(schema, batch, rows, tables, large, unpooled=(), mesh=None) -> tuple:
    """(fields, masks): the per-field embeddings in schema order, as
    ``embed_fields`` builds them, from the gathered large-table ``rows`` and
    the small ``tables`` (read through ``mesh``'s id exchange where it shards
    them). Array features are masked-mean pooled here, except those in
    ``unpooled``, which stay (B, L, D) and whose float masks are returned by
    name."""
    fields, masks = [], {}
    for spec in schema.specs:
        if spec.kind == DENSE:
            fields.append(batch[spec.name].to(torch.float32)[:, None])
            continue
        ids = offset_ids(spec, batch[spec.name])
        r = rows[spec.name] if spec.table in large else take_rows(tables[spec.table], ids, mesh)
        r = r * (ids != 0).to(r.dtype)[..., None]
        if spec.kind == ARRAY:
            mask = batch.get(f"{spec.name}_mask")
            m = (ids != 0 if mask is None else mask).to(torch.float32)
            if spec.name in unpooled:
                masks[spec.name] = m
            else:
                m = m[..., None]
                r = (r * m).sum(dim=1) / (m.sum(dim=1) + EPS_POOL)
        fields.append(r)
    return fields, masks


def collect_per_table(schema, batch, row_grads, large) -> Dict[str, list]:
    """Group flat (ids, row-grads, id offset) entries by large table, in
    schema order. The offset tags an arena member's disjoint id range."""
    per_table: Dict[str, list] = {}
    for spec in schema.specs:
        if spec.kind not in (SPARSE, ARRAY) or spec.table not in large:
            continue
        g = row_grads[spec.name]
        per_table.setdefault(spec.table, []).append(
            (offset_ids(spec, batch[spec.name]).reshape(-1), g.reshape(-1, g.shape[-1]),
             spec.id_offset))
    return per_table


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int, skip: int = -1) -> torch.Tensor:
    """(n, D): the rows of ``vals`` summed by ``seg``, leaving out the slots
    of segment ``skip``. Embedding's backward: it adds each segment's terms
    in one order on every run, on the card too, where ``index_add_`` adds
    by atomics in no fixed order; on the CPU it adds them in slot order."""
    return torch.ops.aten.embedding_dense_backward(vals, seg.long(), n, skip, False)


def _sorted_segments(ids: torch.Tensor, grads: torch.Tensor, max_id: Optional[int]):
    """(sids, order, first, gsum): the ids sorted stably with the invalid ones
    (padding 0, negative, above ``max_id``) as SENTINEL, the permutation,
    the first slot of each run of equal ids, and each slot's run's summed
    gradient."""
    valid = ids > 0
    if max_id is not None:
        valid &= ids <= max_id
    sids, order = torch.sort(torch.where(valid, ids, SENTINEL), stable=True)
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0) - 1
    return sids, order, first, segment_sum(grads[order], seg, ids.shape[0])[seg]


def _dedup_rows(ids: torch.Tensor, grads: torch.Tensor, spare_row: int,
                max_id: int | None = None):
    """Combine duplicate ids in the sorted layout; returns (rows int32 (N,),
    grads (N, D)).

    Rows are non-decreasing. Each slot of a valid id keeps the id and
    carries the sum of all its duplicates' gradients, so the optimizer
    computes one value for all of them and a set-scatter is exact. Padding
    id 0, negative ids and ids above ``max_id`` are invalid: their slots
    point at ``spare_row`` (>= every real id, so the order holds) with zero
    gradient, which rowwise AdaGrad leaves unchanged.
    """
    sids, _, _, gsum = _sorted_segments(ids, grads, max_id)
    valid_slot = sids < SENTINEL
    rows = torch.where(valid_slot, sids, spare_row).to(torch.int32)
    return rows, torch.where(valid_slot[:, None], gsum, 0.0)


def _unique_rows_of(ids: torch.Tensor, grads: torch.Tensor, spare_row: int, max_id: int):
    """The unique-row layout (JAX's ``"xla"`` layout): each valid id on the
    slot of its first occurrence with its duplicates' summed gradient, every
    other slot at ``spare_row`` with zero gradient. The slots are those of
    JAX's sort-free dedup (``_dedup_rows_matmul``), so a slot's rounding
    noise lands on the same row as there."""
    sids, order, first, gsum = _sorted_segments(ids, grads, max_id)
    active = first & (sids < SENTINEL)
    rows = torch.empty_like(sids)
    rows[order] = torch.where(active, sids, spare_row)      # a permutation: one write a slot
    out = torch.empty_like(grads)
    out[order] = torch.where(active[:, None], gsum, 0.0)
    return rows.to(torch.int32), out


def _unique_rows(per_table, table_vocab, spare) -> Dict[str, tuple]:
    """{table: (rows, grads)} in the unique-row layout, each table on its
    own. An arena's entries go in the order of their id offsets, as the JAX
    package concatenates its per-member dedups."""
    out = {}
    for t, pairs in sorted(per_table.items()):
        pairs = sorted(pairs, key=lambda p: p[2] if len(p) > 2 else 0)    # stable
        ids, g = torch.cat([p[0] for p in pairs]), torch.cat([p[1] for p in pairs])
        out[t] = _unique_rows_of(ids, g, spare[t], int(table_vocab[t][0]) - 1)
    return out


def _joint_dedup(per_table, table_vocab, spare, sharded: bool = False) -> Dict[str, tuple]:
    """Sort-dedup the touched ids of all large tables in one joint sort;
    returns {table: (rows, grads)} in the sorted layout, ready to scatter.

    One table dedups alone with ``max_id = vocab - 1``. Several tables
    share one id space: each table's ids shift into a disjoint range, grads
    zero-pad to the widest dim, and after the dedup each table takes back
    its own slots; the other tables' slots clip into ``[0, spare]`` (keeping
    the rows sorted) with zero gradient.

    With ``sharded`` (tables row-sharded over a model axis, ``spare`` at
    ``OOB_ROW``) the other tables' slots route out of every shard instead:
    -1 below the table's range, ``OOB_ROW`` above it, which keeps the rows
    sorted; clipped, they would land inside shard 0 or the last shard, where
    Adam's weight decay would move row 0 or the spare row.

    Unlike the JAX package, an id at or past its own table's vocab is
    dropped before the shift: there, an id above ``vocab`` lands in the next
    table's range and updates that table's row with this table's gradient.
    """
    names = sorted(per_table)
    flat = {t: (torch.cat([p[0] for p in per_table[t]]), torch.cat([p[1] for p in per_table[t]]))
            for t in names}
    if not names:
        return {}
    if len(names) == 1:
        t = names[0]
        return {t: _dedup_rows(*flat[t], spare[t], max_id=int(table_vocab[t][0]) - 1)}
    dmax = max(g.shape[-1] for _, g in flat.values())
    offsets, off = {}, 0
    joint_ids, joint_g = [], []
    for t in names:
        ids, g = flat[t]
        vocab = int(table_vocab[t][0])
        offsets[t] = off
        joint_ids.append(torch.where((ids > 0) & (ids < vocab), ids + off, 0))
        joint_g.append(F.pad(g, (0, dmax - g.shape[-1])))
        off += vocab + 1
    rows_j, grads_j = _dedup_rows(torch.cat(joint_ids), torch.cat(joint_g), OOB_ROW, max_id=off)
    out = {}
    for t in names:
        v, d = table_vocab[t]
        local = rows_j - offsets[t]
        mine = (local >= 1) & (local < v)
        rows = (torch.where(mine, local, torch.where(local < 1, -1, OOB_ROW)) if sharded
                else local.clamp(0, spare[t]))
        out[t] = (rows.to(torch.int32), torch.where(mine[:, None], grads_j[:, :d], 0.0))
    return out


def distinct_real_rows(ids: torch.Tensor, vocab: int) -> int:
    """The distinct real rows (1 to ``vocab - 1``) among ``ids``: a wait for
    the device."""
    return int(torch.unique(ids[(ids >= 1) & (ids < vocab)]).numel())


def stochastic_round_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 with stochastic rounding: ``noise`` (x's shape,
    integers in [0, 2**16)) is added below the bfloat16 mantissa boundary
    and the low 16 bits are cut, so a value rounds up with the probability
    of its position between its two bfloat16 neighbours; a value that
    bfloat16 holds passes through. The JAX package draws the noise inside
    (``jax.random.bits``); here it is an argument, the same bits give the
    same result bit for bit."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + noise.to(torch.int32)) & -65536        # & 0xFFFF0000, wrapping as uint32
    return rounded.view(torch.float32).to(torch.bfloat16)


NoiseFn = Callable[[int, int, tuple, torch.device], torch.Tensor]


def rounding_noise(seed: int) -> NoiseFn:
    """``noise(step, index, shape, device)``: uniform 16-bit integers (int32)
    for stochastic rounding, drawn on ``device`` by a generator seeded from
    ``SeedSequence([seed, step, index])``, so a step's bits depend on its
    step and table alone (a resumed run repeats them). The card's and the
    CPU's generators give different bits for one seed: a comparison of the
    two hands both the same noise function."""
    generators: Dict[str, torch.Generator] = {}

    def noise(step: int, index: int, shape, device) -> torch.Tensor:
        device = torch.device(device)
        g = generators.get(str(device))
        if g is None:
            g = generators[str(device)] = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, step, index]).generate_state(1)[0]))
        return torch.randint(0, 1 << 16, tuple(shape), generator=g, device=device,
                             dtype=torch.int32)

    return noise


def _storable(x: torch.Tensor, table: torch.Tensor, noise) -> torch.Tensor:
    """Updated float32 rows in ``table``'s dtype: a bfloat16 table's rounded
    stochastically with ``noise`` (x's shape)."""
    if table.dtype != torch.bfloat16:
        return x.to(table.dtype)
    if noise is None:
        raise ValueError("a bfloat16 table's write-back needs rounding noise")
    return stochastic_round_bf16(x, noise)


def write_rows(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``table[rows] = vals`` in place in plain PyTorch: the unique-row
    layout's write (any dtype; a row named twice gets one of its values)."""
    return table.index_put_((rows.long(),), vals)


def write_kept_rows(table: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``table[rows] = vals`` in place in plain PyTorch, rows outside
    ``[0, V)`` (a shard's foreign slots) dropped, in any order and without
    waiting for the device (:func:`~news_recsys_tpu_torch.ops.scatter_rows.
    write_kept`). Rows named twice must carry equal values (both layouts
    give them)."""
    if rows.numel() == 0:
        return table
    rows = rows.long()
    return write_kept(table, rows, vals, (rows >= 0) & (rows < table.shape[0]))


def _read_index(rows: torch.Tensor, V: int, drop: bool) -> torch.Tensor:
    """The rows to read: ``rows``, clamped into the table where rows outside
    it are to be dropped (their values are computed and not written)."""
    idx = rows.long()
    return idx.clamp(0, V - 1) if drop else idx


def _set_vector(vec: torch.Tensor, rows, idx, vals, drop: bool) -> None:
    """``vec[rows] = vals`` for a (V,) accumulator, dropping rows outside it
    with ``drop``."""
    if drop:
        write_kept_rows(vec[:, None], rows, vals[:, None])
    else:
        vec[idx] = vals


def rowwise_adagrad_update(table, acc, rows, grads, lr, eps=1e-10, noise=None,
                           write=scatter_rows_set, drop=False):
    """Rowwise AdaGrad on the given rows, in place (TPUEmbedding/torchrec
    semantics): one scalar accumulator per row, ``acc += mean(g^2)``,
    ``p -= lr * g / (sqrt(acc) + eps)``, in float32 whatever the table's
    dtype (a bfloat16 table's rows are rounded with ``noise``). ``write``
    writes the table's rows: the row scatter kernel in the sorted layout
    (``rows`` sorted, as :func:`_dedup_rows` gives them), :func:`write_rows`
    in the unique one; the (V,) accumulator write is a plain ``index_put_``.
    With ``drop`` (a shard's update) rows outside the table are read clamped
    and written nowhere; ``write`` must drop them too."""
    idx = _read_index(rows, table.shape[0], drop)
    acc_rows = acc[idx] + (grads * grads).mean(dim=-1)
    p_new = table[idx].float() - lr * grads / (acc_rows.sqrt() + eps)[:, None]
    write(table, rows, _storable(p_new, table, noise))
    _set_vector(acc, rows, idx, acc_rows, drop)
    return table, acc


def rowwise_adam_update(table, mu, nu, rows, grads, lr, t, b1, b2, eps, wd, noise=None,
                        write=scatter_rows_set, drop=False):
    """Adam on the given rows only, in place, with bias correction from
    ``t`` (the 1-based global step, or apply count for K-step write-back)
    and decoupled weight decay on the touched rows. Math in float32; a
    bfloat16 table's rows are rounded with ``noise``. ``write`` writes the
    three (V, D) row sets (table, ``mu``, ``nu``): three launches of the row
    scatter kernel in the sorted layout. ``drop``: as
    :func:`rowwise_adagrad_update`'s."""
    idx = _read_index(rows, table.shape[0], drop)
    p_rows = table[idx].float()
    mu_new = b1 * mu[idx] + (1 - b1) * grads
    nu_new = b2 * nu[idx] + (1 - b2) * grads * grads
    mhat = mu_new / (1 - b1 ** t)
    vhat = nu_new / (1 - b2 ** t)
    p_new = p_rows - lr * (mhat / (vhat.sqrt() + eps) + wd * p_rows)
    write(table, rows, _storable(p_new, table, noise))
    write(mu, rows, mu_new)
    write(nu, rows, nu_new)
    return table, mu, nu


def dense_rowwise_adagrad_update(table, acc, ids, grads, lr, eps=1e-10, max_id=None,
                                 noise=None):
    """Rowwise AdaGrad as a dense pass over the whole table, in place: no
    sort, no dedup, no row scatter. Plain PyTorch, as the JAX package's is
    XLA code.

    The per-row summed gradient (V, D) comes from :func:`segment_sum` (the
    same bits every run; padding, negative ids and ids above ``max_id``
    add nothing), then ``acc += mean(g^2)`` and the parameter step run
    over every row, and rows whose ``mean(g^2)`` is 0 keep their values.
    Equal to :func:`rowwise_adagrad_update` on the deduped rows: AdaGrad
    leaves a row with an all-zero gradient as it is. A bfloat16 table is
    rounded with ``noise`` of the table's shape."""
    V = table.shape[0]
    bound = V if max_id is None else max_id + 1
    safe = torch.where((ids > 0) & (ids < bound), ids, 0)
    dense_g = segment_sum(grads, safe, V, skip=0)
    g2 = (dense_g * dense_g).mean(dim=-1)
    acc.add_(g2)
    p_new = table.float() - lr * dense_g / (acc.sqrt() + eps)[:, None]
    p_new = _storable(p_new, table, noise)
    table.copy_(torch.where((g2 > 0)[:, None], p_new, table))
    return table, acc


def shard_local_rows(rows: torch.Tensor, mesh, rows_local: int) -> torch.Tensor:
    """Global rows -> rows of this rank's shard (``rows_local`` rows): the
    foreign ones fall outside ``[0, rows_local)``. Sorted rows stay sorted."""
    return rows - mesh.model_index * rows_local


def make_sharded_adagrad_update(mesh):
    """Rowwise AdaGrad over a table row-sharded on ``mesh``'s model axis:
    ``update(shard, acc, rows, grads, lr, eps, noise, write)`` with the
    deduped global ``rows``/``grads`` replicated on every rank, in place on
    this rank's ``shard`` and (Vl,) ``acc``. Each rank translates the rows to
    its own range and writes only those (``write``: the row scatter kernel in
    the sorted layout, :func:`write_kept_rows` in the unique one); foreign
    and invalid slots fall outside the shard and are dropped. No
    collective."""
    def update(shard, acc, rows, grads, lr, eps=1e-10, noise=None, write=scatter_rows_set):
        return rowwise_adagrad_update(shard, acc, shard_local_rows(rows, mesh, shard.shape[0]),
                                      grads, lr, eps, noise=noise, write=write, drop=True)

    return update


def make_sharded_rowwise_update(mesh):
    """Rowwise Adam (``sparse_adamw``) over a row-sharded table, as
    :func:`make_sharded_adagrad_update`: ``update(shard, mu, nu, rows, grads,
    lr, t, b1, b2, eps, wd, noise, write)``, the (Vl, D) moments sharded
    like the table; three shard-local writes."""
    def update(shard, mu, nu, rows, grads, lr, t, b1, b2, eps, wd, noise=None,
               write=scatter_rows_set):
        return rowwise_adam_update(shard, mu, nu, shard_local_rows(rows, mesh, shard.shape[0]),
                                   grads, lr, t, b1, b2, eps, wd, noise=noise, write=write,
                                   drop=True)

    return update


def make_table_updater(cfg: Config, tables_spec, noise: Optional[NoiseFn] = None, mesh=None):
    """``update(state, per_table, step, lr)``: the configured rowwise
    optimizer on the touched rows of the large tables, in place;
    ``per_table`` maps a table to the (flat ids, flat row-grads, offset)
    entries of the features sharing it, ``step`` counts the updates before
    this one (Adam's bias correction and the rounding noise).

    A table whose slots reach ``DENSE_UPDATE_MIN_SHARE`` of its rows takes
    the dense AdaGrad route. As in the JAX package, tables are taken in
    sorted order, the dense route's first; a bfloat16 table's rounding noise
    is ``noise(step, i, shape, device)`` for the ``i``-th table
    (``DENSE_ROUTE_INDEX + i`` on the dense route, as JAX's
    ``fold_in(step_key, 1000 + ti)``). ``noise`` defaults to
    :func:`rounding_noise` of ``train_hparams.seed``.

    With a ``mesh`` whose model axis shards the tables, ``per_table`` holds
    the global batch's slots on every rank, invalid and foreign slots route
    to ``OOB_ROW``, no table takes the dense route, and each rank writes its
    own rows (:func:`make_sharded_adagrad_update`,
    :func:`make_sharded_rowwise_update`). The noise of a slot is the same on
    every rank, and each row is written by one rank: the rounding matches
    one device's."""
    check_sparse(cfg)
    hp = cfg.train_hparams
    adagrad = hp.embedding_optimizer == "rowwise_adagrad"
    unique = cfg.mesh.param_dtype == "bfloat16"
    sharded = mesh is not None and mesh.model > 1
    write = (write_kept_rows if sharded else write_rows) if unique else scatter_rows_set
    noise = noise or rounding_noise(hp.seed)
    table_vocab = dict(tables_spec)
    if sharded:
        spare = {t: OOB_ROW for t in table_vocab}
        adagrad_update, adam_update = (make_sharded_adagrad_update(mesh),
                                       make_sharded_rowwise_update(mesh))
    else:
        spare = {t: padded_vocab(v) - 1 for t, (v, d) in table_vocab.items()}
        adagrad_update, adam_update = rowwise_adagrad_update, rowwise_adam_update

    def dense_route(t: str, pairs) -> bool:
        slots = sum(p[0].shape[0] for p in pairs)
        return (adagrad and not sharded
                and slots >= DENSE_UPDATE_MIN_SHARE * padded_vocab(table_vocab[t][0]))

    def noise_of(table, step: int, index: int, shape):
        if table.dtype != torch.bfloat16:
            return None
        return noise(step, index, shape, table.device)

    routes_logged = set()

    def log_routes(per_table, dense) -> None:
        """Each table's route, logged the first time the table takes it."""
        for t, pairs in sorted(per_table.items()):
            route = ("dense" if t in dense else "unique-row, plain write" if unique
                     else "sorted, row scatter")
            if (t, route) not in routes_logged:
                routes_logged.add((t, route))
                logger.info(f"table {t}: {route} route at {sum(p[0].shape[0] for p in pairs)} "
                            f"slots of {padded_vocab(table_vocab[t][0])} rows")

    def count_rows(per_table, tables, dense_ids, layouts) -> None:
        """Each table's ``rows.passed`` (the dense route's whole table, a row
        route's slots) and ``rows.distinct`` (the distinct real rows of its
        ids or its layout's rows, counted when the spans are read: no launch
        here) on the open span."""
        for t, pairs in sorted(per_table.items()):
            if t in dense_ids:
                passed, ids = tables[t].shape[0], dense_ids[t]
            else:
                passed, ids = sum(p[0].shape[0] for p in pairs), layouts[t][0]
            count(f"rows.passed.{t}", passed)
            count(f"rows.distinct.{t}",
                  partial(distinct_real_rows, ids, int(table_vocab[t][0])))

    def update(state, per_table, step: int, lr: float) -> None:
        tables = state.model.embedder.tables
        dense = sorted(t for t, pairs in per_table.items() if dense_route(t, pairs))
        log_routes(per_table, dense)
        dense_ids = {t: torch.cat([p[0] for p in per_table[t]]) for t in dense}
        for ti, t in enumerate(dense):
            dense_rowwise_adagrad_update(
                tables[t], state.emb_acc[t], dense_ids[t],
                torch.cat([p[1] for p in per_table[t]]), lr, max_id=int(table_vocab[t][0]) - 1,
                noise=noise_of(tables[t], step, DENSE_ROUTE_INDEX + ti, tables[t].shape))
        rest = {t: pairs for t, pairs in per_table.items() if t not in dense}
        layouts = (_unique_rows(rest, table_vocab, spare) if unique
                   else _joint_dedup(rest, table_vocab, spare, sharded))
        if active():
            count_rows(per_table, tables, dense_ids, layouts)
        for ti, (t, (rows, grads)) in enumerate(sorted(layouts.items())):
            nz = noise_of(tables[t], step, ti, grads.shape)
            if adagrad:
                adagrad_update(tables[t], state.emb_acc[t], rows, grads, lr, noise=nz,
                               write=write)
            else:
                adam_update(tables[t], state.emb_mu[t], state.emb_nu[t], rows, grads,
                            lr, step + 1, hp.b1, hp.b2, ADAM_EPS, hp.weight_decay,
                            noise=nz, write=write)

    return update


def sparse_state_shardings(state: SparseTrainState, mesh) -> dict:
    """Which of a sparse state's tensors lie on shards of the model axis, in
    the layout of its checkpoint (:func:`~.checkpoint.state_dict`): the
    model's parameter names, AdamW's parameter indices (its state is keyed
    by position in ``dense_parameters``) and the rowwise optimizer's tables
    (every large table is sharded), each a set; all empty without a model
    axis."""
    sharded = sharded_names(state.model, mesh)
    names = [n for n, _ in dense_parameters(state.model)]
    rowwise = {k: set(getattr(state, k)) if sharded else set()
               for k in ("emb_acc", "emb_mu", "emb_nu")}
    return {"model": sharded, "dense_opt": {i for i, n in enumerate(names) if n in sharded},
            **rowwise}


def sum_over_data(mesh, params, *scalars: torch.Tensor) -> list:
    """Sum the gradients of ``params`` (those that have one: the same ones on
    every rank) and the 0-dim ``scalars`` over the data axis, in place, in
    one flat buffer; returns the summed scalars. Without a data axis:
    nothing moves."""
    if mesh is None or mesh.data == 1:
        return list(scalars)
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [x.detach().reshape(1).to(torch.float32) for x in scalars])
    mesh.all_reduce_(flat, "data")
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return list(flat[off:])


def gather_slots(per_table, mesh):
    """The global batch's ``per_table``: every (ids, row grads, offset) entry
    of every rank gathered over the data axis in rank order, which is batch
    order, in one flat buffer (the int32 ids travel as float32 bits).
    Without a data axis: ``per_table`` itself."""
    entries = [(t, e) for t in sorted(per_table) for e in per_table[t]]
    if mesh is None or mesh.data == 1 or not entries:
        return per_table
    flat = torch.cat([x for _, (ids, g, *_) in entries
                      for x in (ids.to(torch.int32).view(torch.float32), g.reshape(-1))])
    ranks = mesh.all_gather(flat, "data").view(mesh.data, -1)
    out: Dict[str, list] = {}
    off = 0
    for t, (ids, g, *rest) in entries:
        gi = ranks[:, off:off + ids.numel()].contiguous().view(torch.int32).reshape(-1)
        off += ids.numel()
        gg = ranks[:, off:off + g.numel()].reshape(-1, g.shape[-1])
        off += g.numel()
        out.setdefault(t, []).append((gi.to(ids.dtype), gg, *rest))
    return out


def sharded_tables(model: nn.Module, mesh):
    """The mesh whose model axis shards ``model``'s tables (its lookups go
    through the id exchange), or None; raises where ``mesh`` has a model
    axis and the tables were not cut to it
    (:func:`~news_recsys_tpu_torch.parallel.sharded_embedding.shard_parameters`)."""
    embedder = getattr(model, "embedder", None)         # NRMS has no embedding collection
    if mesh is not None and mesh.model > 1 and active_mesh(embedder) is not mesh:
        raise ValueError(f"{mesh} shards the tables: cut the model to it "
                         "(shard_parameters) before making its step")
    return active_mesh(embedder)


def global_weight_sum(weights: torch.Tensor, mesh) -> torch.Tensor:
    """The batch's weight sum over the data axis (the loss's denominator)."""
    total = weights.sum()
    if mesh is None or mesh.data == 1:
        return total
    return mesh.all_reduce_(total.clone(), "data")


def _pending_rows(per_table, K: int) -> PendingRows:
    """Zeroed write-back buffers sized by one step's ``per_table``."""
    ids, grads = {}, {}
    for t, pairs in per_table.items():
        i, g = torch.cat([p[0] for p in pairs]), torch.cat([p[1] for p in pairs])
        ids[t] = i.new_zeros((K, *i.shape))
        grads[t] = g.new_zeros((K, *g.shape))
    device = next(iter(ids.values())).device
    return PendingRows(ids, grads, torch.zeros(K, dtype=torch.bool, device=device))


def make_sparse_train_step(model: nn.Module, cfg: Config, noise: Optional[NoiseFn] = None,
                           mesh=None):
    """``step(state, batch, hist) -> (loss, logits)``: one training step on a
    batch dict (``unpack_batch``'s, tensors on the model's device), updating
    ``state`` and the AUC histogram ``hist`` in place. With
    ``embedding_update_period`` K > 1 the rows' update waits for
    ``step.flush(state)``, the combined update of every pending step (the
    identity when none is pending); with K = 1 ``flush`` does nothing.
    ``noise``: :func:`make_table_updater`. ``mesh``: the rank's
    :class:`~news_recsys_tpu_torch.parallel.mesh.Mesh` (``batch`` is then its
    slice, ``model`` its shards); the returned loss is the global batch's,
    the logits the slice's. K-step write-back buffers the gathered global
    slots, so its flush is one device's."""
    if not hasattr(model, "forward_from_fields"):
        raise NotImplementedError(f"{type(model).__name__} does not factor as "
                                  "forward_from_fields")
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    schema = model.schema
    large = _large_tables(model.tables)
    table_update = make_table_updater(cfg, model.tables, noise, mesh)
    unpooled = set(getattr(model, "unpooled_arrays", ()) or ())
    K = int(hp.embedding_update_period)
    lookup_mesh = sharded_tables(model, mesh)

    def sparse_train_step(state: SparseTrainState, batch, hist: AucHist):
        with span("train.step"):
            return _step(state, batch, hist)

    def _step(state: SparseTrainState, batch, hist: AucHist):
        tables = state.model.embedder.tables
        with span("train.step.gather"), torch.no_grad():
            rows = gather_large_rows(schema, batch, tables, large, lookup_mesh)
        with span("train.step.forward"):
            for r in rows.values():
                r.requires_grad_()
            labels = batch["label"][:, 0]
            weights = batch.get("_valid")
            if weights is None:
                weights = torch.ones_like(labels)
            logits = state.model.forward_from_fields(
                *fields_from_rows(schema, batch, rows, tables, large, unpooled, lookup_mesh))
            per_ex = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
            loss = (per_ex * weights).sum() / global_weight_sum(weights, mesh).clamp(min=1.0)
        opt = state.dense_opt
        with span("train.step.backward"):
            if opt is not None:
                opt.zero_grad(set_to_none=True)
            loss.backward()
            if opt is not None:
                (loss,) = sum_over_data(mesh, opt.param_groups[0]["params"], loss)
            elif mesh is not None and mesh.data > 1:
                loss = mesh.all_reduce_(loss.detach().clone(), "data")

        with torch.no_grad():
            with span("train.step.adamw"):
                # optax evaluates the schedule at the pre-increment step
                # count; the rowwise update uses the same lr
                lr = sched(state.step)
                if opt is not None:
                    for group in opt.param_groups:
                        group["lr"] = lr
                    opt.step()
            with span("train.step.rows"):
                per_table = gather_slots(
                    collect_per_table(schema, batch, {k: r.grad for k, r in rows.items()},
                                      large), mesh)
            with span("train.step.table_update"):
                if K == 1:
                    table_update(state, per_table, state.step, lr)
                else:
                    _buffer(state, per_table)
            with span("train.step.auc"):
                binned_auc_update(hist, torch.sigmoid(logits), labels, weights)
        state.step += 1
        return loss.detach(), logits.detach()

    def _buffer(state: SparseTrainState, per_table) -> None:
        """This step's (ids, grads) into slot ``step mod K`` of the buffers."""
        if state.pending is None:
            state.pending = _pending_rows(per_table, K)
        pend, slot = state.pending, state.step % K
        for t, pairs in per_table.items():
            pend.ids[t][slot].copy_(torch.cat([p[0] for p in pairs]))
            pend.grads[t][slot].copy_(torch.cat([p[1] for p in pairs]))
        pend.valid[slot] = True
        pend.count += 1

    def flush(state: SparseTrainState) -> None:
        """Apply the pending rows as one update (slot order, unfilled slots'
        ids to padding), with the lr at the current step and the apply
        counter as Adam's step and the noise's, then empty the buffers."""
        pend = state.pending
        if pend is None or pend.count == 0:
            return
        with span("train.flush"), torch.no_grad():
            per_table = {t: [(torch.where(pend.valid[:, None], ids, 0).reshape(-1),
                              pend.grads[t].reshape(-1, pend.grads[t].shape[-1]))]
                         for t, ids in pend.ids.items()}
            table_update(state, per_table, state.applies, sched(state.step))
            pend.valid.zero_()
        pend.count = 0
        state.applies += 1

    sparse_train_step.flush = flush
    return sparse_train_step
