"""Sparse (rowwise) embedding training step for the rankers.

Port of :mod:`news_recsys_tpu.training.sparse_step`, the ``K == 1`` body
of its ``make_sparse_chunk_fn``, one step per call and eager:

1. the step gathers the touched rows of every LARGE table (vocab >=
   ``SMALL_VOCAB_THRESHOLD``) itself, one gather per feature, and
   differentiates the loss with respect to those gathered rows (detached
   copies that require grad), so no (V, D) gradient exists; the small
   tables, the cross stack and the MLP are differentiated directly;
2. AdamW (``torch.optim.AdamW``, optax's ``adamw`` formula) steps the dense
   parameters and the small tables;
3. the touched ids of all large tables are sorted and deduplicated in one
   joint id space (:func:`_joint_dedup`, the sorted layout: rows stay
   non-decreasing, every duplicate slot carries its row's summed gradient,
   invalid slots point at a spare row above the vocab with zero gradient);
4. rowwise AdaGrad writes the touched rows back through
   :func:`~news_recsys_tpu_torch.ops.scatter_rows.scatter_rows_set`.

Where JAX rebuilt arrays, the port updates in place under
``torch.no_grad()``: the tables, the accumulators, the optimizer state and
the AUC histogram. The gathered rows are copies, so writing a table after
``backward()`` is safe.

An unpooled array feature (the attention ranker's ``hist``) keeps its
gathered rows (B, L, D) as the field; their gradient flattens into the
table's B*L slots in :func:`collect_per_table`.

The port stays on the sorted route for every slot count. JAX's MXU dedup
(``_dedup_rows_matmul``, below ``MATMUL_DEDUP_MAX``) and its dense
full-table route (``dense_rowwise_adagrad_update``, from
``DENSE_UPDATE_MIN_SLOTS``) are TPU tuning; both give the same tables on
every addressable row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ARRAY, DENSE, SPARSE, Config

from ..models.embedding import SMALL_VOCAB_THRESHOLD, offset_ids, padded_vocab, take
from ..ops.scatter_rows import scatter_rows_set
from .schedule import hold_cosine_floor
from .trainer import AucHist, binned_auc_update

EPS_POOL = 1e-8
ADAGRAD_INIT_ACC = 0.1   # TF/TPUEmbedding default initial accumulator
ADAM_EPS = 1e-8
OOB_ROW = 2 ** 29        # the joint dedup's spare row: above every joint id
SENTINEL = 2 ** 30       # sort key of an invalid slot: after every real id
NOT_PORTED = "is not ported yet: see ROADMAP.md, queue 1, item 4 ('Optimizer variants')"


def _large_tables(tables_spec) -> set:
    return {t for t, (v, d) in dict(tables_spec).items() if v >= SMALL_VOCAB_THRESHOLD}


def check_ported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a training config the port does not
    run. It runs ``rowwise_adagrad`` (this module) and the all-dense
    ``adamw`` (:mod:`.dense_step`)."""
    hp = cfg.train_hparams
    if hp.embedding_optimizer not in ("rowwise_adagrad", "adamw"):
        raise NotImplementedError(f"embedding_optimizer={hp.embedding_optimizer!r} "
                                  + NOT_PORTED)
    if hp.embedding_update_period != 1:
        raise NotImplementedError(
            f"embedding_update_period={hp.embedding_update_period} (K-step lazy write-back) "
            + NOT_PORTED)
    if cfg.mesh.param_dtype != "float32" or cfg.mesh.compute_dtype != "float32":
        raise NotImplementedError("bfloat16 tables and towers " + NOT_PORTED)
    if cfg.mesh.model > 1:
        raise NotImplementedError(f"a model-parallel mesh (mesh.model={cfg.mesh.model}) "
                                  + NOT_PORTED)


def check_sparse(cfg: Config) -> None:
    """:func:`check_ported`, and the optimizer must be this module's."""
    check_ported(cfg)
    if cfg.train_hparams.embedding_optimizer != "rowwise_adagrad":
        raise ValueError("the sparse step runs embedding_optimizer='rowwise_adagrad'; "
                         f"{cfg.train_hparams.embedding_optimizer!r} trains on the all-dense "
                         "step (training/dense_step.py)")


@dataclass
class SparseTrainState:
    """The model (its parameters are the training state), one AdamW over the
    dense parameters and the small tables (None when there are none: an LR
    whose every table is large), the large tables' rowwise AdaGrad
    accumulators {table: (V,)}, and the number of steps taken."""

    model: nn.Module
    dense_opt: Optional[torch.optim.AdamW]
    emb_acc: Dict[str, torch.Tensor]
    step: int = 0


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
    tables stop requiring grad: the step differentiates their gathered rows."""
    check_sparse(cfg)
    tables = model.embedder.tables
    emb_acc = {}
    for name in sorted(_large_tables(model.tables)):
        tables[name].requires_grad_(False)
        emb_acc[name] = torch.full((tables[name].shape[0],), ADAGRAD_INIT_ACC,
                                   device=tables[name].device)
    return SparseTrainState(model, make_dense_tx(cfg, [p for _, p in dense_parameters(model)]),
                            emb_acc)


def gather_large_rows(schema, batch, tables, large) -> Dict[str, torch.Tensor]:
    """Per-feature gathered LARGE-table rows, one gather per feature (even
    for features sharing a table); ids outside a table read NaN."""
    return {spec.name: take(tables[spec.table], offset_ids(spec, batch[spec.name]))
            for spec in schema.specs if spec.kind in (SPARSE, ARRAY) and spec.table in large}


def fields_from_rows(schema, batch, rows, tables, large, unpooled=()) -> tuple:
    """(fields, masks): the per-field embeddings in schema order, as
    ``embed_fields`` builds them, from the gathered large-table ``rows`` and
    the small ``tables``. Array features are masked-mean pooled here, except
    those in ``unpooled``, which stay (B, L, D) and whose float masks are
    returned by name."""
    fields, masks = [], {}
    for spec in schema.specs:
        if spec.kind == DENSE:
            fields.append(batch[spec.name].to(torch.float32)[:, None])
            continue
        ids = offset_ids(spec, batch[spec.name])
        r = rows[spec.name] if spec.table in large else take(tables[spec.table], ids)
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
    """Group flat (ids, row-grads) pairs by large table, in schema order."""
    per_table: Dict[str, list] = {}
    for spec in schema.specs:
        if spec.kind not in (SPARSE, ARRAY) or spec.table not in large:
            continue
        g = row_grads[spec.name]
        per_table.setdefault(spec.table, []).append(
            (offset_ids(spec, batch[spec.name]).reshape(-1), g.reshape(-1, g.shape[-1])))
    return per_table


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
    valid = ids > 0
    if max_id is not None:
        valid &= ids <= max_id
    sids, order = torch.sort(torch.where(valid, ids, SENTINEL), stable=True)
    sg = grads[order]
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0) - 1
    gsum = torch.zeros_like(sg).index_add_(0, seg, sg)
    valid_slot = (sids < SENTINEL)
    rows = torch.where(valid_slot, sids, spare_row).to(torch.int32)
    return rows, torch.where(valid_slot[:, None], gsum[seg], 0.0)


def _joint_dedup(per_table, table_vocab, spare) -> Dict[str, tuple]:
    """Sort-dedup the touched ids of all large tables in one joint sort;
    returns {table: (rows, grads)} ready to scatter.

    One table dedups alone with ``max_id = vocab - 1``. Several tables
    share one id space: each table's ids shift into a disjoint range, grads
    zero-pad to the widest dim, and after the dedup each table takes back
    its own slots; the other tables' slots clip into ``[0, spare]`` (keeping
    the rows sorted) with zero gradient.

    Unlike the JAX package, an id at or past its own table's vocab is
    dropped before the shift: there, an id above ``vocab`` lands in the next
    table's range and updates that table's row with this table's gradient.
    """
    names = sorted(per_table)
    flat = {t: (torch.cat([p[0] for p in per_table[t]]), torch.cat([p[1] for p in per_table[t]]))
            for t in names}
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
        out[t] = (local.clamp(0, spare[t]).to(torch.int32),
                  torch.where(mine[:, None], grads_j[:, :d], 0.0))
    return out


def rowwise_adagrad_update(table, acc, rows, grads, lr, eps=1e-10):
    """Rowwise AdaGrad on the given rows, in place (TPUEmbedding/torchrec
    semantics): one scalar accumulator per row, ``acc += mean(g^2)``,
    ``p -= lr * g / (sqrt(acc) + eps)``. The table write goes through the
    row scatter kernel; the (V,) accumulator write is a plain ``index_put_``.
    ``rows`` must be sorted, as :func:`_dedup_rows` gives them."""
    idx = rows.long()
    acc_rows = acc[idx] + (grads * grads).mean(dim=-1)
    p_new = table[idx] - lr * grads / (acc_rows.sqrt() + eps)[:, None]
    scatter_rows_set(table, rows, p_new)
    acc[idx] = acc_rows
    return table, acc


def make_table_updater(cfg: Config, tables_spec):
    """``update(tables, emb_acc, per_table, lr)``: rowwise AdaGrad on the
    touched rows of the large tables, in place; ``per_table`` maps a table
    to the (flat ids, flat row-grads) pairs of the features sharing it."""
    check_sparse(cfg)
    table_vocab = dict(tables_spec)
    spare = {t: padded_vocab(v) - 1 for t, (v, d) in table_vocab.items()}

    def update(tables, emb_acc, per_table, lr: float) -> None:
        for t, (rows, grads) in sorted(_joint_dedup(per_table, table_vocab, spare).items()):
            rowwise_adagrad_update(tables[t], emb_acc[t], rows, grads, lr)

    return update


def make_sparse_train_step(model: nn.Module, cfg: Config):
    """``step(state, batch, hist) -> (loss, logits)``: one training step on a
    batch dict (``unpack_batch``'s, tensors on the model's device), updating
    ``state`` and the AUC histogram ``hist`` in place."""
    if not hasattr(model, "forward_from_fields"):
        raise NotImplementedError(f"{type(model).__name__} does not factor as "
                                  "forward_from_fields")
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    schema = model.schema
    large = _large_tables(model.tables)
    table_update = make_table_updater(cfg, model.tables)
    unpooled = set(getattr(model, "unpooled_arrays", ()) or ())

    def sparse_train_step(state: SparseTrainState, batch, hist: AucHist):
        tables = state.model.embedder.tables
        with torch.no_grad():
            rows = gather_large_rows(schema, batch, tables, large)
        for r in rows.values():
            r.requires_grad_()
        labels = batch["label"][:, 0]
        weights = batch.get("_valid")
        if weights is None:
            weights = torch.ones_like(labels)
        logits = state.model.forward_from_fields(
            *fields_from_rows(schema, batch, rows, tables, large, unpooled))
        per_ex = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
        loss = (per_ex * weights).sum() / weights.sum().clamp(min=1.0)
        opt = state.dense_opt
        if opt is not None:
            opt.zero_grad(set_to_none=True)
        loss.backward()

        # optax evaluates the schedule at the pre-increment step count; the
        # rowwise update uses the same lr
        lr = sched(state.step)
        with torch.no_grad():
            if opt is not None:
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
            per_table = collect_per_table(schema, batch, {k: r.grad for k, r in rows.items()},
                                          large)
            table_update(tables, state.emb_acc, per_table, lr)
            binned_auc_update(hist, torch.sigmoid(logits), labels, weights)
        state.step += 1
        return loss.detach(), logits.detach()

    return sparse_train_step
