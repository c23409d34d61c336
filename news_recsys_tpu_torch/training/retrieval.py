"""DSSM retrieval training and the batched retrieval evaluation (HR@k).

Port of :mod:`news_recsys_tpu.training.retrieval`: :class:`DSSMTrainer` is
a :class:`~.trainer.Trainer` whose step is the two-tower one, on the
all-dense AdamW step (:func:`make_dssm_train_step`, ``embedding_optimizer=
"adamw"``, what ``configs/dssm.yaml`` ships) or the rowwise step on
``rowwise_adagrad`` or ``sparse_adamw`` (:func:`make_dssm_sparse_train_step`,
JAX's ``make_dssm_sparse_chunk_fn``, which refuses K-step write-back), with a ``Retrieval:`` block in
``val_log.log`` after every epoch and weights-only ``epoch_<NNN>.pt``.

JAX keys each step's negatives by ``fold_in(key, state.step)``. The port
draws them on the host from ``SeedSequence([train_hparams.seed + 1, step])``
(:func:`~..models.dssm.draw_negative_permutations`) and uploads an epoch's
worth at once as the epoch's carry (:class:`NegativeDraws`): the permutations
differ from JAX's, but a step's depend on its global step alone, so a
resumed run reproduces them, and the card and the CPU train on the same ones.

Under a mesh (:class:`~.trainer.Trainer`'s) each rank trains its slice of
the global batch, and its negatives stay permutations of the global batch,
as JAX's GSPMD program draws them: the item tower's outputs are gathered
over the data axis with their gradient (:func:`~..parallel.mesh.
all_gather_with_grad`), the rank's users take their columns of the step's
permutations, and each rank's loss is its share of the global mean. Tables
sharded over the model axis are read through the id exchange and updated
shard-locally, as in the ranking steps.

The evaluation encodes the item corpus once, scores every query user with
one matmul + top-k sweep (:class:`~..ops.topk.TopKSearcher`) and removes
each row's history on the host (:func:`dedup_hit_rate`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.packed_dataset import PackedDataset
from ..models.dssm import (DSSM, _l2, draw_negative_permutations, dssm_loss_from_embeddings,
                           dssm_train_loss, item_log_q)
from ..ops.topk import TopKSearcher
from ..parallel.mesh import all_gather_with_grad
from ..utils.logging import get_logger
from .checkpoint import load_state, load_weights, save_weights
from .dense_step import check_dense
from .schedule import hold_cosine_floor
from .sparse_step import (_large_tables, check_sparse, collect_per_table, fields_from_rows,
                          gather_large_rows, gather_slots, make_table_updater, sharded_tables,
                          sum_over_data)
from .trainer import Trainer

logger = get_logger("retrieval")


@dataclass
class NegativeDraws:
    """An epoch's negative permutations: ``perms`` (steps, rate, B) int32 on
    the device, those of global steps ``first``, ``first + 1``, ..."""

    perms: torch.Tensor
    first: int

    def at(self, step: int) -> torch.Tensor:
        """The (rate, B) permutations of global step ``step``."""
        return self.perms[step - self.first]


def draw_negatives(seed: int, first: int, steps: int, B: int, rate: int,
                   device) -> NegativeDraws:
    """:func:`draw_negative_permutations` of steps ``first`` to ``first +
    steps - 1``, uploaded to ``device`` in one copy."""
    perms = np.zeros((steps, rate, B), np.int32)
    for i in range(steps):
        perms[i] = draw_negative_permutations(seed, first + i, B, rate)
    return NegativeDraws(torch.from_numpy(perms).to(device), first)


def global_negatives(mesh, batch, perms):
    """(the rank's columns of ``perms``, ``candidates(item_emb)`` giving the
    global batch's item embeddings and ids, the loss's share divisor) under
    a data axis; ``(perms, None, 1)`` without one."""
    if mesh is None or mesh.data == 1:
        return perms, None, 1
    ids = mesh.all_gather(batch["item_id"], "data")

    def candidates(item_emb):
        return all_gather_with_grad(item_emb, mesh, "data"), ids

    return perms[:, mesh.batch_slice(perms.shape[1])], candidates, mesh.data


def make_dssm_train_step(model: DSSM, cfg: Config, temperature: float,
                         loss_type: str = "infonce", margin: float = 1.0, logq_table=None,
                         mesh=None):
    """``step(state, batch, negatives) -> (loss, None)``: one all-dense AdamW
    step (:mod:`.dense_step`'s state and optimizer) of the DSSM loss on a
    batch dict, with the permutations ``negatives.at(state.step)``. The
    towers run whole, so ``hist`` goes through the fused lookup + pool and
    its backward kernel; the lr is the schedule at the pre-increment step.
    ``mesh``: the rank's mesh (``batch`` its slice); the loss is the global
    batch's."""
    check_dense(cfg)
    sharded_tables(model, mesh)
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)

    def step(state, batch, negatives: NegativeDraws):
        perms, candidates, share = global_negatives(mesh, batch, negatives.at(state.step))
        loss = dssm_train_loss(state.model, perms, batch, temperature, loss_type, margin,
                               logq_table=logq_table, candidates=candidates) / share
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        (loss,) = sum_over_data(mesh, state.opt.param_groups[0]["params"], loss)
        for group in state.opt.param_groups:
            group["lr"] = sched(state.step)
        with torch.no_grad():
            state.opt.step()
        state.step += 1
        return loss.detach(), None

    return step


def make_dssm_sparse_train_step(model: DSSM, cfg: Config, temperature: float,
                                loss_type: str = "infonce", margin: float = 1.0,
                                logq_table=None, mesh=None):
    """``step(state, batch, negatives) -> (loss, None)`` with the rowwise
    optimizer (``rowwise_adagrad`` or ``sparse_adamw``) on the large tables
    (:mod:`.sparse_step`'s state and updater): the loss is differentiated
    with respect to the gathered user and item table rows (no (V, D)
    gradient exists), AdamW steps the towers and the small tables, and the
    touched rows are written back through the row scatter kernel. K-step
    write-back raises ``NotImplementedError``, as in the JAX package.
    ``mesh``: as :func:`make_dssm_train_step`'s."""
    check_sparse(cfg)
    hp = cfg.train_hparams
    if hp.embedding_update_period > 1:
        raise NotImplementedError(
            "embedding_update_period > 1 (lazy write-back) is implemented for "
            "the ranking path only; DSSM retrieval training applies exact "
            "per-step updates.")
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    large = _large_tables(model.tables)
    table_update = make_table_updater(cfg, model.tables, mesh=mesh)
    lookup_mesh = sharded_tables(model, mesh)
    u_schema, i_schema = model.user_schema, model.item_schema
    # a feature in BOTH schemas has one rows entry whose gradient already
    # sums both towers' contributions: collect it once
    seen = {s.name for s in u_schema.specs}
    i_only = i_schema.subset([s.name for s in i_schema.specs if s.name not in seen])

    def step(state, batch, negatives: NegativeDraws):
        tables = state.model.embedder.tables
        with torch.no_grad():
            rows = {**gather_large_rows(u_schema, batch, tables, large, lookup_mesh),
                    **gather_large_rows(i_schema, batch, tables, large, lookup_mesh)}
        for r in rows.values():
            r.requires_grad_()
        u_fields, _ = fields_from_rows(u_schema, batch, rows, tables, large, mesh=lookup_mesh)
        i_fields, _ = fields_from_rows(i_schema, batch, rows, tables, large, mesh=lookup_mesh)
        user_emb, item_emb = state.model.towers_from_fields(u_fields, i_fields)
        perms, candidates, share = global_negatives(mesh, batch, negatives.at(state.step))
        loss = dssm_loss_from_embeddings(
            perms, user_emb, item_emb, batch, temperature, loss_type, margin,
            logq_table=logq_table, candidates=candidates) / share
        opt = state.dense_opt
        opt.zero_grad(set_to_none=True)
        loss.backward()
        (loss,) = sum_over_data(mesh, opt.param_groups[0]["params"], loss)
        lr = sched(state.step)
        with torch.no_grad():
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            grads = {k: r.grad for k, r in rows.items()}
            per_table = collect_per_table(u_schema, batch, grads, large)
            for t, pairs in collect_per_table(i_only, batch, grads, large).items():
                per_table.setdefault(t, []).extend(pairs)
            table_update(state, gather_slots(per_table, mesh), state.step, lr)
        state.step += 1
        return loss.detach(), None

    return step


def format_retrieval_block(results: Dict[str, float], epoch: int) -> str:
    """One ``Retrieval:`` section per epoch, as the JAX package writes it."""
    lines = [f"\n{'=' * 20} Epoch {epoch} Validation Results {'=' * 20}",
             "Retrieval:"]
    for key in sorted(results):
        if key == "num_queries":
            continue
        lines.append(f"  {key}:    {results[key]:.4f}")
    lines.append(f"  Queries:  {int(results.get('num_queries', 0))}")
    lines.append("=" * 60)
    return "\n".join(lines) + "\n"


class DSSMTrainer(Trainer):
    """The two-tower trainer: :class:`Trainer`'s epochs, step checkpoints and
    resume, with the DSSM step, a retrieval validation after every
    ``val_freq``-th epoch and weights-only epoch checkpoints.

    The loss's hyperparameters come from the config's ``dssm_cfg``:
    ``negative_sample_rate`` (3), ``temperature`` (0.1), ``loss`` (infonce |
    triplet), ``margin`` (1.0) and ``logq_correction`` (off), whose (V,)
    log-q table :meth:`prepare` (which :meth:`fit` calls) builds from the
    train split.
    """

    def __init__(self, cfg: Config, model: DSSM, workdir: Optional[str] = None,
                 device="cuda", profile_steps: int = 0, mesh=None):
        dcfg = cfg.extra("dssm_cfg", {}) or {}
        self.negative_sample_rate = int(dcfg.get("negative_sample_rate", 3))
        self._loss_args = (float(dcfg.get("temperature", 0.1)),
                           str(dcfg.get("loss", "infonce")), float(dcfg.get("margin", 1.0)))
        self._logq = bool(dcfg.get("logq_correction", False))
        self._logq_table: Optional[torch.Tensor] = None
        self._eval_data: Optional[Dict] = None
        super().__init__(cfg, model, workdir=workdir, device=device, profile_steps=profile_steps,
                         mesh=mesh)

    def _make_train_step(self):
        make = make_dssm_sparse_train_step if self.sparse_embeddings else make_dssm_train_step
        return make(self.model, self.cfg, *self._loss_args, logq_table=self._logq_table,
                    mesh=self.mesh)

    # -- epoch carry: the epoch's negative permutations -----------------------

    def _epoch_carry(self, epoch: int, first_step: int, steps: int) -> NegativeDraws:
        return draw_negatives(self.cfg.train_hparams.seed + 1, first_step, steps,
                              self.cfg.dataset.batch_size, self.negative_sample_rate,
                              self.device)

    def _carry_metrics(self, carry) -> Dict[str, float]:
        return {}

    def prepare(self, train_ds: PackedDataset) -> None:
        """With ``logq_correction``, the (V,) log-q table of ``train_ds``'s
        items, once, and the step that reads it."""
        if self._logq and self._logq_table is None:
            vocab = int(self.cfg.embeddings.embedding_table_size["item_id"])
            self._logq_table = torch.from_numpy(item_log_q(train_ds, vocab)).to(self.device)
            self.train_step = self._make_train_step()
            logger.info("logQ correction on: per-item sampling-bias table "
                        f"built from {len(train_ds)} train rows")

    # -- retrieval validation --------------------------------------------------

    def set_eval_data(self, item_ds: PackedDataset,
                      histories: Optional[Sequence[Sequence[int]]] = None,
                      k: int = 10) -> None:
        """The context :meth:`validate` needs: the item corpus to encode, each
        query row's click history (removed from its candidates), and ``k``."""
        self._eval_data = {"item_ds": item_ds, "histories": histories, "k": k}

    def validate(self, state, ds: PackedDataset, epoch: int,
                 warm_user_set=None) -> Dict[str, float]:
        """HR@k over ``ds`` (the positive dev rows) after :meth:`set_eval_data`:
        prints the ``Retrieval:`` block, appends it to ``val_log.log`` and
        logs ``val_hr_at_<k>`` and ``val_num_queries`` to ``metrics.jsonl``."""
        if state.model is not self.model:
            raise ValueError("validate: the state's model is not this trainer's")
        if self._eval_data is None:
            logger.warning("DSSMTrainer.validate called without set_eval_data; skipping")
            return {}
        ev = self._eval_data
        histories = ev["histories"]
        if histories is None:
            histories = [[] for _ in range(len(ds))]
        res = evaluate_retrieval(self, ev["item_ds"], ds, target_item_ids=ds.arrays["item_id"],
                                 histories=histories, k=ev["k"])
        block = format_retrieval_block(res, epoch)
        if self.is_main:
            print(block)
            with open(self.val_log_path, "a") as f:
                f.write(block)
        self._log_scalars(epoch=epoch, **{f"val_{k.lower().replace('@', '_at_')}": v
                                          for k, v in res.items()})
        return res

    # -- checkpoints -----------------------------------------------------------

    def save_checkpoint(self, state, epoch: int) -> str:
        """Weights-only ``<ckpt_dir>/epoch_<NNN>.pt`` (the reference keeps
        every epoch's weights alone). A full-state resume goes through the
        step checkpoints (``ckpt_every_steps``, ``fit(resume=True)``)."""
        return save_weights(os.path.join(self.ckpt_dir, f"epoch_{epoch:03d}.pt"), state.model,
                            self.mesh)

    def load_params(self, state, path: str):
        """Load a weights-only checkpoint file into ``state``'s model."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        load_weights(state.model, load_state(path), self.mesh)
        return state

    # -- encoding --------------------------------------------------------------

    def encode_item_corpus(self, item_ds: PackedDataset) -> np.ndarray:
        """(N, D) L2-normalised item tower outputs of ``item_ds``'s rows."""
        return _l2(self._map_rows(item_ds, self.model.item_embedding)).cpu().numpy()

    def encode_users(self, ds: PackedDataset) -> np.ndarray:
        """(N, D) L2-normalised user tower outputs of ``ds``'s rows."""
        return _l2(self._map_rows(ds, self.model.user_embedding)).cpu().numpy()


def dedup_hit_rate(retrieved_ids: np.ndarray, target_item_ids: np.ndarray,
                   histories: Sequence[Sequence[int]], k: int) -> float:
    """HR@k after removing each row's history from its retrieved list —
    fully vectorized (no per-row Python loop over queries).

    A retrieved item is *kept* if not in the row's history; the target hits
    if it appears among the first ``k`` kept items. Membership is tested via
    a per-row keyed ``np.isin`` (row*base+item composite keys).
    """
    q, fetch = retrieved_ids.shape
    lens = np.fromiter((len(h) for h in histories), np.int64, len(histories))
    if lens.sum() > 0:
        flat = np.concatenate([np.asarray(h, np.int64) for h in histories if len(h)])
        base = int(max(retrieved_ids.max(initial=0), flat.max(initial=0))) + 2
        row_of = np.repeat(np.arange(q, dtype=np.int64), lens)
        hist_keys = row_of * base + flat
        ret_keys = np.arange(q, dtype=np.int64)[:, None] * base + retrieved_ids
        banned = np.isin(ret_keys, hist_keys)
    else:
        banned = np.zeros((q, fetch), bool)
    kept_rank = np.cumsum(~banned, axis=1) - 1          # rank among kept items
    is_target = retrieved_ids == np.asarray(target_item_ids, np.int64)[:, None]
    hits = np.any(is_target & ~banned & (kept_rank < k), axis=1)
    return float(hits.mean()) if q else 0.0


def evaluate_retrieval(trainer: DSSMTrainer, item_ds: PackedDataset, query_ds: PackedDataset,
                       target_item_ids: np.ndarray, histories: Sequence[Sequence[int]],
                       k: int = 10) -> Dict[str, float]:
    """HitRate@k with user-history dedup, batched over all queries, of the
    trainer's model: ``query_ds`` rows are (positive) dev rows,
    ``target_item_ids`` the clicked item of each, ``histories`` each row's
    earlier clicks (removed from its candidates)."""
    corpus = trainer.encode_item_corpus(item_ds)
    corpus_item_ids = item_ds.arrays["item_id"].astype(np.int64)
    users = trainer.encode_users(query_ds)

    max_hist = max((len(h) for h in histories), default=0)
    searcher = TopKSearcher(device=trainer.device)     # the embeddings are normalised
    searcher.update_embedding(corpus)
    fetch = min(k + max_hist, corpus.shape[0])
    idx, _ = searcher.search(users, fetch)
    retrieved_ids = corpus_item_ids[idx]                # (Q, fetch)

    hr = dedup_hit_rate(retrieved_ids, np.asarray(target_item_ids, np.int64), histories, k)
    return {f"HR@{k}": hr, "num_queries": len(target_item_ids)}
