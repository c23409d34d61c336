"""Training runtime for the rankers: the epoch loop (its carry the binned
train AUC of :mod:`.metrics_device`), prediction, validation, checkpoints
and resume (NRMS too, on the all-dense step with its listwise loss: a
training row carries 1 + K candidates and the AUC takes each; ``predict``
and ``validate`` score one a row).

Port of :mod:`news_recsys_tpu.training.trainer`, on the sparse step path
(``embedding_optimizer`` ``"rowwise_adagrad"`` or ``"sparse_adamw"``, with
K-step write-back where ``embedding_update_period`` > 1; :mod:`.sparse_step`) or the
all-dense one (``"adamw"``, :mod:`.dense_step`), chosen as the JAX trainer
chooses by :attr:`Trainer.sparse_embeddings`. A packed dataset that fits
``train_hparams.device_resident_bytes`` goes to the device once, and each
step gathers its batch rows there; a larger one is slab-streamed: each chunk
of steps gathers its ``c * batch_size`` rows on the host and uploads them in
one copy, ``c`` capped so that a slab stays within the same budget. Both
paths give a step the same batch, so they train to the same bits. Steps run
eagerly, one Python call each (JAX scanned them in one compiled chunk; the
port cuts an epoch into the same chunks, where K-step write-back flushes).
Validation scores the dev set on the device and computes its metric block
with the device engine (:mod:`.metrics_device`) from
``device_metrics_min_rows`` rows, else with the host engine
(:mod:`.metrics`). ``profile_steps > 0`` traces epoch 0 with
``torch.profiler`` into ``<log_dir>/profile``. The experiment dir keeps the
JAX package's layout and formats: ``train.log``, ``val_log.log``,
``metrics.jsonl`` beside a TensorBoard events file, ``model_info.log``, and
``ckpts/`` with a checkpoint after every epoch (``epoch_<NNN>.pt``) and,
every ``ckpt_every_steps`` steps, step checkpoints under ``ckpts/steps/``
(:mod:`.checkpoint`), from which ``fit(resume=True)`` continues the same
data order.

Over several processes (``torch.distributed`` started,
:mod:`news_recsys_tpu_torch.parallel`) the trainer builds its
:class:`~news_recsys_tpu_torch.parallel.mesh.Mesh` from ``cfg.mesh`` (or
takes one): it cuts the model's tables to the rank's rows where the model
axis shards them, every rank holds the whole packed dataset and draws the
same permutation, and each step runs the rank's slice of the global batch
(``batch_size`` must divide over the data axis). Only process 0 writes
``val_log.log``, ``train.log``, ``metrics.jsonl``, ``model_info.log`` and
the checkpoints; the timestamped experiment dir is agreed by broadcast.
``predict`` and ``validate`` gather the scores to every process, the train
AUC sums its histogram over the data axis, and a checkpoint is written from
the gathered state in one process's format, read by every rank and cut to
its shards, so a run resumes under any layout.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config
from ..convert import flax_arrays
from ..data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from ..parallel.distributed import broadcast_str, process_count, process_index
from ..parallel.mesh import mesh_from_config
from ..parallel.sharded_embedding import shard_parameters
from ..utils.logging import get_logger
from ..utils.profiling import span, trace
from ..utils.tensorboard import SummaryWriter
from .checkpoint import CheckpointManager, load_state, load_state_dict, save_state
from .dense_step import init_dense_state, make_train_step
from .metrics import compute_user_metrics, format_validation_block
# AUC_BINS and AucHist also for the callers that import them from the trainer
from .metrics_device import AUC_BINS, AucHist, binned_auc_value, compute_user_metrics_device
from .sparse_step import init_sparse_state, make_sparse_train_step

__all__ = ["AUC_BINS", "AucHist", "BatchPacker", "PackedDataset", "Trainer", "unpack_batch"]

logger = get_logger("trainer")

class Trainer:
    """Epoch-driven trainer with the JAX package's experiment-dir logs.

    ``model`` brings its parameters (seeded by ``build_ranker``, or converted
    from the JAX package by :mod:`news_recsys_tpu_torch.convert`) and moves
    to ``device``: the card, unless the caller names another; with no card
    the move raises. ``profile_steps > 0`` traces epoch 0 (all of it: JAX's
    trainer reads the count only as a flag, and the port follows it; over
    several processes, process 0's). ``mesh``: the rank's mesh; by default
    ``cfg.mesh``'s over the process group where it has more than one
    process.
    """

    def __init__(self, cfg: Config, model, workdir: Optional[str] = None, device="cuda",
                 profile_steps: int = 0, mesh=None):
        self.cfg = cfg
        self.profile_steps = profile_steps
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else (
            mesh_from_config(cfg) if process_count() > 1 else None)
        self.is_main = process_index() == 0
        self.model = model.to(self.device)
        self._full_shapes = {n: tuple(t.shape) for n, t in self.model.state_dict().items()}
        shard_parameters(self.model, self.mesh)
        self.train_step = self._make_train_step()
        ts = time.strftime("%Y%m%d-%H%M%S")
        if workdir is None and process_count() > 1:
            ts = broadcast_str(ts)
        self.log_dir = workdir or os.path.join("experiments", f"{cfg.name}_{ts}")
        self.ckpt_dir = os.path.join(self.log_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.val_log_path = os.path.join(self.log_dir, "val_log.log")
        self.train_log_path = os.path.join(self.log_dir, "train.log")
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        if self.is_main:
            open(self.val_log_path, "a").close()
        self.global_step = 0
        self._packed: Dict[int, tuple] = {}
        self._ckpt_mgr = None
        self._last_step_ckpt = 0       # where the ckpt_every_steps cadence counts from
        self._tb = None

    def _make_train_step(self):
        """``step(state, batch, carry) -> (loss, aux)``: the ranker's sparse
        or all-dense step, its carry the epoch's AUC histogram."""
        return (make_sparse_train_step if self.sparse_embeddings
                else make_train_step)(self.model, self.cfg, mesh=self.mesh)

    @property
    def sparse_embeddings(self) -> bool:
        return self.cfg.train_hparams.embedding_optimizer in ("sparse_adamw", "rowwise_adagrad")

    def init_state(self):
        init = init_sparse_state if self.sparse_embeddings else init_dense_state
        state = init(self.model, self.cfg)
        self._write_model_info()
        return state

    def _write_model_info(self) -> None:
        """The parameter table of ``model_info.log`` as the JAX package writes
        it: one line a leaf of its parameter tree, under the flax paths and
        shapes that :mod:`..convert` maps the parameters to, in the tree's
        (sorted) order, a sharded table under its whole shape. Process 0
        writes it. A model the JAX package lacks (``flax_paths`` False: NRMS)
        lists its parameters under the port's names, dots as slashes."""
        if not self.is_main:
            return
        named = {n: np.broadcast_to(np.float32(0), shape)
                 for n, shape in self._full_shapes.items()}
        if getattr(self.model, "flax_paths", True):
            flat = flax_arrays(named)
        else:
            params = {n for n, _ in self.model.named_parameters()}
            flat = {n.replace(".", "/"): v for n, v in named.items() if n in params}
        lines = ["  | Name | Shape | Params"]
        total = 0
        for path in sorted(flat, key=lambda p: tuple(p.split("/"))):
            n = int(np.prod(flat[path].shape))
            total += n
            lines.append(f"  | params/{path} | {tuple(flat[path].shape)} | {n:,}")
        lines.append(f"  Total params: {total:,}")
        with open(os.path.join(self.log_dir, "model_info.log"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _packer(self, ds: PackedDataset):
        """(packer, device matrices) of ``ds``, made once per dataset; the
        matrices are the packed dataset uploaded to the device, or None where
        it is larger than ``device_resident_bytes`` (the slab path)."""
        if id(ds) not in self._packed:
            packer = BatchPacker(ds)
            mats = ((torch.from_numpy(packer.int_mat).to(self.device),
                     torch.from_numpy(packer.float_mat).to(self.device))
                    if self._use_device_resident(packer) else None)
            self._packed[id(ds)] = (ds, packer, mats)
        return self._packed[id(ds)][1:]

    def _use_device_resident(self, packer: BatchPacker) -> bool:
        return (packer.int_mat.nbytes + packer.float_mat.nbytes
                <= self.cfg.train_hparams.device_resident_bytes)

    def _slab_chunk_cap(self, packer: BatchPacker, bs: int) -> int:
        """The most steps a slab may hold, so that its ``c * bs`` rows stay
        within the ``device_resident_bytes`` budget that forced the slab path."""
        row_bytes = (packer.int_mat.nbytes + packer.float_mat.nbytes) / max(packer.n, 1)
        return max(1, int(self.cfg.train_hparams.device_resident_bytes
                          // max(1.0, row_bytes * bs)))

    def upload_slab(self, packer: BatchPacker, rows: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """``rows`` of the packed matrices, gathered on the host and uploaded
        to the device in one copy each."""
        return (torch.from_numpy(packer.int_mat[rows]).to(self.device),
                torch.from_numpy(packer.float_mat[rows]).to(self.device))

    def _chunks(self, packer: BatchPacker, mats, rows: np.ndarray, bs: int,
                next_len: Callable[[int, int], int]) -> Iterator[tuple]:
        """The batches of ``rows`` (dataset rows, ``bs`` a batch, in order)
        by chunk: ``(c, int source, float source, (c, bs) indices into the
        sources)``, ``c = next_len(batches, position)`` asked as each chunk
        starts. Device-resident, the sources are the uploaded matrices and
        the indices the rows, uploaded once; slab-streamed, a chunk's rows
        are gathered on the host and uploaded, and indexed in order."""
        nb = len(rows) // bs
        idx = torch.from_numpy(rows.reshape(nb, bs)).to(self.device) if mats is not None else None
        pos = 0
        while pos < nb:
            c = next_len(nb, pos)
            if mats is not None:
                yield (c, *mats, idx[pos:pos + c])
            else:
                with span("train.epoch.upload"):
                    slab = self.upload_slab(packer, rows[pos * bs:(pos + c) * bs])
                yield (c, *slab, torch.arange(c * bs, device=self.device).view(c, bs))
            pos += c

    # Epoch-loop carry hooks, as the JAX trainer's: every step of an epoch
    # gets the carry; the ranking trainer carries the binned AUC histogram,
    # the DSSM trainer the epoch's negative permutations. ``first_step`` (the
    # state's step) and ``steps`` (the epoch's step count) are the port's
    # addition: the DSSM carry draws them all and uploads them at once.
    def _epoch_carry(self, epoch: int, first_step: int, steps: int):
        return AucHist.zeros(self.device)

    def _carry_metrics(self, carry) -> Dict[str, float]:
        if self.mesh is not None and self.mesh.data > 1:       # the global batch's histogram
            carry = AucHist(*(self.mesh.all_reduce_(h.clone(), "data")
                              for h in (carry.pos, carry.neg)))
        return {"train_auc": binned_auc_value(carry)}

    def train_epoch(self, state, ds: PackedDataset, epoch: int, skip_steps: int = 0):
        """One epoch in the permutation the JAX trainer draws; returns
        (state, metrics). ``skip_steps`` leaves out the first batches of that
        permutation (steps trained before a restart), as the JAX trainer's
        does."""
        profiling = (trace(os.path.join(self.log_dir, "profile"))
                     if self.profile_steps > 0 and epoch == 0 and self.is_main
                     else contextlib.nullcontext())
        with profiling, span("train.epoch"):
            return self._train_epoch(state, ds, epoch, skip_steps)

    def _train_epoch(self, state, ds: PackedDataset, epoch: int, skip_steps: int):
        hp = self.cfg.train_hparams
        bs = self.cfg.dataset.batch_size
        packer, mats = self._packer(ds)
        layout = packer.layout_key()
        with span("train.epoch.plan"):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.cfg.dataset.shuffle_seed, epoch]))
            order = rng.permutation(packer.n)
            nb_full = packer.n // bs
            start = min(skip_steps, nb_full)
            nb = max(0, min(nb_full - start, hp.max_step - self.global_step))
            cap = None if mats is not None else self._slab_chunk_cap(packer, bs)
            rows, bl = self._rank_rows(order[start * bs:(start + nb) * bs], bs)
            ones = torch.ones(bl, device=self.device)
            carry = self._epoch_carry(epoch, state.step, nb)
        K = hp.embedding_update_period if self.sparse_embeddings else 1
        t0 = time.perf_counter()
        loss = None
        for c, int_src, float_src, idx in self._chunks(
                packer, mats, rows, bl, lambda nb, pos: self._chunk_len(nb, pos, cap)):
            for j in range(c):
                with span("train.batch"):
                    batch = unpack_batch(int_src[idx[j]], float_src[idx[j]], ones, layout)
                loss, _ = self.train_step(state, batch, carry)
                if K > 1 and (j + 1) % K == 0:
                    self.train_step.flush(state)
            if K > 1:
                self.train_step.flush(state)           # the chunk's tail
            self.global_step += c
            self._maybe_step_checkpoint(state)
        with span("train.epoch.sync"):
            loss_val = float(loss) if loss is not None else float("nan")   # waits for the device
        dt = time.perf_counter() - t0
        with span("train.epoch.metrics"):
            metrics = {"train_loss": loss_val, **self._carry_metrics(carry),
                       "examples_per_sec": nb * bs / max(dt, 1e-9), "steps": nb}
            self._log_scalars(epoch=epoch, **metrics)
            if self.is_main:
                with open(self.train_log_path, "a") as f:
                    f.write(f"Epoch {epoch} Training Metrics:\n")
                    for k, v in metrics.items():
                        f.write(f"  {k}: {v:.4f}\n")
                    f.write("-" * 20 + "\n")
            extra = f" auc~{metrics['train_auc']:.4f}" if "train_auc" in metrics else ""
            logger.info(f"epoch {epoch}: steps={nb} loss={loss_val:.4f}{extra} "
                        f"ex/s={metrics['examples_per_sec']:.0f}")
        return state, metrics

    def _rank_rows(self, rows: np.ndarray, bs: int) -> Tuple[np.ndarray, int]:
        """(this rank's rows of the batches of ``rows``, in order, and its
        batch size): each batch of ``bs`` cut to the rank's slice of the data
        axis; without a mesh ``rows`` and ``bs`` themselves."""
        if self.mesh is None or self.mesh.data == 1:
            return rows, bs
        sl = self.mesh.batch_slice(bs)
        return rows.reshape(-1, bs)[:, sl].reshape(-1), sl.stop - sl.start

    def _chunk_len(self, nb: int, pos: int, cap: Optional[int] = None) -> int:
        """The next chunk's step count, as the JAX trainer's dispatches:
        ``chunk_steps`` (capped at ``cap``, the slab path's budget), cut at
        the epoch's end and at the next ``ckpt_every_steps`` boundary. Steps
        run one call each either way; K-step write-back flushes at every
        chunk's end, where the JAX package's scanned chunk flushes, so
        nothing is pending at a checkpoint."""
        c = min(cap or self.cfg.train_hparams.chunk_steps, self.cfg.train_hparams.chunk_steps,
                nb - pos)
        every = self.cfg.train_hparams.ckpt_every_steps
        if every > 0:
            c = min(c, max(every - (self.global_step - self._last_step_ckpt), 1))
        return c

    def _log_scalars(self, **scalars) -> None:
        """One line of ``metrics.jsonl``, and the finite numbers among
        ``scalars`` in the TensorBoard events file beside it (process 0)."""
        if not self.is_main:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({"step": self.global_step, **scalars}) + "\n")
        if self._tb is None:
            self._tb = SummaryWriter(self.log_dir)
        for key, val in scalars.items():
            if isinstance(val, (int, float)) and val == val:
                self._tb.add_scalar(key, float(val), self.global_step)
        self._tb.flush()

    def predict(self, ds: PackedDataset, batch_size: Optional[int] = None) -> np.ndarray:
        """Sigmoid scores (float32) of every row of ``ds`` in row order, at
        ``eval_batch_size`` (else ``batch_size``) rows a forward; the tail
        batch is padded with the last row and trimmed, as in JAX."""
        return self._map_rows(ds, lambda batch: torch.sigmoid(self.model(batch)),
                              batch_size).cpu().numpy()

    def _map_rows(self, ds: PackedDataset, fn, batch_size: Optional[int] = None) -> torch.Tensor:
        """``fn(batch)`` over every row of ``ds`` in row order, on the device,
        at ``eval_batch_size`` (else ``batch_size``) rows a call; the tail
        batch is padded with the last row and trimmed, as in JAX. A dataset
        above ``device_resident_bytes`` streams in slabs of at most
        ``chunk_steps`` batches. Under a mesh each rank maps its slice of
        every batch and the results are gathered over the data axis."""
        bs = batch_size or self.cfg.dataset.eval_batch_size or self.cfg.dataset.batch_size
        packer, mats = self._packer(ds)
        layout = packer.layout_key()
        nb = -(-packer.n // bs)
        rows, bl = self._rank_rows(np.minimum(np.arange(nb * bs), packer.n - 1), bs)
        cap = nb if mats is not None else min(self.cfg.train_hparams.chunk_steps,
                                              self._slab_chunk_cap(packer, bs))
        ones = torch.ones(bl, device=self.device)
        out = []
        with torch.inference_mode():
            for c, int_src, float_src, idx in self._chunks(packer, mats, rows, bl,
                                                           lambda nb, pos: min(cap, nb - pos)):
                out += [fn(unpack_batch(int_src[i], float_src[i], ones, layout)) for i in idx]
            out = torch.cat(out)
            if bl != bs:            # (data, nb, bl, ...) -> batch order
                out = self.mesh.all_gather(out, "data")
                out = out.view(self.mesh.data, nb, bl, *out.shape[1:]).transpose(0, 1)
                out = out.reshape(nb * bs, *out.shape[3:])
        return out[: packer.n]

    def validate(self, state, ds: PackedDataset, epoch: int,
                 warm_user_set: Optional[Set[int]] = None) -> Dict[str, Dict[str, float]]:
        """Score ``ds`` with ``state``'s model and compute the Overall /
        Warm-start / Cold-start block, on the device from
        ``device_metrics_min_rows`` rows (pooled AUC and LogLoss on the host
        either way), else on the host; prints it, appends it to
        ``val_log.log`` and logs AUC, GAUC and NDCG@10 to ``metrics.jsonl``
        (process 0; every process gets the results)."""
        if state.model is not self.model:
            raise ValueError("validate: the state's model is not this trainer's")
        scores = self.predict(ds)
        uids, labels = ds.arrays["user_id"], ds.arrays["label"][:, 0]
        if len(ds) >= self.cfg.train_hparams.device_metrics_min_rows:
            results = compute_user_metrics_device(uids, scores, labels, warm_user_set,
                                                  device=self.device)
        else:
            results = compute_user_metrics(uids, scores, labels, warm_user_set)
        block = format_validation_block(results, epoch)
        if self.is_main:
            print(block)
            with open(self.val_log_path, "a") as f:
                f.write(block)
        self._log_scalars(epoch=epoch, val_auc=results["Overall"]["AUC"],
                          val_gauc=results["Overall"]["GAUC"],
                          val_ndcg10=results["Overall"]["NDCG@10"])
        return results

    # -- checkpoints -----------------------------------------------------------

    def checkpoint_manager(self):
        """The manager of the step checkpoints under ``<ckpt_dir>/steps``."""
        if self._ckpt_mgr is None:
            self._ckpt_mgr = CheckpointManager(os.path.join(self.ckpt_dir, "steps"), self.mesh)
        return self._ckpt_mgr

    def _maybe_step_checkpoint(self, state) -> None:
        """A step checkpoint every ``train_hparams.ckpt_every_steps`` steps,
        on multiples of the cadence counted from step 0. With ``fit(resume=
        True)`` this gives mid-epoch resume; the step count in the state
        keeps the lr schedule exact across restarts."""
        every = self.cfg.train_hparams.ckpt_every_steps
        if every > 0 and self.global_step - self._last_step_ckpt >= every:
            self.save_step_checkpoint(state, self.global_step)
            self._last_step_ckpt = self.global_step

    def save_step_checkpoint(self, state, step: int) -> None:
        """The port's ``save_checkpoint_sharded``: ``state`` as the step
        checkpoint ``step``, gathered from the shards and written by process
        0 in one process's format."""
        self.checkpoint_manager().save(step, state)

    def restore_latest(self, state):
        """Load the newest step checkpoint into ``state``; returns (state,
        whether one was restored). Works for dense and sparse states."""
        mgr = self.checkpoint_manager()
        if mgr.latest_step() is None:
            return state, False
        state = mgr.restore(state)
        self.global_step = state.step
        self._reset_step_ckpt_origin()
        logger.info(f"Restored checkpoint at step {self.global_step}")
        return state, True

    def _reset_step_ckpt_origin(self) -> None:
        """Re-anchor the step checkpoint cadence after a restore: later
        checkpoints land on ``ckpt_every_steps`` multiples counted from 0,
        not ``ckpt_every_steps`` steps after the restored one."""
        every = self.cfg.train_hparams.ckpt_every_steps
        self._last_step_ckpt = ((self.global_step // every) * every
                                if every > 0 else self.global_step)

    def save_checkpoint(self, state, epoch: int) -> str:
        """``state`` as ``<ckpt_dir>/epoch_<NNN>.pt`` (gathered, written by
        process 0); returns the path."""
        return save_state(os.path.join(self.ckpt_dir, f"epoch_{epoch:03d}.pt"), state, self.mesh)

    def load_checkpoint(self, state, path: str):
        """Strict restore of a checkpoint file into ``state`` (the reference's
        ``load_model``, ``base_model.py:531-536``); the trainer's step
        follows the checkpoint's."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        state = load_state_dict(state, load_state(path), self.mesh)
        self.global_step = state.step
        self._reset_step_ckpt_origin()
        return state

    # -- fit -------------------------------------------------------------------

    def prepare(self, train_ds: PackedDataset) -> None:
        """What :meth:`fit` sets up from the train split before its first
        epoch, for a caller that drives :attr:`train_step` itself: nothing
        for a ranker."""

    def fit(self, train_ds: PackedDataset, dev_ds: Optional[PackedDataset] = None,
            warm_user_set: Optional[Set[int]] = None, state=None,
            max_epochs: Optional[int] = None, resume: bool = False):
        """Train ``state`` (default: :meth:`init_state`, the model's current
        parameters) for ``max_epochs`` (default ``train_hparams.max_epoch``)
        or until ``max_step``, validating on ``dev_ds`` after every
        ``val_freq``-th epoch and writing a checkpoint after every epoch. The
        reference's arguments, in its order. ``resume`` loads the newest step
        checkpoint into the state and continues where it stopped: the step
        count maps back to (epoch, batches into it) of the same data order,
        so no row is trained twice or left out, and a run already at
        ``max_step`` trains nothing."""
        if state is None:
            state = self.init_state()
        elif state.model is not self.model:
            raise ValueError("fit: the state's model is not this trainer's")
        self.prepare(train_ds)
        hp = self.cfg.train_hparams
        max_epochs = hp.max_epoch if max_epochs is None else max_epochs
        start_epoch, skip = 0, 0
        if resume:
            state, restored = self.restore_latest(state)
            if restored:
                # Every epoch before the current one trained all its batches
                # (train_epoch's max_step cap can only cut a session's last
                # epoch, and fit stops there), so the divmod is exact even
                # across sessions cut by max_step.
                steps_per_epoch = max(1, len(train_ds) // self.cfg.dataset.batch_size)
                start_epoch, skip = divmod(self.global_step, steps_per_epoch)
                logger.info(f"Resuming at step {self.global_step} "
                            f"(epoch {start_epoch}, offset {skip} batches)")
        for epoch in range(start_epoch, max_epochs):
            if self.global_step >= hp.max_step:
                # e.g. restored at max_step: a 0-step epoch would validate and
                # checkpoint the same state again under the next epoch number
                logger.info(f"Already at max_step={hp.max_step}; nothing to train.")
                break
            state, _ = self.train_epoch(state, train_ds, epoch,
                                        skip_steps=skip if epoch == start_epoch else 0)
            if dev_ds is not None and (epoch + 1) % hp.val_freq == 0:
                self.validate(state, dev_ds, epoch, warm_user_set)
            self.save_checkpoint(state, epoch)
            if self.global_step >= hp.max_step:
                logger.info(f"Reached max_step={hp.max_step}; stopping.")
                break
        return state
