"""Training runtime for the rankers: the binned train AUC, the epoch loop,
prediction, validation, checkpoints and resume.

Port of :mod:`news_recsys_tpu.training.trainer`, on the sparse step path
(``embedding_optimizer`` ``"rowwise_adagrad"`` or ``"sparse_adamw"``, with
K-step write-back where ``embedding_update_period`` > 1; :mod:`.sparse_step`) or the
all-dense one (``"adamw"``, :mod:`.dense_step`), chosen as the JAX trainer
chooses by :attr:`Trainer.sparse_embeddings`, and its device-resident epoch:
the packed dataset goes to the device once, and each step gathers its batch
rows there. Steps run eagerly, one Python call each (JAX scanned them in
one compiled chunk; the port cuts an epoch into the same chunks, where
K-step write-back flushes). Validation scores the dev set on the device and runs
the host metric engine (:mod:`.metrics`) at every size. The experiment dir
keeps the JAX package's layout and formats: ``train.log``, ``val_log.log``,
``metrics.jsonl`` beside a TensorBoard events file, ``model_info.log``, and
``ckpts/`` with a checkpoint after every epoch (``epoch_<NNN>.pt``) and,
every ``ckpt_every_steps`` steps, step checkpoints under ``ckpts/steps/``
(:mod:`.checkpoint`), from which ``fit(resume=True)`` continues the same
data order.

Not ported yet (ROADMAP.md, queue 1, item 2f): the device metric engine
(``training/metrics_device.py``) and the slab-streamed path for datasets
larger than ``device_resident_bytes``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Set

import numpy as np
import torch

from ..config import Config
from ..data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from ..utils.logging import get_logger
from ..utils.tensorboard import SummaryWriter
from .checkpoint import CheckpointManager, load_state, load_state_dict, save_state
from .metrics import compute_user_metrics, format_validation_block

__all__ = ["AUC_BINS", "AucHist", "BatchPacker", "PackedDataset", "Trainer",
           "binned_auc_update", "binned_auc_value", "unpack_batch"]

logger = get_logger("trainer")

AUC_BINS = 4096
RUNTIME_NOT_PORTED = ("is not ported yet: see ROADMAP.md, queue 1, item 2f "
                      "('Training slice, runtime')")


@dataclass
class AucHist:
    """Binned (pos, neg) score histograms for the streaming train AUC."""

    pos: torch.Tensor
    neg: torch.Tensor

    @staticmethod
    def zeros(device) -> "AucHist":
        return AucHist(torch.zeros(AUC_BINS, device=device),
                       torch.zeros(AUC_BINS, device=device))


def binned_auc_update(hist: AucHist, probs, labels, weights) -> AucHist:
    """Add a batch to ``hist`` in place (and return it): bin = floor(p * BINS)
    clipped, weighted by ``weights * labels`` and ``weights * (1 - labels)``.
    ``index_add_`` rather than ``torch.bincount``, whose CUDA path reads the
    largest bin back to the host on every call."""
    bins = (probs * AUC_BINS).to(torch.int32).clamp(0, AUC_BINS - 1)
    hist.pos.index_add_(0, bins, weights * labels)
    hist.neg.index_add_(0, bins, weights * (1.0 - labels))
    return hist


def binned_auc_value(hist: AucHist) -> float:
    """AUC estimate: P(score_pos > score_neg) + 0.5 P(equal bin)."""
    cum_neg = torch.cumsum(hist.neg, 0) - hist.neg      # negatives strictly below bin
    wins = torch.sum(hist.pos * (cum_neg + 0.5 * hist.neg))
    total = torch.sum(hist.pos) * torch.sum(hist.neg)
    return float(wins / total) if float(total) > 0 else 0.0


class Trainer:
    """Epoch-driven trainer with the JAX package's experiment-dir logs.

    ``model`` brings its parameters (seeded by ``build_ranker``, or converted
    from the JAX package by :mod:`news_recsys_tpu_torch.convert`) and moves
    to ``device``: the card, unless the caller names another; with no card
    the move raises.
    """

    def __init__(self, cfg: Config, model, workdir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_step = self._make_train_step()
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.log_dir = workdir or os.path.join("experiments", f"{cfg.name}_{ts}")
        self.ckpt_dir = os.path.join(self.log_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.val_log_path = os.path.join(self.log_dir, "val_log.log")
        self.train_log_path = os.path.join(self.log_dir, "train.log")
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        open(self.val_log_path, "a").close()
        self.global_step = 0
        self._packed: Dict[int, tuple] = {}
        self._ckpt_mgr = None
        self._last_step_ckpt = 0       # where the ckpt_every_steps cadence counts from
        self._tb = None

    def _make_train_step(self):
        """``step(state, batch, carry) -> (loss, aux)``: the ranker's sparse
        or all-dense step, its carry the epoch's AUC histogram."""
        from .dense_step import make_train_step
        from .sparse_step import make_sparse_train_step

        return (make_sparse_train_step if self.sparse_embeddings
                else make_train_step)(self.model, self.cfg)

    @property
    def sparse_embeddings(self) -> bool:
        return self.cfg.train_hparams.embedding_optimizer in ("sparse_adamw", "rowwise_adagrad")

    def init_state(self):
        from .dense_step import init_dense_state
        from .sparse_step import init_sparse_state

        init = init_sparse_state if self.sparse_embeddings else init_dense_state
        state = init(self.model, self.cfg)
        self._write_model_info()
        return state

    def _write_model_info(self) -> None:
        """The parameter table of ``model_info.log`` as the JAX package writes
        it: one line a leaf of its parameter tree, under the flax paths and
        shapes that :mod:`..convert` maps the parameters to, in the tree's
        (sorted) order."""
        from ..convert import params_to_flax     # convert imports the steps, which import us

        flat = params_to_flax(self.model)
        lines = ["  | Name | Shape | Params"]
        total = 0
        for path in sorted(flat, key=lambda p: tuple(p.split("/"))):
            n = int(np.prod(flat[path].shape))
            total += n
            lines.append(f"  | params/{path} | {tuple(flat[path].shape)} | {n:,}")
        lines.append(f"  Total params: {total:,}")
        with open(os.path.join(self.log_dir, "model_info.log"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _device_matrices(self, ds: PackedDataset):
        """(packer, int matrix, float matrix) of ``ds``, the matrices uploaded
        to the device once per dataset."""
        if id(ds) not in self._packed:
            packer = BatchPacker(ds)
            if packer.int_mat.nbytes + packer.float_mat.nbytes > \
                    self.cfg.train_hparams.device_resident_bytes:
                raise NotImplementedError(
                    "a dataset larger than train_hparams.device_resident_bytes (the "
                    "slab-streamed path) " + RUNTIME_NOT_PORTED)
            self._packed[id(ds)] = (ds, packer, torch.from_numpy(packer.int_mat).to(self.device),
                                    torch.from_numpy(packer.float_mat).to(self.device))
        return self._packed[id(ds)][1:]

    # Epoch-loop carry hooks, as the JAX trainer's: every step of an epoch
    # gets the carry; the ranking trainer carries the binned AUC histogram,
    # the DSSM trainer the epoch's negative permutations. ``first_step`` (the
    # state's step) and ``steps`` (the epoch's step count) are the port's
    # addition: the DSSM carry draws them all and uploads them at once.
    def _epoch_carry(self, epoch: int, first_step: int, steps: int):
        return AucHist.zeros(self.device)

    def _carry_metrics(self, carry) -> Dict[str, float]:
        return {"train_auc": binned_auc_value(carry)}

    def train_epoch(self, state, ds: PackedDataset, epoch: int, skip_steps: int = 0):
        """One epoch in the permutation the JAX trainer draws; returns
        (state, metrics). ``skip_steps`` leaves out the first batches of that
        permutation (steps trained before a restart), as the JAX trainer's
        does."""
        hp = self.cfg.train_hparams
        bs = self.cfg.dataset.batch_size
        packer, int_dev, float_dev = self._device_matrices(ds)
        layout = packer.layout_key()
        rng = np.random.default_rng(np.random.SeedSequence([self.cfg.dataset.shuffle_seed, epoch]))
        order = rng.permutation(packer.n)
        nb_full = packer.n // bs
        start = min(skip_steps, nb_full)
        nb = max(0, min(nb_full - start, hp.max_step - self.global_step))
        idx = torch.from_numpy(order[start * bs:(start + nb) * bs].reshape(nb, bs)).to(
            self.device)                                                     # one upload
        ones = torch.ones(bs, device=self.device)
        carry = self._epoch_carry(epoch, state.step, nb)
        K = hp.embedding_update_period if self.sparse_embeddings else 1
        t0 = time.perf_counter()
        loss = None
        pos = 0
        while pos < nb:
            c = self._chunk_len(nb, pos)
            for j in range(c):
                i = pos + j
                batch = unpack_batch(int_dev[idx[i]], float_dev[idx[i]], ones, layout)
                loss, _ = self.train_step(state, batch, carry)
                if K > 1 and (j + 1) % K == 0:
                    self.train_step.flush(state)
            if K > 1:
                self.train_step.flush(state)           # the chunk's tail
            pos += c
            self.global_step += c
            self._maybe_step_checkpoint(state)
        loss_val = float(loss) if loss is not None else float("nan")   # waits for the device
        dt = time.perf_counter() - t0
        metrics = {"train_loss": loss_val, **self._carry_metrics(carry),
                   "examples_per_sec": nb * bs / max(dt, 1e-9), "steps": nb}
        self._log_scalars(epoch=epoch, **metrics)
        with open(self.train_log_path, "a") as f:
            f.write(f"Epoch {epoch} Training Metrics:\n")
            for k, v in metrics.items():
                f.write(f"  {k}: {v:.4f}\n")
            f.write("-" * 20 + "\n")
        extra = f" auc~{metrics['train_auc']:.4f}" if "train_auc" in metrics else ""
        logger.info(f"epoch {epoch}: steps={nb} loss={loss_val:.4f}{extra} "
                    f"ex/s={metrics['examples_per_sec']:.0f}")
        return state, metrics

    def _chunk_len(self, nb: int, pos: int) -> int:
        """The next chunk's step count, as the JAX trainer's dispatches:
        ``chunk_steps``, cut at the epoch's end and at the next
        ``ckpt_every_steps`` boundary. Steps run one call each either way;
        K-step write-back flushes at every chunk's end, where the JAX
        package's scanned chunk flushes, so nothing is pending at a
        checkpoint."""
        c = min(self.cfg.train_hparams.chunk_steps, nb - pos)
        every = self.cfg.train_hparams.ckpt_every_steps
        if every > 0:
            c = min(c, max(every - (self.global_step - self._last_step_ckpt), 1))
        return c

    def _log_scalars(self, **scalars) -> None:
        """One line of ``metrics.jsonl``, and the finite numbers among
        ``scalars`` in the TensorBoard events file beside it."""
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
        batch is padded with the last row and trimmed, as in JAX."""
        bs = batch_size or self.cfg.dataset.eval_batch_size or self.cfg.dataset.batch_size
        packer, int_dev, float_dev = self._device_matrices(ds)
        layout = packer.layout_key()
        nb = -(-packer.n // bs)
        idx = torch.arange(nb * bs, device=self.device).clamp_(max=packer.n - 1).view(nb, bs)
        ones = torch.ones(bs, device=self.device)
        with torch.inference_mode():
            return torch.cat([fn(unpack_batch(int_dev[i], float_dev[i], ones, layout))
                              for i in idx])[: packer.n]

    def validate(self, state, ds: PackedDataset, epoch: int,
                 warm_user_set: Optional[Set[int]] = None) -> Dict[str, Dict[str, float]]:
        """Score ``ds`` with ``state``'s model and compute the Overall /
        Warm-start / Cold-start block on the host; prints it, appends it to
        ``val_log.log`` and logs AUC, GAUC and NDCG@10 to ``metrics.jsonl``."""
        if state.model is not self.model:
            raise ValueError("validate: the state's model is not this trainer's")
        scores = self.predict(ds)
        results = compute_user_metrics(ds.arrays["user_id"], scores, ds.arrays["label"][:, 0],
                                       warm_user_set)
        block = format_validation_block(results, epoch)
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
            self._ckpt_mgr = CheckpointManager(os.path.join(self.ckpt_dir, "steps"))
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
        checkpoint ``step`` (one device holds the whole state here)."""
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
        """``state`` as ``<ckpt_dir>/epoch_<NNN>.pt``; returns the path."""
        return save_state(os.path.join(self.ckpt_dir, f"epoch_{epoch:03d}.pt"), state)

    def load_checkpoint(self, state, path: str):
        """Strict restore of a checkpoint file into ``state`` (the reference's
        ``load_model``, ``base_model.py:531-536``); the trainer's step
        follows the checkpoint's."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        state = load_state_dict(state, load_state(path))
        self.global_step = state.step
        self._reset_step_ckpt_origin()
        return state

    # -- fit -------------------------------------------------------------------

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
