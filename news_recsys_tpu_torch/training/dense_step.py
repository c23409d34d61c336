"""The all-dense training step: AdamW over every parameter, tables included.

Port of the JAX package's ``make_optimizer`` / ``loss_fn`` /
``make_train_step`` (``news_recsys_tpu/training/trainer.py``), the path of
``embedding_optimizer="adamw"`` (what ``configs/attention.yaml`` ships): the
model runs whole (``model(batch)`` through ``embed_fields``, so a pooled
array feature goes through the fused lookup + pool and its backward
kernel), the loss is the sigmoid BCE weighted by ``_valid``, and one
``torch.optim.AdamW`` steps every parameter in one group, as optax applies
no mask: the full tables are read and written every step, with their
moments. The lr is the schedule at the pre-increment step, as optax
evaluates it. One step per call, eager, in place.

A config with ``loss: listwise`` (NRMS, ``zoo.mind_nrms_config``) trains on
rows of 1 + K candidates instead: the model gives (B, C) logits, ``label``
is (B, C) with a row's positive at 1, and the loss is the softmax
cross-entropy over each row's candidates, ``-sum_c label_c log softmax(y)_c``,
weighted by ``_valid`` as the BCE is (it does not depend on where a row puts
its positive); the train AUC's histogram takes every candidate of a row.

A step records (:mod:`..utils.profiling`) ``train.step`` and its parts
``.forward``, ``.backward``, ``.adamw`` and ``.auc``, under the sparse
step's names; the listwise loss adds to ``train.step.score``, beside the
span a model records for its scores.

Under a :class:`~news_recsys_tpu_torch.parallel.mesh.Mesh` each rank runs
its slice of the batch; its tables hold their shards and are read through
the id exchange (the pooled ones on the compact table of the rows asked
for), so a table's gradient lands on its shards; the loss divides by the
global weight sum, and every gradient, a shard's too, is summed over the
data axis in one flat buffer before AdamW steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..utils.profiling import span
from .schedule import hold_cosine_floor
from .sparse_step import ADAM_EPS, global_weight_sum, sharded_tables, sum_over_data
from .trainer import AucHist, binned_auc_update


@dataclass
class DenseTrainState:
    """The model (its parameters are the training state), AdamW over all of
    them, and the number of steps taken."""

    model: nn.Module
    opt: torch.optim.AdamW
    step: int = 0


def check_dense(cfg: Config) -> None:
    if cfg.train_hparams.embedding_optimizer != "adamw":
        raise ValueError("the all-dense step runs embedding_optimizer='adamw'; "
                         f"{cfg.train_hparams.embedding_optimizer!r} trains on the sparse "
                         "step (training/sparse_step.py)")


def make_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    """AdamW with the config's betas and weight decay, eps 1e-8: optax's
    ``adamw`` formula, in one group over ``params``. The lr is set on the
    group before every step."""
    hp = cfg.train_hparams
    return torch.optim.AdamW(list(params),
                             lr=hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)(0),
                             betas=(hp.b1, hp.b2), eps=ADAM_EPS, weight_decay=hp.weight_decay)


LOSSES = ("bce", "listwise")


def loss_kind(cfg: Config) -> str:
    """The config's ``loss``: ``bce`` (the default) or ``listwise``."""
    kind = cfg.extra("loss", "bce")
    if kind not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {kind!r}")
    return kind


def loss_fn(model: nn.Module, batch, mesh=None, kind: str = "bce"):
    """(loss, logits, labels, weights): on the logits, the sigmoid BCE (or,
    ``kind`` ``listwise``, the softmax cross-entropy over each row's
    candidates), weighted by ``_valid`` and divided by ``max(sum of
    weights, 1)``, the sum over ``mesh``'s data axis (this rank's share of
    the global batch's loss)."""
    logits = model(batch)
    weights = batch.get("_valid")
    if kind == "listwise":
        labels = batch["label"]
        if weights is None:
            weights = labels.new_ones(labels.shape[0])
        with span("train.step.score"):
            per_ex = -(labels * F.log_softmax(logits, dim=1)).sum(dim=1)
            loss = (per_ex * weights).sum() / global_weight_sum(weights, mesh).clamp(min=1.0)
        return loss, logits, labels, weights
    labels = batch["label"][:, 0]
    if weights is None:
        weights = torch.ones_like(labels)
    per_ex = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    loss = (per_ex * weights).sum() / global_weight_sum(weights, mesh).clamp(min=1.0)
    return loss, logits, labels, weights


def init_dense_state(model: nn.Module, cfg: Config) -> DenseTrainState:
    """The training state of ``model``'s current parameters; every
    parameter requires grad."""
    check_dense(cfg)
    for p in model.parameters():
        p.requires_grad_(True)
    return DenseTrainState(model, make_optimizer(cfg, model.parameters()))


def make_train_step(model: nn.Module, cfg: Config, mesh=None):
    """``step(state, batch, hist) -> (loss, logits)``: one training step on a
    batch dict (``unpack_batch``'s, tensors on the model's device), updating
    ``state`` and the AUC histogram ``hist`` in place. ``mesh``: the rank's
    mesh (``batch`` its slice); the loss is the global batch's."""
    check_dense(cfg)
    sharded_tables(model, mesh)
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    kind = loss_kind(cfg)

    def train_step(state: DenseTrainState, batch, hist: AucHist):
        with span("train.step"):
            return _step(state, batch, hist)

    def _step(state: DenseTrainState, batch, hist: AucHist):
        with span("train.step.forward"):
            loss, logits, labels, weights = loss_fn(state.model, batch, mesh, kind)
        with span("train.step.backward"):
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            (loss,) = sum_over_data(mesh, state.opt.param_groups[0]["params"], loss)
        with torch.no_grad():
            with span("train.step.adamw"):
                for group in state.opt.param_groups:
                    group["lr"] = sched(state.step)
                state.opt.step()
            with span("train.step.auc"):
                if logits.dim() > 1:                    # every candidate of a row
                    weights = weights[:, None].expand_as(logits).reshape(-1)
                binned_auc_update(hist, torch.sigmoid(logits.reshape(-1)), labels.reshape(-1),
                                  weights)
        state.step += 1
        return loss.detach(), logits.detach()

    return train_step
