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


def loss_fn(model: nn.Module, batch, mesh=None):
    """(loss, logits, labels, weights): sigmoid BCE on the logits, weighted
    by ``_valid`` and divided by ``max(sum of weights, 1)``, the sum over
    ``mesh``'s data axis (this rank's share of the global batch's loss)."""
    logits = model(batch)
    labels = batch["label"][:, 0]
    weights = batch.get("_valid")
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

    def train_step(state: DenseTrainState, batch, hist: AucHist):
        loss, logits, labels, weights = loss_fn(state.model, batch, mesh)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        (loss,) = sum_over_data(mesh, state.opt.param_groups[0]["params"], loss)
        for group in state.opt.param_groups:
            group["lr"] = sched(state.step)
        with torch.no_grad():
            state.opt.step()
            binned_auc_update(hist, torch.sigmoid(logits), labels, weights)
        state.step += 1
        return loss.detach(), logits.detach()

    return train_step
