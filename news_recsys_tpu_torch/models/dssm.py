"""DSSM two-tower retrieval model with in-batch negatives and InfoNCE (port
of :mod:`news_recsys_tpu.models.dssm`): user and item towers
in->128->128->64->16 with LeakyReLU(0.2) between layers, embeddings
L2-normalised by :func:`_l2`; the InfoNCE loss (temperature 0.1, optional
logQ sampling-bias correction) and the triplet loss over ``rate`` in-batch
permutations of the item embeddings.

JAX draws the permutations inside the step from ``fold_in(key, step)``; here
they are an explicit ``(rate, B)`` int64 argument, drawn on the host by
:func:`draw_negative_permutations` from the seed and the global step, so a
resumed run reproduces them as JAX's does (and a test can hand in JAX's)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config, FeatureSchema, build_schema, table_specs

from .embedding import EmbeddingCollection
from .layers import Linear

TOWER_DIMS = (128, 128, 64, 16)


class Tower(nn.Module):
    def __init__(self, in_features: int, dims: Sequence[int] = TOWER_DIMS,
                 negative_slope: float = 0.2, generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = [in_features, *dims]
        self.layers = nn.ModuleList(Linear(a, b, generator) for a, b in zip(sizes, sizes[1:]))
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = nn.functional.leaky_relu(x, self.negative_slope)
        return x


class DSSM(nn.Module):
    def __init__(self, tables: Mapping[str, Tuple[int, int]], user_schema: FeatureSchema,
                 item_schema: FeatureSchema, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tables = dict(tables)
        self.user_schema = user_schema
        self.item_schema = item_schema
        self.embedder = EmbeddingCollection(tables, init_scale, generator)
        self.user_fc = Tower(user_schema.total_dim, generator=generator)
        self.item_fc = Tower(item_schema.total_dim, generator=generator)

    def user_embedding(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.user_fc(self.embedder.embed_batch(batch, self.user_schema))

    def item_embedding(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.item_fc(self.embedder.embed_batch(batch, self.item_schema))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.user_embedding(batch), self.item_embedding(batch)

    def towers_from_fields(self, user_fields, item_fields) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tower outputs from per-field embedding lists (schema order): the
        factoring the sparse step differentiates through with respect to the
        gathered table rows."""
        return (self.user_fc(torch.cat(user_fields, dim=1)),
                self.item_fc(torch.cat(item_fields, dim=1)))


def build_dssm(cfg: Config, *, seed: int = 0, device="cuda") -> DSSM:
    """The DSSM of ``cfg``, its parameters drawn from ``seed``, on ``device``
    (the card unless the caller names another; with no card the move raises)."""
    generator = torch.Generator().manual_seed(seed)
    model = DSSM(
        table_specs(cfg),
        user_schema=build_schema(cfg, sorted(cfg.features.user_feature_names)),
        item_schema=build_schema(cfg, sorted(cfg.features.item_feature_names)),
        init_scale=cfg.embeddings.init_scale,
        generator=generator,
    )
    return model.to(device).eval()


def _l2(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, 1e-12) along ``dim``."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def draw_negative_permutations(seed: int, step: int, B: int, rate: int) -> np.ndarray:
    """(rate, B) int64: the ``rate`` in-batch permutations of global step
    ``step``, from ``SeedSequence([seed, step])`` alone, so any run that
    reaches ``step`` draws the same ones."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    return np.stack([rng.permutation(B) for _ in range(rate)])


def sample_in_batch_negatives(perms: torch.Tensor, item_emb: torch.Tensor, item_ids=None):
    """(B, D) -> (B, rate, D): the rows of ``item_emb`` at each of the
    ``(rate, B)`` permutations ``perms``. With ``item_ids`` also returns the
    permuted ids (B, rate), for the logQ correction."""
    perms = perms.long()
    # F.embedding, not item_emb[perms]: the indexing's backward (index_put_
    # with accumulate) sums in a run-dependent order on the CPU
    neg = torch.nn.functional.embedding(perms, item_emb).transpose(0, 1)
    if item_ids is None:
        return neg
    return neg, item_ids[perms].transpose(0, 1)


def info_nce_loss(user_emb, pos_item_emb, neg_item_emb, temperature: float = 0.1,
                  mask=None, log_q_pos=None, log_q_neg=None) -> torch.Tensor:
    """InfoNCE with the positive at index 0; ``log_q_*`` subtract each
    candidate's log sampling probability from its logit (logQ correction).
    The mean runs over all B rows, masked ones included, as in JAX."""
    pos = (user_emb * pos_item_emb).sum(dim=1) / temperature                     # (B,)
    neg = torch.einsum("bd,bnd->bn", user_emb, neg_item_emb) / temperature      # (B, n)
    if log_q_pos is not None:
        pos = pos - log_q_pos
    if log_q_neg is not None:
        neg = neg - log_q_neg
    logits = torch.cat([pos[:, None], neg], dim=1)
    losses = -torch.log_softmax(logits, dim=1)[:, 0]
    if mask is not None:
        losses = losses * mask
    return losses.mean()


def triplet_loss(user_emb, pos_item_emb, neg_item_emb, margin: float = 1.0,
                 mask=None) -> torch.Tensor:
    """The reference's triplet formulation; the mean over all B rows."""
    n_neg = neg_item_emb.shape[1]
    pos = (user_emb * pos_item_emb).sum(dim=1) * n_neg
    neg = torch.einsum("bd,bnd->bn", user_emb, neg_item_emb).sum(dim=1)
    losses = torch.relu(margin - pos + neg)
    if mask is not None:
        losses = losses * mask
    return losses.mean()


def dssm_loss_from_embeddings(perms, user_emb, item_emb, batch, temperature: float = 0.1,
                              loss_type: str = "infonce", margin: float = 1.0,
                              logq_table=None, candidates=None) -> torch.Tensor:
    """The loss from raw tower outputs and the step's ``(rate, B)``
    permutations ``perms``. Only clicked rows count (``label`` times
    ``_valid``). The negatives are gathered from the un-normalised item
    embeddings and normalised after the gather; with ``logq_table`` (V,)
    and InfoNCE, each negative's log q is read at its permuted id.
    ``candidates``: ``item_emb`` -> the (item embeddings, item ids) of the
    global batch that ``perms`` index, where ``user_emb`` and ``item_emb``
    are a rank's slice of it (``perms`` that slice's columns); by default
    the batch's own."""
    cand_emb, cand_ids = (candidates(item_emb) if candidates is not None
                          else (item_emb, batch["item_id"]))
    user_emb = _l2(user_emb)
    item_emb_n = _l2(item_emb)
    mask = batch["label"][:, 0]
    if "_valid" in batch:
        mask = mask * batch["_valid"]
    if logq_table is not None and loss_type == "infonce":
        V = logq_table.shape[0]
        ids = batch["item_id"].long().clamp(0, V - 1)
        neg, neg_ids = sample_in_batch_negatives(perms, cand_emb,
                                                 item_ids=cand_ids.long().clamp(0, V - 1))
        return info_nce_loss(user_emb, item_emb_n, _l2(neg), temperature, mask,
                             log_q_pos=logq_table[ids], log_q_neg=logq_table[neg_ids])
    neg = _l2(sample_in_batch_negatives(perms, cand_emb))
    if loss_type == "triplet":
        return triplet_loss(user_emb, item_emb_n, neg, margin, mask)
    return info_nce_loss(user_emb, item_emb_n, neg, temperature, mask)


def dssm_train_loss(model: DSSM, perms, batch, temperature: float = 0.1,
                    loss_type: str = "infonce", margin: float = 1.0,
                    logq_table=None, candidates=None) -> torch.Tensor:
    """:func:`dssm_loss_from_embeddings` of ``model(batch)``: the towers run
    whole, so ``hist`` goes through the fused lookup + pool. ``candidates``:
    :func:`dssm_loss_from_embeddings`'s."""
    user_emb, item_emb = model(batch)
    return dssm_loss_from_embeddings(perms, user_emb, item_emb, batch, temperature,
                                     loss_type, margin, logq_table=logq_table,
                                     candidates=candidates)


def item_log_q(train_ds, vocab: int) -> np.ndarray:
    """(V,) float32 log q: each item's frequency among the training rows
    (negatives are permutations of the batch's items), one pseudo-count at
    least; ids at or above ``vocab`` are cut off the table."""
    ids = np.asarray(train_ds.arrays["item_id"])
    counts = np.bincount(ids, minlength=vocab).astype(np.float64)[:vocab]
    counts = np.maximum(counts, 1.0)
    q = counts / counts.sum()
    return np.log(q).astype(np.float32)
