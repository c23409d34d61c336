"""Attention-based sequence ranker over the user's click history. Port of
:mod:`news_recsys_tpu.models.seq_ranker`:

1. the ``hist`` array feature (padded item-id sequence, table shared with
   ``item_id``) is embedded without mean-pooling (it is declared in
   ``unpooled_arrays``, so it arrives as a raw (B, L, D) field);
2. masked Transformer blocks contextualise the sequence, each one fused op
   (:class:`~news_recsys_tpu_torch.models.layers.TransformerBlock`);
3. target-aware attention pools it: weights = softmax over the history of
   (h_l . e_target) / sqrt(D), masked to real entries, zero for an empty
   history;
4. the pooled history vector joins the other fields' concat (schema order,
   then the pooled vector) and feeds the standard MLP tower.

It factors through ``forward_from_fields``, so it trains on the sparse
rowwise step (the history rows' gradient flows through the unpooled field)
and on the all-dense step alike.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..config import Config, FeatureSchema, build_schema, table_specs
from .layers import DEFAULT_HIDDEN, MLP, RankerBase, TransformerBlock

NEG = -1e9


class AttentionSeqRanker(RankerBase):
    def __init__(self, tables, schema: FeatureSchema, hist_feature: str = "hist",
                 num_layers: int = 1, num_heads: int = 2, ff_dim: int = 64,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None, **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        self.hist_feature = hist_feature
        self.unpooled_arrays = (hist_feature,)
        names = list(schema.names)
        self.hist_i, self.target_i = names.index(hist_feature), names.index("item_id")
        dim = schema[hist_feature].dim
        self.blocks = nn.ModuleList(TransformerBlock(dim, num_heads, ff_dim, generator=generator)
                                    for _ in range(num_layers))
        # every field but the history, then the pooled history vector; the
        # blocks stay float32 (``h`` is, from the float32 lookups), so they
        # keep their kernels under bfloat16 towers
        self.tower = MLP(schema.total_dim, hidden, generator, self.tower_dtype)

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        h = fields[self.hist_i]                                        # (B, L, D)
        mask = (masks or {}).get(self.hist_feature)
        if mask is None:
            mask = h.new_ones(h.shape[:2])
        for blk in self.blocks:
            h = blk(h, mask)

        # target-aware attention pooling
        target = fields[self.target_i]                                 # (B, D)
        scores = torch.einsum("bld,bd->bl", h, target) / math.sqrt(h.shape[-1])
        scores = torch.where(mask > 0, scores, NEG)
        alpha = torch.softmax(scores, dim=-1)
        # rows with an empty history: all -1e9 -> uniform alpha; zero them out
        alpha = alpha * (mask.sum(dim=1, keepdim=True) > 0)
        seq_vec = torch.einsum("bl,bld->bd", alpha, h)

        flat = [f for i, f in enumerate(fields) if i != self.hist_i]
        return self.tower(torch.cat(flat + [seq_vec], dim=1))[:, 0]


def build_attention_ranker(cfg: Config, *, seed: int = 0) -> AttentionSeqRanker:
    """The attention ranker of ``cfg`` (``attention_cfg``: ``hist_feature``,
    ``num_layers``, ``num_heads``, ``ff_dim``), its parameters drawn from
    ``seed``, on the CPU."""
    acfg = cfg.extra("attention_cfg", {}) or {}
    hist_feature = acfg.get("hist_feature", "hist")
    f = cfg.features
    rank_names = sorted(set(f.user_feature_names) | set(f.item_feature_names))
    if hist_feature not in rank_names:
        raise ValueError(
            f"attention ranker needs '{hist_feature}' in user/item feature names")
    if "item_id" not in rank_names:
        raise ValueError("attention ranker needs 'item_id' for target-aware pooling")
    return AttentionSeqRanker(
        tables=table_specs(cfg), schema=build_schema(cfg, rank_names),
        hist_feature=hist_feature, num_layers=int(acfg.get("num_layers", 1)),
        num_heads=int(acfg.get("num_heads", 2)), ff_dim=int(acfg.get("ff_dim", 64)),
        init_scale=cfg.embeddings.init_scale, generator=torch.Generator().manual_seed(seed),
        table_dtype=cfg.mesh.param_dtype, compute_dtype=cfg.mesh.compute_dtype)
