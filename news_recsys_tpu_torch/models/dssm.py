"""DSSM two-tower retrieval model (port of the serving half of
:mod:`news_recsys_tpu.models.dssm`): user and item towers in->128->128->64->16
with LeakyReLU(0.2) between layers, embeddings L2-normalised by :func:`_l2`."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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
