"""Ranking models. Port of :mod:`news_recsys_tpu.models.rankers`; this slice
carries DCN-v1, the ranker of the serving cascade.

Every ranker returns **logits** (B,) and factors as
``forward = forward_from_fields(embed_fields(batch))``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from news_recsys_tpu.config import Config, FeatureSchema, build_schema, table_specs

from ..ops.dcn_kernel import dcn_cross_stack
from .embedding import EmbeddingCollection
from .layers import MLP

DEFAULT_HIDDEN = (128, 128, 128, 64, 1)
RANKER_NAMES = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "attention")


class RankerBase(nn.Module):
    """Embedding collection + rank-feature schema."""

    def __init__(self, tables: Mapping[str, Tuple[int, int]], schema: FeatureSchema,
                 init_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.schema = schema
        self.embedder = EmbeddingCollection(tables, init_scale, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.forward_from_fields(self.embedder.embed_fields(batch, self.schema))

    def forward_from_fields(self, fields) -> torch.Tensor:
        raise NotImplementedError


class CrossNetV1(nn.Module):
    """Stacked DCN-v1 cross layers through the fused ``dcn_cross_stack``.

    ``ws``/``bs`` (NL, D) stack the per-layer ``w_i`` (D, 1) and ``b_i`` (D,)
    of the JAX module; ``w_i`` is Xavier-uniform, ``b_i`` zero.
    """

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(6.0 / (dim + 1))      # xavier_uniform of a (dim, 1) kernel
        ws = torch.empty(num_layers, dim).uniform_(-bound, bound, generator=generator)
        self.ws = nn.Parameter(ws)
        self.bs = nn.Parameter(torch.zeros(num_layers, dim))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        return dcn_cross_stack(x0, self.ws, self.bs)


class DCNRanker(RankerBase):
    """Cross net + MLP over concat[x, cross(x)] (``dcn/model.py:16-29``)."""

    def __init__(self, tables, schema: FeatureSchema, cross_layers: int = 3,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(tables, schema, init_scale, generator)
        dim = schema.total_dim
        self.cross = CrossNetV1(dim, cross_layers, generator)
        self.tower = MLP(2 * dim, hidden, generator)

    def forward_from_fields(self, fields) -> torch.Tensor:
        x = torch.cat(fields, dim=1)
        return self.tower(torch.cat([x, self.cross(x)], dim=1))[:, 0]


def build_ranker(cfg: Config, name: Optional[str] = None, *, seed: int = 0,
                 device="cpu") -> RankerBase:
    """A ranker by name, its parameters drawn from ``seed``, on ``device``."""
    name = name or cfg.name
    if name not in RANKER_NAMES:
        raise ValueError(f"Unknown ranker: {name!r}")
    dcn = cfg.extra("dcn_cfg", {}) or {}
    if name != "dcn" or int(dcn.get("version", 1)) != 1:
        raise NotImplementedError(
            f"ranker {name!r} (dcn_cfg {dcn}) is not ported yet: see ROADMAP.md, "
            "queue 1, 'Rest of the ranking zoo' (the attention ranker: "
            "'Attention sequence ranker')")
    if cfg.mesh.param_dtype != "float32" or cfg.mesh.compute_dtype != "float32":
        raise NotImplementedError("bfloat16 tables and towers are not ported yet: "
                                  "see ROADMAP.md, queue 1, 'Optimizer variants'")
    generator = torch.Generator().manual_seed(seed)
    model = DCNRanker(table_specs(cfg), build_schema(cfg),
                      cross_layers=int(dcn.get("num_layers", 3)),
                      init_scale=cfg.embeddings.init_scale, generator=generator)
    return model.to(device).eval()
