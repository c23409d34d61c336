"""Ranking model zoo: LR, Deep, Wide&Deep, FM, DeepFM, DCN v1/v2 (and, in
:mod:`.seq_ranker`, the attention sequence ranker; in :mod:`.nrms`, NRMS,
which the JAX package does not have). Port of
:mod:`news_recsys_tpu.models.rankers`, with its slicing contracts:

- FM and DeepFM: per field, column 0 of the embedding is the first-order
  weight ``w``, columns 1..d the latent vector ``v``; the second order runs
  in :func:`~news_recsys_tpu_torch.ops.fm_kernel.fm_second_order`;
- Wide&Deep: for wide features, column 0 is the wide (linear) part,
  columns 1..d the deep part;
- DCN v1: ``x0 * (x_l . w) + b + x_l`` through the fused cross stack;
  DCN v2: ``relu(x0 * Linear(x_l) + x_l)`` per layer.

Every ranker returns **logits** (B,) and factors as
``forward = forward_from_fields(embed_fields(batch), masks)``. Parameter names
map one to one onto the JAX package's flax paths
(:mod:`news_recsys_tpu_torch.convert`): ``tower.layers.<i>`` for an MLP,
``cross.layers.<i>`` for DCN-v2's ``Linear``s, a top-level ``bias`` (1,).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Config, FeatureSchema, build_schema, table_specs

from ..ops.dcn_kernel import dcn_cross_stack
from ..ops.fm_kernel import fm_second_order
from .embedding import EmbeddingCollection
from .layers import MLP, Linear

DEFAULT_HIDDEN = (128, 128, 128, 64, 1)
RANKER_NAMES = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "attention", "nrms")


class RankerBase(nn.Module):
    """Embedding collection + rank-feature schema. ``tables`` maps each
    physical table to its (vocab, dim), as the JAX module's field does; the
    sparse train step reads it."""

    # array features a subclass consumes as raw (B, L, D) sequences instead
    # of mean-pooled vectors (their masks travel via the ``masks`` argument)
    unpooled_arrays: Tuple[str, ...] = ()

    def __init__(self, tables: Mapping[str, Tuple[int, int]], schema: FeatureSchema,
                 init_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                 table_dtype: str = "float32", compute_dtype: str = "float32"):
        super().__init__()
        self.tables = dict(tables)
        self.schema = schema
        # mesh.compute_dtype: the MLP towers' matmul dtype (None: float32)
        self.tower_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else None
        self.embedder = EmbeddingCollection(tables, init_scale, generator, table_dtype)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        fields = self.embedder.embed_fields(batch, self.schema,
                                            unpooled=set(self.unpooled_arrays))
        return self.forward_from_fields(fields, self._collect_masks(batch))

    def _collect_masks(self, batch) -> Dict[str, torch.Tensor]:
        masks = {}
        for name in self.unpooled_arrays:
            m = batch.get(f"{name}_mask")
            masks[name] = (batch[name] != 0 if m is None else m).to(torch.float32)
        return masks

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        raise NotImplementedError


class LRRanker(RankerBase):
    """Logistic regression via dim-1 embeddings: logit = sum of the concat
    (reference ``lr/model.py:17-27``)."""

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        return torch.cat(fields, dim=1).sum(dim=1)


class DeepRanker(RankerBase):
    """Concat embeddings -> MLP [128,128,128,64,1] (``deep/model.py:12-29``)."""

    def __init__(self, tables, schema: FeatureSchema, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 init_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                 **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        self.tower = MLP(schema.total_dim, hidden, generator, self.tower_dtype)

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        return self.tower(torch.cat(fields, dim=1))[:, 0]


class WideDeepRanker(RankerBase):
    """Wide (sum of the wide features' column 0 + bias) + deep MLP over the
    rest (``widedeep/model.py``)."""

    def __init__(self, tables, schema: FeatureSchema, wide_features: Sequence[str],
                 hidden: Sequence[int] = DEFAULT_HIDDEN, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None, **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        self.wide_features = tuple(wide_features)
        n_wide = sum(spec.name in self.wide_features for spec in schema.specs)
        self.tower = MLP(schema.total_dim - n_wide, hidden, generator, self.tower_dtype)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        wide_cols, deep_cols = [], []
        for spec, emb in zip(self.schema.specs, fields):
            if spec.name in self.wide_features:
                wide_cols.append(emb[:, 0:1])
                deep_cols.append(emb[:, 1:])
            else:
                deep_cols.append(emb)
        wide = torch.cat(wide_cols, dim=1).sum(dim=1) + self.bias[0]
        return wide + self.tower(torch.cat(deep_cols, dim=1))[:, 0]


def fm_first_and_second(fields, model: str) -> torch.Tensor:
    """Sum of the fields' column 0 plus the second order of columns 1..d."""
    if len({e.shape[1] for e in fields}) != 1:
        raise AssertionError(f"{model} requires equal embedding dims across fields")
    w = torch.cat([e[:, 0:1] for e in fields], dim=1)               # (B, nf)
    v = torch.stack([e[:, 1:] for e in fields], dim=1)              # (B, nf, d-1)
    return w.sum(dim=1) + fm_second_order(v)


class FMRanker(RankerBase):
    """Factorization machine on column-sliced embeddings (``fm/model.py``)."""

    def __init__(self, tables, schema: FeatureSchema, init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None, **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        return self.bias[0] + fm_first_and_second(fields, "FM")


class DeepFMRanker(RankerBase):
    """DeepFM: FM first and second order plus a deep MLP over the same
    shared embeddings, summed into one logit (Guo et al. 2017)."""

    def __init__(self, tables, schema: FeatureSchema, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 init_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                 **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        self.bias = nn.Parameter(torch.zeros(1))
        self.tower = MLP(schema.total_dim, hidden, generator, self.tower_dtype)

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        fm = fm_first_and_second(fields, "DeepFM")
        return self.bias[0] + fm + self.tower(torch.cat(fields, dim=1))[:, 0]


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


class CrossNetV2(nn.Module):
    """Stacked DCN-v2 cross layers with ReLU between (``dcn_arch.py:69-90``)."""

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(Linear(dim, dim, generator) for _ in range(num_layers))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self.layers:
            x = torch.relu(x0 * layer(x) + x)
        return x


class DCNRanker(RankerBase):
    """Cross net + MLP over concat[x, cross(x)] (``dcn/model.py:16-29``)."""

    def __init__(self, tables, schema: FeatureSchema, cross_layers: int = 3,
                 cross_version: int = 1, hidden: Sequence[int] = DEFAULT_HIDDEN,
                 init_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                 **dtypes):
        super().__init__(tables, schema, init_scale, generator, **dtypes)
        dim = schema.total_dim
        cross = CrossNetV1 if cross_version == 1 else CrossNetV2
        self.cross = cross(dim, cross_layers, generator)
        self.tower = MLP(2 * dim, hidden, generator, self.tower_dtype)

    def forward_from_fields(self, fields, masks=None) -> torch.Tensor:
        x = torch.cat(fields, dim=1)
        return self.tower(torch.cat([x, self.cross(x)], dim=1))[:, 0]


def build_ranker(cfg: Config, name: Optional[str] = None, *, seed: int = 0,
                 device="cuda") -> RankerBase:
    """A ranker by name, its parameters drawn from ``seed``, on ``device``
    (the card unless the caller names another; with no card the move raises)."""
    name = name or cfg.name
    if name not in RANKER_NAMES:
        raise ValueError(f"Unknown ranker: {name!r}")
    if name == "attention":
        from .seq_ranker import build_attention_ranker

        return build_attention_ranker(cfg, seed=seed).to(device).eval()
    if name == "nrms":
        from .nrms import build_nrms

        return build_nrms(cfg, seed=seed).to(device).eval()
    schema = build_schema(cfg)
    common = dict(tables=table_specs(cfg), schema=schema,
                  init_scale=cfg.embeddings.init_scale,
                  generator=torch.Generator().manual_seed(seed),
                  table_dtype=cfg.mesh.param_dtype, compute_dtype=cfg.mesh.compute_dtype)
    if name == "lr":
        model = LRRanker(**common)
    elif name == "deep":
        model = DeepRanker(**common)
    elif name == "widedeep":
        wd = cfg.extra("wide_and_deep_cfg", {}) or {}
        wide = tuple(wd.get("wide_feature_names", ()))
        if not any(f in schema for f in wide):
            raise ValueError(
                "widedeep requires wide_and_deep_cfg.wide_feature_names with at "
                f"least one feature from the rank schema {schema.names}; got {wide!r}")
        model = WideDeepRanker(wide_features=wide, **common)
    elif name == "fm":
        model = FMRanker(**common)
    elif name == "deepfm":
        model = DeepFMRanker(**common)
    else:
        dcn = cfg.extra("dcn_cfg", {}) or {}
        model = DCNRanker(cross_layers=int(dcn.get("num_layers", 3)),
                          cross_version=int(dcn.get("version", 1)), **common)
    return model.to(device).eval()
