"""Embedding engine: one table per physical table name, lookup / pool / concat
in the schema's sorted-name order.

Port of :mod:`news_recsys_tpu.models.embedding`, with the same contracts:

- table rows are ``padded_vocab(vocab)`` (a multiple of 128), so parameters
  convert one to one from the JAX package;
- row 0 is the padding row: lookups multiply by ``(ids != 0)``, so id 0
  reads as zeros;
- arena members (``arena_d<D>`` tables) shift real ids by their offset and
  clamp ids outside ``[1, member_vocab)`` to padding (:func:`offset_ids`);
- array features are masked-mean pooled with the ``+1e-8`` denominator,
  through :func:`~news_recsys_tpu_torch.ops.fused_lookup_pool.fused_lookup_pool`.

Ids outside a table's ``[0, V)`` read as NaN rows, as ``jnp.take`` fills
them in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from news_recsys_tpu.config import ARRAY, DENSE, SPARSE, FeatureSchema

from ..ops.fused_lookup_pool import fused_lookup_pool

VOCAB_PAD_MULTIPLE = 128


def padded_vocab(vocab: int) -> int:
    """Round vocab+1 up to a multiple of 128 (leaves a spare row above all ids)."""
    return ((vocab + 1 + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def offset_ids(spec, ids: torch.Tensor) -> torch.Tensor:
    """Logical feature ids -> physical table rows: arena members shift real
    ids by ``spec.id_offset`` and send ids outside ``[1, member_vocab)`` to
    padding row 0, so a corrupt id never reads another member's rows."""
    if spec.member_vocab > 0:
        ok = (ids > 0) & (ids < spec.member_vocab)
        return torch.where(ok, ids + spec.id_offset, torch.zeros_like(ids))
    return ids


class EmbeddingCollection(nn.Module):
    """Owns every embedding table (``tables``: name -> (vocab, dim)), each
    initialised N(0, init_scale) from ``generator`` with row 0 zero."""

    def __init__(self, tables: Mapping[str, Tuple[int, int]], init_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        params = {}
        for name, (vocab, dim) in sorted(tables.items()):
            table = torch.empty(padded_vocab(vocab), dim)
            table.normal_(0.0, init_scale, generator=generator)
            table[0] = 0.0
            params[name] = nn.Parameter(table)
        self.tables = nn.ParameterDict(params)

    def lookup(self, table_name: str, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows (..., D); id 0 reads zeros, ids outside [0, V) read NaN."""
        table = self.tables[table_name]
        V = table.shape[0]
        emb = table[ids.clamp(0, V - 1).long()]
        emb = emb.masked_fill(((ids < 0) | (ids >= V))[..., None], float("nan"))
        return emb * (ids != 0).to(emb.dtype)[..., None]

    @staticmethod
    def pool(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked mean over axis 1: (B, L, D), (B, L) -> (B, D)."""
        mask = mask.to(emb.dtype)[..., None]
        return (emb * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-8)

    def embed_fields(self, batch: Dict[str, torch.Tensor], schema: FeatureSchema):
        """Per-field embeddings in schema (sorted-name) order: list of (B, d_f)."""
        parts = []
        for spec in schema.specs:
            val = batch[spec.name]
            if spec.kind == DENSE:
                parts.append(val.to(torch.float32)[:, None])
                continue
            val = offset_ids(spec, val)
            if spec.kind == SPARSE:
                if val.dim() != 1:
                    raise ValueError(
                        f"Sparse feature '{spec.name}' has {val.dim()}-D input "
                        f"{tuple(val.shape)}; sequence features must be declared in "
                        "features.array_feature_names (with array_max_length).")
                parts.append(self.lookup(spec.table, val))
            elif spec.kind == ARRAY:
                mask = batch.get(f"{spec.name}_mask")
                if mask is None:
                    mask = val != 0
                parts.append(fused_lookup_pool(
                    self.tables[spec.table], val.to(torch.int32).contiguous(),
                    mask.to(torch.float32).contiguous()))
            else:
                raise ValueError(spec.kind)
        return parts

    def embed_batch(self, batch: Dict[str, torch.Tensor], schema: FeatureSchema) -> torch.Tensor:
        """(B, schema.total_dim): per-feature embeddings concatenated in schema order."""
        return torch.cat(self.embed_fields(batch, schema), dim=1)
