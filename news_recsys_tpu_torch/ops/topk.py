"""Exact inner-product (optionally cosine) top-k over an embedding corpus:
one (B, D) x (D, N) matmul and ``torch.topk`` per query batch (port of
:mod:`news_recsys_tpu.ops.topk`, which is plain XLA, not a Pallas kernel)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x`` over its L2 norm along ``axis``, the norm held at ``eps`` or more
    (a zero row stays zero)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=axis, keepdim=True), min=eps)


class TopKSearcher:
    """Inner-product top-k: ``update_embedding`` snapshots a corpus onto
    ``device``; ``search_tensors`` returns (indices, scores) as tensors there,
    ``search`` as numpy arrays. With ``normalize`` the corpus and the queries
    are L2-normalised first (cosine)."""

    def __init__(self, device="cuda", normalize: bool = False):
        self.device = torch.device(device)
        self.normalize = normalize
        self.corpus: Optional[torch.Tensor] = None

    def update_embedding(self, embeddings) -> None:
        corpus = torch.as_tensor(embeddings, dtype=torch.float32, device=self.device)
        self.corpus = l2_normalize(corpus) if self.normalize else corpus

    @torch.inference_mode()
    def search_tensors(self, queries, k: int,
                       batch_size: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
        """(indices, scores), each (n, k), on ``device``; nothing is copied to
        the host and nothing waits for the device."""
        if self.corpus is None:
            raise RuntimeError("update_embedding must be called before search")
        queries = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        if self.normalize:
            queries = l2_normalize(queries)
        tops = [torch.topk(queries[start:start + batch_size] @ self.corpus.T, k, dim=1)
                for start in range(0, queries.shape[0], batch_size)]
        return torch.cat([t.indices for t in tops]), torch.cat([t.values for t in tops])

    def search(self, queries, k: int, batch_size: int = 8192) -> Tuple[np.ndarray, np.ndarray]:
        idx, scores = self.search_tensors(queries, k, batch_size)
        return idx.cpu().numpy(), scores.cpu().numpy()
