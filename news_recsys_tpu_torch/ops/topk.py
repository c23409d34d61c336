"""Exact inner-product top-k over an embedding corpus: one (B, D) x (D, N)
matmul and ``torch.topk`` per query batch (port of
:mod:`news_recsys_tpu.ops.topk`, which is plain XLA, not a Pallas kernel)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class TopKSearcher:
    """Inner-product top-k: ``update_embedding`` snapshots a corpus onto
    ``device``; ``search`` returns (indices, scores) as numpy arrays."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.corpus: Optional[torch.Tensor] = None

    def update_embedding(self, embeddings) -> None:
        self.corpus = torch.as_tensor(embeddings, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def search(self, queries, k: int, batch_size: int = 8192) -> Tuple[np.ndarray, np.ndarray]:
        if self.corpus is None:
            raise RuntimeError("update_embedding must be called before search")
        queries = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        idx_out, score_out = [], []
        for start in range(0, queries.shape[0], batch_size):
            scores = queries[start:start + batch_size] @ self.corpus.T
            top_scores, top_idx = torch.topk(scores, k, dim=1)
            idx_out.append(top_idx.cpu().numpy())
            score_out.append(top_scores.cpu().numpy())
        return np.concatenate(idx_out), np.concatenate(score_out)
