"""Top-K recommendation for arbitrary users (the serving path).

Counterpart of ``gnn_ecommerce_tpu/eval/evaluate.py:recommend_users``. The
bucketed evaluation and its metrics come with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.topk_score import topk_scores


def recommend_users(
    final_emb: torch.Tensor,
    user_ids,
    mask_idx,
    n_users: int,
    k: int = 20,
    mask_mode: str = "neginf",
) -> np.ndarray:
    """Top-K local item ids [B, k] for ``user_ids`` from the propagated
    [n_users + n_items, D] embedding, excluding ``mask_idx`` [B, M]."""
    dev = final_emb.device
    ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int64, device=dev)
    mask = torch.as_tensor(np.asarray(mask_idx), device=dev)
    _, idx = topk_scores(
        final_emb.index_select(0, ids), final_emb[n_users:], mask, k, mask_mode
    )
    return idx.cpu().numpy()
