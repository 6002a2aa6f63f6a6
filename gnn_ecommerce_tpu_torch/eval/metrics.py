"""Mean Recall@K and Precision@K.

Counterpart of ``gnn_ecommerce_tpu/eval/metrics.py:recall_precision_at_k``:
per eval user, overlap = |top-K ∩ truth|; recall = overlap / |truth|;
precision = overlap / K. The overlap is a membership test on the device.
"""
from __future__ import annotations

import torch


def recall_precision_at_k(
    topk_idx: torch.Tensor,  # [N, K] recommended local item ids
    truth: torch.Tensor,  # [N, T] ground-truth local item ids, -1 padded
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-user (recall, precision), float32 [N] each. Truth ids are unique
    per user, so the hit count is the size of the intersection."""
    hits = (topk_idx[:, :, None].long() == truth[:, None, :].long()).any(dim=2).sum(dim=1)
    truth_len = (truth >= 0).sum(dim=1).clamp(min=1)
    return hits.float() / truth_len.float(), hits.float() / k
