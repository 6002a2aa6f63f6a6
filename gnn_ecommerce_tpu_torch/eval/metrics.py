"""Mean Recall@K and Precision@K.

Counterpart of ``gnn_ecommerce_tpu/eval/metrics.py:recall_precision_at_k``:
per eval user, overlap = |top-K ∩ truth|; recall = overlap / |truth|;
precision = overlap / K (true divisions: ``device.divisor``). The overlap is
a membership test on the device.
``mark_frame`` gives the per-user metrics table of the JAX package's
``mark_frame`` as a :class:`~..data.frame.Frame`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.frame import Frame
from ..device import divisor


def recall_precision_at_k(
    topk_idx: torch.Tensor,  # [N, K] recommended local item ids
    truth: torch.Tensor,  # [N, T] ground-truth local item ids, -1 padded
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-user (recall, precision), float32 [N] each. Truth ids are unique
    per user, so the hit count is the size of the intersection."""
    hits = (topk_idx[:, :, None].long() == truth[:, None, :].long()).any(dim=2).sum(dim=1)
    truth_len = (truth >= 0).sum(dim=1).clamp(min=1)
    return hits.float() / truth_len.float(), hits.float() / divisor(k, hits.device)


def mark_frame(
    user_ids: np.ndarray,
    truth_lists: list,
    topk_idx: np.ndarray,
    recall: np.ndarray,
    precision: np.ndarray,
) -> Frame:
    """Per-user metrics with the reference's columns: user_id_idx,
    item_id_idx_list, top_rlvnt_itm, overlap_item, recall, precision.

    The overlap is built as the JAX package builds it,
    ``sorted(set(top) & set(truth))``, so its cells hold the same objects:
    a set intersection keeps the elements of the smaller set (the right one
    on a tie), which are numpy integers when the truth list is no longer
    than K, and their ``str`` is what the CSV holds."""
    top_lists = [list(map(int, row)) for row in topk_idx]
    overlap = [sorted(set(t) & set(g)) for t, g in zip(top_lists, truth_lists)]
    return Frame({
        "user_id_idx": np.asarray(user_ids),
        "item_id_idx_list": [list(map(int, t)) for t in truth_lists],
        "top_rlvnt_itm": top_lists,
        "overlap_item": overlap,
        "recall": np.asarray(recall),
        "precision": np.asarray(precision),
    })
