"""Training losses: BPR ranking loss and ego-embedding L2 regularization.

Counterpart of ``gnn_ecommerce_tpu/models/losses.py``:

- ``bpr_loss``: the net training objective ``-mean(logsigmoid(pos - neg))``;
- ``bpr_loss_reference``: the literal ``(-mean logsigmoid + λ‖E‖²) / n_pairs``
  form, kept for parity checks;
- ``reg_loss``: ``decay · 0.5 · (‖E[u]‖² + ‖E[p]‖² + ‖E[n]‖²) / batch`` on the
  layer-0 embeddings (a true division, ``device.divisor``); an id that
  appears twice in the batch counts twice, as a gather-then-norm does;
- ``link_pred_loss``: binary cross-entropy with logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import divisor


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor) -> torch.Tensor:
    """Mean BPR loss."""
    return -F.logsigmoid(pos_scores - neg_scores).mean()


def bpr_loss_reference(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    embedding: torch.Tensor,
    lambda_reg: float = 0.0,
) -> torch.Tensor:
    """``(-mean logsigmoid(pos - neg) + lambda_reg·‖embedding‖²) / n_pairs``."""
    n_pairs = pos_scores.shape[0]
    log_prob = F.logsigmoid(pos_scores - neg_scores).mean()
    reg = lambda_reg * embedding.float().pow(2).sum()
    return (-log_prob + reg) / divisor(n_pairs, log_prob.device)


def reg_loss(
    embedding: torch.Tensor,
    users: torch.Tensor,
    pos_items: torch.Tensor,
    neg_items: torch.Tensor,
    decay: float,
) -> torch.Tensor:
    """L2 on the gathered ego embeddings of the batch triplets."""
    sq = sum(embedding[ids].float().pow(2).sum() for ids in (users, pos_items, neg_items))
    return decay * 0.5 * sq / divisor(users.shape[0], sq.device)


def link_pred_loss(pred_logits: torch.Tensor, edge_label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits."""
    return F.binary_cross_entropy_with_logits(pred_logits, edge_label.to(pred_logits.dtype))
