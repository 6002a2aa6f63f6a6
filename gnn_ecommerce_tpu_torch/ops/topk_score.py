"""User×item top-K scorer with purchased-item masking.

Counterpart of ``gnn_ecommerce_tpu/ops/topk_score.py:topk_scores`` with the
exact top-K (``torch.topk``). One full-width f32 matmul per user tile, one
masking scatter, one top-K; only [B, k] ids leave the device.

The signature is the JAX package's, positions included. ``item_tile`` is
unused (the JAX package's item-tiled top-k only bounds the TPU's sort).
Every ``topk_impl`` gives the exact top-K: ``"exact"`` and ``"tiled"`` are
exact there too, and ``"approx"`` (``jax.lax.approx_max_k`` with
recall_target 0.99) promises a recall that the exact top-K meets.

Masking modes:
- ``"neginf"`` (default): masked entries get -3e38 added, so they never
  outrank a true candidate;
- ``"multiply"``: the reference's ``pred * (1 - interactions)``.

Ties: ``torch.topk`` and XLA's top-k may order equal scores differently;
the selected scores agree.
"""
from __future__ import annotations

import torch

from ..device import mm_f32

_NEG = -3.0e38
TOPK_IMPLS = ("exact", "tiled", "approx")


def _mask_scores(scores: torch.Tensor, mask_idx: torch.Tensor, mask_mode: str) -> torch.Tensor:
    """Apply the per-user exclusion lists in place (-1 entries are no-ops)."""
    valid = mask_idx >= 0
    cols = mask_idx.clamp(0, scores.shape[1] - 1).long()
    if mask_mode == "neginf":
        # Padding adds exact zeros at column 0, so the sum is order-free.
        return scores.scatter_add_(
            1, cols, torch.where(valid, _NEG, 0.0).to(scores.dtype)
        )
    if mask_mode == "multiply":
        keep = torch.ones_like(scores).scatter_reduce_(
            1, cols, torch.where(valid, 0.0, 1.0).to(scores.dtype), reduce="amin"
        )
        return scores.mul_(keep)
    raise ValueError(f"unknown mask_mode {mask_mode!r}")


def topk_scores(
    user_emb: torch.Tensor,  # [B, D] final embeddings of the requested users
    item_emb: torch.Tensor,  # [I, D] final embeddings of ALL items (local space)
    mask_idx: torch.Tensor,  # [B, M] local item ids to exclude per user, -1 padded
    k: int,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
    topk_impl: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (top-k scores [B, k], top-k local item ids [B, k] int32)."""
    if topk_impl not in TOPK_IMPLS:
        raise ValueError(f"unknown topk_impl {topk_impl!r}")
    scores = mm_f32(user_emb.float(), item_emb.float().T)
    scores = _mask_scores(scores, mask_idx, mask_mode)
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)
