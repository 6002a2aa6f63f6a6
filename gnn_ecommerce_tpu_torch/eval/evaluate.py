"""Evaluation (top-K + Recall/Precision@K over eval users) and top-K for
arbitrary users (the serving path).

Counterpart of ``gnn_ecommerce_tpu/eval/evaluate.py``. Users go through the
exact scorer ``ops/topk_score.py`` in tiles of ``user_tile``; recall and
precision reduce on the device and only per-user vectors reach the host.

Eval users are bucketed by the power-of-two width of their train-purchase
mask (:func:`build_eval_buckets`), so one heavy user does not pad every
user's mask to its width. The JAX package also pads each bucket's rows and
truth width to powers of two; that only bounds the TPU's compiled shapes and
is dropped here. The means stay user-weighted, so the bucketed result equals
the single-batch :func:`evaluate`.

The signatures are the JAX package's, positions included: ``item_tile`` is
unused and every ``topk_impl`` is exact (``ops/topk_score.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.prepare import CsrList, EvalSplit
from ..device import resolve_device
from ..ops.topk_score import topk_scores
from .metrics import recall_precision_at_k


@dataclasses.dataclass(frozen=True)
class EvalBatch:
    """Padded, device-resident evaluation structures for one split (or one
    bucket of it)."""

    user_ids: torch.Tensor  # [Nu] int64
    truth: torch.Tensor  # [Nu, T] local item ids, -1 padded
    mask: torch.Tensor  # [Nu, M] train-purchased local item ids, -1 padded
    # The real users: the first num_users rows (None: every row). Rows past
    # it are padding that never reaches the means, as in the JAX package.
    num_users: int | None = None

    def __post_init__(self):
        rows = int(self.user_ids.shape[0])
        n = rows if self.num_users is None else min(int(self.num_users), rows)
        object.__setattr__(self, "num_users", n)


def _pad_csr(indptr: np.ndarray, values: np.ndarray, width: int) -> np.ndarray:
    rows = len(indptr) - 1
    out = np.full((rows, width), -1, dtype=np.int64)
    lens = np.diff(indptr)
    row_idx = np.repeat(np.arange(rows), lens)
    col_idx = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(indptr[:-1], lens)
    out[row_idx, col_idx] = values
    return out


def build_eval_batch(split: EvalSplit, device: str | torch.device = "cuda") -> EvalBatch:
    dev = resolve_device(device)
    t_width = max(1, int(split.truth.lengths().max(initial=0)))
    m_width = max(1, int(split.train_mask.lengths().max(initial=0)))
    return EvalBatch(
        user_ids=torch.from_numpy(np.asarray(split.user_ids, np.int64)).to(dev),
        truth=torch.from_numpy(_pad_csr(split.truth.indptr, split.truth.values, t_width)).to(dev),
        mask=torch.from_numpy(
            _pad_csr(split.train_mask.indptr, split.train_mask.values, m_width)
        ).to(dev),
    )


def _csr_take(csr: CsrList, rows: np.ndarray) -> CsrList:
    lens = np.diff(csr.indptr)[rows]
    take = np.repeat(csr.indptr[rows], lens) + (
        np.arange(int(lens.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(np.append(0, lens[:-1])), lens)
    )
    return CsrList(np.append(0, np.cumsum(lens)), csr.values[take])


def build_eval_buckets(
    split: EvalSplit, width_floor: int = 64, device: str | torch.device = "cuda"
) -> list[EvalBatch]:
    """One :class:`EvalBatch` per power-of-two mask width (at least
    ``width_floor``), so padding stays under 2x the mask entries."""
    ml = split.train_mask.lengths()
    if len(ml) == 0:
        return [build_eval_batch(split, device)]
    bucket_w = np.power(2, np.ceil(np.log2(np.maximum(ml, width_floor)))).astype(np.int64)
    batches = []
    for w in np.unique(bucket_w):
        sel = np.flatnonzero(bucket_w == w)
        sub = EvalSplit(
            user_ids=split.user_ids[sel],
            truth=_csr_take(split.truth, sel),
            train_mask=_csr_take(split.train_mask, sel),
        )
        batches.append(build_eval_batch(sub, device))
    return batches


def evaluate(
    final_emb: torch.Tensor,
    batch: EvalBatch,
    n_users: int,
    k: int = 20,
    user_tile: int = 1024,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
    topk_impl: str = "exact",
):
    """Recall/Precision@K over an eval batch from the propagated
    [n_users + n_items, D] embedding. Returns (precision, recall,
    per_user_recall, per_user_precision, topk_idx), the last three as
    numpy."""
    item_emb = final_emb[n_users:]
    idx_parts, rec_parts, prec_parts = [], [], []
    for lo in range(0, batch.num_users, user_tile):
        hi = min(lo + user_tile, batch.num_users)
        _, idx = topk_scores(
            final_emb.index_select(0, batch.user_ids[lo:hi]), item_emb,
            batch.mask[lo:hi], k, item_tile, mask_mode, topk_impl,
        )
        recall, precision = recall_precision_at_k(idx, batch.truth[lo:hi], k)
        idx_parts.append(idx)
        rec_parts.append(recall)
        prec_parts.append(precision)
    if not idx_parts:
        empty = np.zeros(0, np.float32)
        return 0.0, 0.0, empty, empty, np.zeros((0, k), np.int32)
    recall, precision = torch.cat(rec_parts), torch.cat(prec_parts)
    return (
        float(precision.mean()),
        float(recall.mean()),
        recall.cpu().numpy(),
        precision.cpu().numpy(),
        torch.cat(idx_parts).cpu().numpy(),
    )


def evaluate_bucketed(
    final_emb: torch.Tensor,
    buckets: list[EvalBatch],
    n_users: int,
    k: int = 20,
    user_tile: int = 1024,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
    topk_impl: str = "exact",
) -> tuple[float, float]:
    """Mean (precision, recall) over a bucketed split, user-weighted."""
    tot_p = tot_r = 0.0
    tot_n = 0
    for batch in buckets:
        p, r, _, _, _ = evaluate(
            final_emb, batch, n_users, k, user_tile, item_tile, mask_mode, topk_impl
        )
        tot_p += p * batch.num_users
        tot_r += r * batch.num_users
        tot_n += batch.num_users
    return tot_p / max(tot_n, 1), tot_r / max(tot_n, 1)


def recommend_users(
    final_emb: torch.Tensor,
    user_ids,
    mask_idx,
    n_users: int,
    k: int = 20,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
) -> np.ndarray:
    """Top-K local item ids [B, k] for ``user_ids`` from the propagated
    [n_users + n_items, D] embedding, excluding ``mask_idx`` [B, M]."""
    dev = final_emb.device
    ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int64, device=dev)
    mask = torch.as_tensor(np.asarray(mask_idx), device=dev)
    _, idx = topk_scores(
        final_emb.index_select(0, ids), final_emb[n_users:], mask, k, item_tile, mask_mode
    )
    return idx.cpu().numpy()
