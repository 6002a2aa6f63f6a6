"""Data-parallel evaluation: eval users split over the ranks of a mesh.

Counterpart of ``gnn_ecommerce_tpu/parallel/sharded_eval.py``. The final
embedding is replicated; each rank takes one contiguous slice of the
(padded) eval users, runs the port's exact top-K (``ops/topk_score.py``)
and metrics on it, and only per-user results travel: scalar sums
(:func:`make_sharded_eval_fn`) or the per-user vectors, padded to one length
(:func:`sharded_evaluate`). Padded users have all-``-1`` truth rows, so they
add exactly 0 to every sum and are cut off every vector.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.evaluate import EvalBatch
from ..eval.metrics import recall_precision_at_k
from ..ops.topk_score import topk_scores
from .distributed import all_gather_rows, all_reduce_sum
from .mesh import Mesh


def _my_slice(batch: EvalBatch, n_shards: int, shard: int):
    """This shard's rows of the batch's real users padded to a multiple of
    ``n_shards``: (user ids, truth, mask); padded users are user 0 with
    ``-1`` rows."""
    nu = batch.num_users
    pad = (-nu) % n_shards
    per = (nu + pad) // n_shards
    uids = F.pad(batch.user_ids[:nu], (0, pad))
    truth = F.pad(batch.truth[:nu], (0, 0, 0, pad), value=-1)
    mask = F.pad(batch.mask[:nu], (0, 0, 0, pad), value=-1)
    rows = slice(shard * per, (shard + 1) * per)
    return uids[rows], truth[rows], mask[rows]


def _local_eval(emb, uids, truth, mask, n_users, k, item_tile, mask_mode):
    _, idx = topk_scores(emb.index_select(0, uids), emb[n_users:], mask, k, item_tile, mask_mode)
    recall, precision = recall_precision_at_k(idx, truth, k)
    return idx, recall, precision


def make_sharded_eval_fn(
    mesh: Mesh,
    n_users: int,
    k: int = 20,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
):
    """``eval_buckets(final_emb, buckets) -> (precision, recall)``, the
    user-weighted means of ``eval.evaluate.evaluate_bucketed``, with each
    bucket's users split over every rank of the mesh. Per bucket one
    all-reduce adds the ranks' recall and precision sums (f64)."""
    S, r = mesh.size, mesh.rank

    def eval_buckets(final_emb: torch.Tensor, buckets) -> tuple[float, float]:
        sums = torch.zeros(2, dtype=torch.float64, device=final_emb.device)
        tot_n = 0
        for b in buckets:
            _, recall, precision = _local_eval(
                final_emb, *_my_slice(b, S, r), n_users, k, item_tile, mask_mode
            )
            sums += torch.stack([recall.double().sum(), precision.double().sum()])
            tot_n += b.num_users
        tot_r, tot_p = all_reduce_sum(sums, mesh).tolist()
        return tot_p / max(tot_n, 1), tot_r / max(tot_n, 1)

    return eval_buckets


def sharded_evaluate(
    final_emb: torch.Tensor,
    batch: EvalBatch,
    n_users: int,
    mesh: Mesh,
    k: int = 20,
    item_tile: int = 8192,
    mask_mode: str = "neginf",
    axis: str = "data",
):
    """``eval.evaluate.evaluate``'s tuple (precision, recall, per-user
    recall, per-user precision, top-K ids) with users split over ``axis``:
    each rank scores its slice, and one all-gather per vector, over the
    ranks of its ``axis`` group, brings every user's results to every rank."""
    nu = batch.num_users
    if nu == 0:
        empty = np.zeros(0, np.float32)
        return 0.0, 0.0, empty, empty, np.zeros((0, k), np.int32)
    idx, recall, precision = _local_eval(
        final_emb, *_my_slice(batch, mesh.shape[axis], mesh.index(axis)),
        n_users, k, item_tile, mask_mode,
    )
    idx = all_gather_rows(idx, mesh, axis)[:nu]
    recall = all_gather_rows(recall, mesh, axis)[:nu]
    precision = all_gather_rows(precision, mesh, axis)[:nu]
    return (
        float(precision.mean()),
        float(recall.mean()),
        recall.cpu().numpy(),
        precision.cpu().numpy(),
        idx.cpu().numpy(),
    )
