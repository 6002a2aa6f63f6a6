"""Model-free ranking baselines over a :class:`PreparedData` split.

Counterpart of ``gnn_ecommerce_tpu/eval/baselines.py``: the
global-popularity recommender, the bar a collaborative model must clear on
any corpus.
"""
from __future__ import annotations

import numpy as np

from ..data.prepare import EvalSplit, PreparedData


def popularity_recall_at_k(
    prepared: PreparedData, split: EvalSplit | None = None, k: int = 20
) -> float:
    """Mean Recall@k of the global train-purchase-popularity top-k list,
    with each user's train-purchased items removed (the model eval's
    masking). Defaults to the val split."""
    if split is None:
        split = prepared.val
    s = prepared.sampler
    pop = np.bincount(
        s.pos_flat - prepared.n_users, minlength=prepared.n_items
    ).astype(np.float64)
    recs = []
    for r in range(len(split.user_ids)):
        sc = pop
        m = split.train_mask.row(r)
        if len(m):
            sc = pop.copy()
            sc[m] = -np.inf
        top = np.argpartition(sc, -k)[-k:]
        t = split.truth.row(r)
        recs.append(len(np.intersect1d(top, t)) / max(1, len(t)))
    return float(np.mean(recs)) if recs else 0.0
