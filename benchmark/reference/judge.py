"""The numbers that decide ``correct``: each a gap between what the program
produced and what the reference works out from the same inputs.

- ``norm_gap``: the gap between two norms, as a share of the reference's.
- ``diff_gap``: the norm of the difference of two tensors, as a share of
  the reference's norm.
- ``row_gap``: the worst row of an embedding, ``‖e_r - ref_r‖`` over the
  larger of ``‖ref_r‖`` and the median row norm.
- ``score_gap``: for each served row of top-K items, how far the worst
  served item's reference score lies below the reference's K-th best,
  over the spread (standard deviation) of that user's allowed scores; a
  row that is not K distinct, allowed, in-range items is a bad answer.
- ``bad_triples``: BPR triples whose user has no purchase, whose positive
  is not one of the user's purchases, or whose negative is one of them or
  not an item.
- ``sampler_z``: whether the triples are drawn as BPR draws them, in
  standard errors (below).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .lightgcn import top_k

ROWS_PER_BLOCK = 2048


def norm_gap(program: float, reference: float) -> float:
    if reference == 0:
        return 0.0 if program == 0 else float("inf")
    return abs(program - reference) / abs(reference)


def diff_gap(x: torch.Tensor, ref: torch.Tensor, block: int = 1 << 18) -> float:
    """``‖x - ref‖ / ‖ref‖`` (f64 sums, in blocks of rows; ``x`` is moved to
    ``ref``'s device a block at a time)."""
    num = den = 0.0
    for s in range(0, ref.shape[0], block):
        r = ref[s:s + block].double()
        num += float((x[s:s + block].to(ref.device).double() - r).pow(2).sum())
        den += float(r.pow(2).sum())
    if den == 0:
        return 0.0 if num == 0 else float("inf")
    return (num / den) ** 0.5


def row_gap(emb: torch.Tensor, ref: torch.Tensor, block: int = 1 << 18) -> float:
    """Worst row of ``emb`` against ``ref`` (both [N, D]), in blocks."""
    norms = torch.cat([ref[s:s + block].float().norm(dim=1) for s in range(0, ref.shape[0], block)])
    floor = norms.median()
    worst = 0.0
    for s in range(0, ref.shape[0], block):
        d = (emb[s:s + block].to(ref.device).float() - ref[s:s + block].float()).norm(dim=1)
        worst = max(worst, float((d / torch.maximum(norms[s:s + block], floor)).max()))
    return worst


def score_gap(final: torch.Tensor, n_users: int, users: np.ndarray, served: np.ndarray,
              purchases, k: int) -> tuple[float, int]:
    """(widest gap, bad rows) of ``served`` [R, k] local item ids for
    ``users`` [R] against the reference's ``final`` embedding."""
    n_items = final.shape[0] - n_users
    widest, bad = 0.0, 0
    for s in range(0, len(users), ROWS_PER_BLOCK):
        ids, rows = users[s:s + ROWS_PER_BLOCK], served[s:s + ROWS_PER_BLOCK]
        scores, vals, _ = top_k(final, n_users, ids, purchases, k)
        kth = vals[:, -1]
        ok = np.array([len(set(r.tolist())) == k and r.min() >= 0 and r.max() < n_items for r in rows])
        r_t = torch.as_tensor(np.where(ok[:, None], rows, 0), dtype=torch.int64, device=final.device)
        got = scores.gather(1, r_t)
        allowed = torch.isfinite(scores)
        mean = torch.where(allowed, scores, 0).sum(1) / allowed.sum(1)
        var = torch.where(allowed, (scores - mean[:, None]) ** 2, 0).sum(1) / allowed.sum(1)
        gap = (kth - got.min(dim=1).values).clamp(min=0) / var.sqrt()
        ok_t = torch.as_tensor(ok, device=final.device) & torch.isfinite(gap)
        bad += int((~ok_t).sum())
        if bool(ok_t.any()):
            widest = max(widest, float(gap[ok_t].max()))
    return widest, bad


def bad_triples(users, pos, neg, purchases, n_users: int, n_items: int) -> int:
    """Count of invalid BPR triples (node-space ids, numpy)."""
    indptr, items = purchases
    users, pos, neg = (np.asarray(a, np.int64) for a in (users, pos, neg))
    lo, hi = indptr[users], indptr[users + 1]

    def bought(item_local):
        # Binary search of each item in its user's ascending purchase row.
        at = np.array([lo[k] + np.searchsorted(items[lo[k]:hi[k]], item_local[k]) for k in range(len(users))])
        return (at < hi) & (items[np.minimum(at, len(items) - 1)] == item_local)

    in_range = lambda x: (x >= n_users) & (x < n_users + n_items)
    bad = (hi == lo) | ~in_range(pos) | ~in_range(neg)
    bad |= ~bought(pos - n_users) | bought(neg - n_users)
    return int(bad.sum())


def sampler_z(users, pos, neg, purchases, n_users: int, n_items: int) -> float:
    """The largest |z| of three means over the triples (node-space ids)
    against BPR's sampling: the user uniform over those with a purchase, the
    positive uniform over the user's purchases, the negative uniform over
    the items the user has not bought. The statistics are log(1 + purchase
    count) of the user, of the positive and of the negative; each mean's
    expectation and variance over one draw are worked out from the
    purchases, and z is the sample mean's distance from the expectation in
    standard errors. Ids out of range are clipped (``bad_triples`` counts
    them)."""
    indptr, items = purchases
    deg = np.diff(indptr)
    buyers = np.flatnonzero(deg)
    d = deg[buyers].astype(np.float64)
    f_user = np.log1p(deg.astype(np.float64))
    f_item = np.log1p(np.bincount(items, minlength=n_items).astype(np.float64))
    row = np.repeat(np.arange(n_users), deg)
    s1 = np.bincount(row, weights=f_item[items], minlength=n_users)[buyers]
    s2 = np.bincount(row, weights=f_item[items] ** 2, minlength=n_users)[buyers]
    rest = np.maximum(n_items - d, 1.0)
    expected = {  # (E f, E f^2) of one draw
        "user": (f_user[buyers].mean(), (f_user[buyers] ** 2).mean()),
        "pos": ((s1 / d).mean(), (s2 / d).mean()),
        "neg": (((f_item.sum() - s1) / rest).mean(), (((f_item ** 2).sum() - s2) / rest).mean()),
    }
    local = lambda x: np.clip(np.asarray(x, np.int64) - n_users, 0, n_items - 1)
    drawn = {"user": f_user[np.clip(np.asarray(users, np.int64), 0, n_users - 1)],
             "pos": f_item[local(pos)], "neg": f_item[local(neg)]}
    worst = 0.0
    for k, (m1, m2) in expected.items():
        diff = abs(float(drawn[k].mean()) - m1)
        se = math.sqrt(max(m2 - m1 * m1, 0.0) / len(drawn[k]))
        worst = max(worst, diff / se if se > 0 else (0.0 if diff < 1e-12 else math.inf))
    return float(worst)
