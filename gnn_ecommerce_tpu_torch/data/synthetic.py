"""Synthetic e-commerce event generator (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/synthetic.py``: the same draws, in
the same order, from the same ``np.random.default_rng(seed)``, so that any
arguments give the JAX package's ids and type codes exactly. The event log
has the schema and distributional shape of the Kaggle cosmetics-shop
dataset the reference trains on (20.7M events, 1.64M users × 54.6K items,
~6.2% purchases, heavy power-law skew in user activity and item
popularity).
"""
from __future__ import annotations

import numpy as np

from .events import EVENT_TYPES, Events

# Event mix approximating the reference EDA (0.eda.ipynb cell 21: 6.22%
# purchases; views dominate), keyed in EVENT_TYPES order: a type's code is
# its position here.
EVENT_PROBS = dict(zip(EVENT_TYPES, (0.80, 0.09, 0.047, 0.063)))


def _zipf_choice(rng: np.random.Generator, n: int, size: int, a: float) -> np.ndarray:
    """Draw ids in [0, n) with a Zipf-like popularity profile."""
    # Inverse-CDF sampling over ranks with weight rank^-a.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(n, size=size, p=probs)


def synthetic_events(
    n_users: int = 2000,
    n_items: int = 300,
    n_events: int = 20000,
    seed: int = 0,
    user_skew: float = 0.8,
    item_skew: float = 1.0,
    n_clusters: int = 0,
    affinity: float = 0.7,
    n_pairs: int | None = None,
) -> Events:
    """Generate an event log ``Events(user_id, item_id, event_type)``, the
    type as int8 codes into ``EVENT_TYPES``.

    User/item ids are drawn with power-law skew, then users are mapped through
    a random permutation of a sparse original-id space so that relabelling
    (LabelEncoder semantics) is actually exercised.

    ``n_clusters > 0`` adds LEARNABLE latent structure (a planted co-cluster
    model): users and items are assigned to latent interest clusters and each
    event's item is drawn from the user's own cluster with probability
    ``affinity`` (with the same within-cluster popularity skew), otherwise
    from the global popularity distribution. A collaborative-filtering model
    can then genuinely beat the popularity baseline on held-out purchases —
    the pure popularity draw (``n_clusters=0``) has no user-specific signal
    to learn, so Recall@K curves on it only measure popularity recovery.

    ``n_pairs`` pins the number of UNIQUE (user, item) pairs: real shoppers
    hit the same pair repeatedly (the reference's 20.7M events collapse to
    10.16M unique edges, preprocessing nb cell 15), while independent draws
    barely collide. Two stages: draw a pair universe of exactly ``n_pairs``
    pairs (with the skew/cluster structure above), emit each pair once, then
    draw the remaining events over the universe with rank skew — unique edge
    count is exact and multiplicity is power-law like the real log.
    """
    rng = np.random.default_rng(seed)
    n_draw = n_events if n_pairs is None else int(n_pairs * 1.6)
    users = _zipf_choice(rng, n_users, n_draw, user_skew)
    items = _zipf_choice(rng, n_items, n_draw, item_skew)
    if n_clusters > 0:
        user_cluster = rng.integers(0, n_clusters, n_users)
        item_cluster = rng.integers(0, n_clusters, n_items)
        # Within each cluster, keep the global popularity ORDER (item id =
        # popularity rank for the zipf draw above) so in-cluster draws stay
        # power-law skewed: cluster_items[c] lists that cluster's items in
        # ascending id = descending popularity.
        order = np.argsort(item_cluster, kind="stable")  # ids ascend per cluster
        cluster_sorted = order  # item ids grouped by cluster, popularity-ranked
        cluster_start = np.searchsorted(item_cluster[order], np.arange(n_clusters + 1))
        in_cluster = rng.random(n_draw) < affinity
        ev_cluster = user_cluster[users[in_cluster]]
        size = cluster_start[ev_cluster + 1] - cluster_start[ev_cluster]
        # Guard empty clusters (tiny n_items): fall back to the global draw.
        ok = size > 0
        # Zipf-ranked within-cluster draw via inverse-CDF on a unit sample:
        # P(rank r of n) ∝ (r+1)^-item_skew approximated by u^(1/(1-a))-style
        # power transform; use rejection-free rank = floor(n * u^gamma) with
        # gamma tuned to the same skew (cheap, monotone in popularity).
        gamma = 1.0 + item_skew  # heavier gamma -> more mass on top ranks
        u01 = rng.random(int(ok.sum()))
        ranks = np.minimum(
            (size[ok] * u01**gamma).astype(np.int64), size[ok] - 1
        )
        picked = cluster_sorted[cluster_start[ev_cluster[ok]] + ranks]
        idx = np.flatnonzero(in_cluster)[ok]
        items[idx] = picked
    if n_pairs is not None:
        # Stage 1: deduplicate the draws into the pair universe (exactly
        # n_pairs pairs; over-draw above makes a shortfall all but
        # impossible, and any shortfall just yields fewer pairs).
        shift = max(1, int(n_items - 1).bit_length())
        key = users.astype(np.int64) * (1 << shift) + items
        key = np.unique(key)
        rng.shuffle(key)
        key = key[:n_pairs]
        # Stage 2: every pair appears once; the remaining events are drawn
        # over the universe with rank skew (floor(P * u^gamma) concentrates
        # multiplicity on a power-law head like real repeat behavior).
        n_extra = max(0, n_events - len(key))
        extra = np.minimum(
            (len(key) * rng.random(n_extra) ** 3.0).astype(np.int64), len(key) - 1
        )
        key = np.concatenate([key, key[extra]])
        users, items = key >> shift, key & ((1 << shift) - 1)
        users, items = users.astype(np.int64), items.astype(np.int64)
    # Draw type codes: at cosmetics scale (20.7M events) an array of type
    # names would cost about 1.3 GB; int8 codes into EVENT_TYPES do not.
    type_codes = rng.choice(
        len(EVENT_PROBS), size=len(users), p=np.array(list(EVENT_PROBS.values()))
    ).astype(np.int8)
    # Sparse, shuffled original ids (like real user_id/product_id columns).
    user_vocab = rng.permutation(n_users * 7)[:n_users]
    item_vocab = rng.permutation(n_items * 5)[:n_items]
    return Events(user_id=user_vocab[users], item_id=item_vocab[items], event_type=type_codes)
