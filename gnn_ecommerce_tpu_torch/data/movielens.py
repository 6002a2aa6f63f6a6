"""MovieLens loader (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/movielens.py:load_movielens``: maps
a MovieLens rating log onto the weighted-edge schema, ratings >=
``positive_threshold`` to weight 1.0 (the positive class) and lower ratings
to ``rating/5 * 0.5``. ML-100K ``u.data`` is tab-separated ``user_id
item_id rating timestamp``; the same parser takes ML-1M ``ratings.dat``
(``::``-separated) and CSVs with the same first three columns, with or
without a header. :func:`synthetic_movielens` makes the JAX package's
ML-100K-shaped stand-in, value for value.
"""
from __future__ import annotations

import io

import numpy as np

from .events import Edges
from .frame import Frame


def load_movielens(path: str, positive_threshold: int = 4) -> Edges:
    """Return edges (user_id, item_id, weight) from a MovieLens ratings file."""
    with open(path, "rb") as f:
        text = f.read().decode(errors="replace")
    head = text.split("\n", 1)[0]
    sep = "::" if "::" in head else ("\t" if "\t" in head else ",")
    # Header if the first field isn't numeric (applies to every separator).
    header = 1 if any(c.isalpha() for c in head.split(sep)[0]) else 0
    if sep == "::":
        text, sep = text.replace("::", "\t"), "\t"
    cols = np.loadtxt(
        io.StringIO(text), delimiter=sep, skiprows=header, usecols=(0, 1, 2), ndmin=1,
        dtype=[("user_id", np.int64), ("item_id", np.int64), ("rating", np.float64)],
    )
    rating = cols["rating"]
    weight = np.where(rating >= positive_threshold, 1.0, rating / 5.0 * 0.5)
    return Edges(cols["user_id"], cols["item_id"], weight.astype(np.float32))


def synthetic_movielens(
    n_users: int = 943,
    n_items: int = 1682,
    n_ratings: int = 100_000,
    n_factors: int = 8,
    seed: int = 42,
) -> Frame:
    """SYNTHETIC ML-100K-shaped ratings (not the real MovieLens data), the
    JAX package's ``synthetic_movielens`` draw for draw: 943 users x 1682
    movies x ~100K integer ratings 1-5, every user >= 20 ratings, long-tail
    item popularity, ratings from a biased low-rank model
    ``clip(round(mu + b_u + b_i + p_u.q_i + eps))``. Columns: user_id,
    item_id, rating (1-based ids, like ``u.data``)."""
    rng = np.random.default_rng(seed)
    b_u = rng.normal(0.0, 0.35, n_users)
    b_i = rng.normal(0.0, 0.5, n_items)
    p = rng.normal(0.0, 1.0, (n_users, n_factors)) / np.sqrt(n_factors)
    q = rng.normal(0.0, 1.0, (n_items, n_factors)) / np.sqrt(n_factors)
    # User activity: lognormal, floored at 20 ratings, scaled toward the
    # target total (the floor and the cap distort one scaling).
    deg = np.maximum(20, rng.lognormal(3.4, 1.0, n_users)).astype(np.int64)
    deg = np.minimum(deg, n_items)
    for _ in range(30):
        if abs(int(deg.sum()) - n_ratings) <= n_users:
            break
        deg = np.clip((deg * (n_ratings / deg.sum())).astype(np.int64), 20, n_items)
    # Item popularity: zipf-like over a shuffled rank order.
    ranks = rng.permutation(n_items) + 1
    pop = ranks ** -0.8
    pop /= pop.sum()
    users_l, items_l = [], []
    for u in range(n_users):
        chosen = rng.choice(n_items, size=int(deg[u]), replace=False, p=pop)
        users_l.append(np.full(len(chosen), u, np.int64))
        items_l.append(chosen.astype(np.int64))
    users = np.concatenate(users_l)
    items = np.concatenate(items_l)
    if len(users) > n_ratings:
        # Drop the surplus only past each user's first 20 ratings.
        if n_ratings < 20 * n_users:
            raise ValueError(
                f"n_ratings={n_ratings} < 20*n_users={20 * n_users}: the "
                ">=20-ratings-per-user floor makes this target unreachable"
            )
        first20 = np.zeros(len(users), bool)
        starts = np.append(0, np.cumsum(deg[:-1]))
        first20[(starts[:, None] + np.arange(20)).ravel()] = True
        droppable = np.flatnonzero(~first20)
        drop = rng.permutation(droppable)[: len(users) - n_ratings]
        keep = np.ones(len(users), bool)
        keep[drop] = False
        users, items = users[keep], items[keep]
    mu = 3.55
    raw = (
        mu + b_u[users] + b_i[items]
        + np.einsum("ij,ij->i", p[users], q[items])
        + rng.normal(0.0, 0.6, len(users))
    )
    rating = np.clip(np.rint(raw), 1, 5).astype(np.int64)
    return Frame({"user_id": users + 1, "item_id": items + 1, "rating": rating})
