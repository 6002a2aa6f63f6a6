"""MovieLens loader (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/movielens.py:load_movielens``: maps
a MovieLens rating log onto the weighted-edge schema, ratings >=
``positive_threshold`` to weight 1.0 (the positive class) and lower ratings
to ``rating/5 * 0.5``. ML-100K ``u.data`` is tab-separated ``user_id
item_id rating timestamp``; the same parser takes ML-1M ``ratings.dat``
(``::``-separated) and CSVs with the same first three columns, with or
without a header.
"""
from __future__ import annotations

import io

import numpy as np

from .events import Edges


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
