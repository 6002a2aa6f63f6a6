"""Event-log → weighted-edge pipeline (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/events.py``: the same weight maps,
the same aggregation and the same results, bit for bit, with the pandas
frames replaced by :class:`Events` and :class:`Edges` (numpy columns under
the frames' column names).

1. map each event to its type weight;
2. sum weights per (user, item), in event order; a sum below the ``view``
   weight clamps to the ``view`` weight;
3. track whether the pair ever had a ``purchase`` event;
4. cap: sum > 1 and purchased → 1.0; sum > 1 and not purchased → 0.5.

As in the reference, "positive" downstream means weight == 1.0 exactly, so
a purchased pair whose sum lands below 1.0 (purchase + remove_from_cart)
is not a positive for sampling or eval.
"""
from __future__ import annotations

import csv
import dataclasses
import warnings

import numpy as np

EVENT_TYPE_WEIGHTS_V1 = {"view": 0.01, "cart": 0.1, "remove_from_cart": -0.09, "purchase": 1.0}
EVENT_TYPE_WEIGHTS_V2 = {"view": 0.15, "cart": 0.35, "remove_from_cart": -0.2, "purchase": 1.0}
# The categories of the synthetic generator's event-type codes.
EVENT_TYPES = ("view", "cart", "remove_from_cart", "purchase")


@dataclasses.dataclass(frozen=True)
class Events:
    """An event log. ``event_type`` is either integer codes into
    :data:`EVENT_TYPES` or an array of type names (``str``)."""

    user_id: np.ndarray
    item_id: np.ndarray
    event_type: np.ndarray

    def __len__(self) -> int:
        return len(self.user_id)

    def type_names(self) -> np.ndarray:
        """``event_type`` as names (codes looked up in :data:`EVENT_TYPES`)."""
        if self.event_type.dtype.kind in "iu":
            return np.asarray(EVENT_TYPES)[self.event_type]
        return self.event_type

    def is_type(self, name: str) -> np.ndarray:
        """Boolean mask of the events of type ``name``."""
        if self.event_type.dtype.kind in "iu":
            return self.event_type == EVENT_TYPES.index(name)
        return self.event_type == name

    def to_csv(self, path: str) -> None:
        """Write ``user_id,item_id,event_type`` with a header, as
        ``DataFrame.to_csv(index=False)`` writes the JAX package's frame."""
        write_csv(path, {
            "user_id": self.user_id, "item_id": self.item_id,
            "event_type": self.type_names(),
        })


@dataclasses.dataclass(frozen=True)
class Edges:
    """Weighted (user, item) edges in original id space."""

    user_id: np.ndarray
    item_id: np.ndarray
    weight: np.ndarray

    def __len__(self) -> int:
        return len(self.user_id)

    def take(self, rows: np.ndarray) -> "Edges":
        """The rows ``rows`` (indices or a boolean mask), in that order."""
        return Edges(self.user_id[rows], self.item_id[rows], self.weight[rows])

    def to_csv(self, path: str) -> None:
        """Write ``user_id,item_id,weight`` with a header; each weight as its
        shortest decimal that reads back to the same float64."""
        write_csv(path, {"user_id": self.user_id, "item_id": self.item_id, "weight": self.weight})


@dataclasses.dataclass(frozen=True)
class RawEdges(Edges):
    """:func:`raw_edge_weight`'s output: edges plus whether each pair was
    ever purchased."""

    purchased: np.ndarray


def write_csv(path: str, columns: dict) -> None:
    """A header line, then one line per row of the equal-length ``columns``.
    numpy's ``str`` of a float64 is its shortest round-trip decimal."""
    text = None
    for col in columns.values():
        s = np.asarray(col).astype(str)
        text = s if text is None else np.char.add(np.char.add(text, ","), s)
    with open(path, "w") as f:
        f.write(",".join(columns) + "\n")
        if text is not None and len(text):
            f.write("\n".join(text.tolist()))
            f.write("\n")


def read_csv(path: str) -> dict:
    """Every column of a CSV with a header, by name. Integer columns come
    back as int64, other numeric columns as float64, the rest as ``str``.
    A row with the wrong number of fields raises ``ValueError``; blank
    lines are skipped.

    A file whose first row is all numbers is parsed by ``np.loadtxt`` in one
    pass; any row that does not fit the first row's types (and any other
    file) is read again through the ``csv`` module, with the same result."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        first = next((row for row in reader if row), None)
    if header is None:
        return {}
    names = [name.strip() for name in header]
    if first is not None:
        cols = _read_numeric(path, names, first)
        if cols is not None:
            return cols
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        rows = []
        for line, row in enumerate(reader, start=2):
            if not row:
                continue
            if len(row) != len(header):
                raise ValueError(f"{path}:{line}: {len(row)} fields, header has {len(header)}")
            rows.append(row)
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {name: _column(values) for name, values in zip(names, cols)}


def _read_numeric(path: str, names: list, first: list) -> dict | None:
    """The columns parsed by ``np.loadtxt`` with the types of the row
    ``first``, or None where that parse could differ from ``_column``'s:
    a non-numeric or missing field, a row that fits other types, an int64
    at its lower limit (``loadtxt`` wraps the one past the upper limit)."""
    if len(first) != len(names) or len(set(names)) != len(names) or "" in names:
        return None
    kinds = [_column([value]).dtype for value in first]
    if any(k.kind not in "if" for k in kinds):
        return None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # loadtxt's "integer via a float" is a warning
            table = np.loadtxt(
                path, delimiter=",", skiprows=1, dtype=list(zip(names, kinds)),
                quotechar='"', comments=None, ndmin=1,
            )
    except (ValueError, Warning):
        return None
    cols = {name: np.ascontiguousarray(table[name]) for name in names}
    low = np.iinfo(np.int64).min
    if any(k.kind == "i" and (cols[n] == low).any() for n, k in zip(names, kinds)):
        return None
    return cols


def _column(values) -> np.ndarray:
    text = np.asarray(values, dtype=str)
    for dtype in (np.int64, np.float64):
        try:
            return text.astype(dtype)
        except (ValueError, OverflowError):
            pass
    return text


def _type_weights(events: Events, type_weights: dict) -> np.ndarray:
    """Per-event weight (float64); an event type missing from the map raises
    ``ValueError``."""
    et = events.event_type
    if et.dtype.kind in "iu":
        lut = np.array([type_weights.get(t, np.nan) for t in EVENT_TYPES], np.float64)
        weights = lut[et]
    else:
        weights = np.full(len(et), np.nan)
        for name, w in type_weights.items():
            weights[et == name] = w
    bad = np.isnan(weights)
    if bad.any():
        unknown = sorted({str(t) for t in events.type_names()[bad]})
        raise ValueError(f"unknown event types: {unknown}")
    return weights


def raw_edge_weight(events: Events, type_weights: dict) -> RawEdges:
    """Aggregate events into raw per-(user, item) edge weights, sorted by
    (user, item), with the ``view`` clamp applied."""
    view = type_weights["view"]
    weights = _type_weights(events, type_weights)
    purchased = events.is_type("purchase")

    # Sorted unique ids and codes (pandas' factorize(sort=True)), then the
    # native counting-sort groupby (numpy lexsort fallback inside).
    from ..native import groupby_edges

    u_uniques, u_codes = np.unique(events.user_id, return_inverse=True)
    i_uniques, i_codes = np.unique(events.item_id, return_inverse=True)
    gu, gi, gw, gp = groupby_edges(
        u_codes, i_codes, weights, purchased.astype(np.uint8), len(u_uniques), len(i_uniques)
    )
    gw[gw < view] = view
    return RawEdges(u_uniques[gu], i_uniques[gi], gw, gp.astype(bool))


def proper_edge_weight(raw: RawEdges) -> Edges:
    """Cap over-1 weights (purchased → 1.0, else 0.5); drop the purchased flag."""
    w = raw.weight.copy()
    over = w > 1.0
    w[over & raw.purchased] = 1.0
    w[over & ~raw.purchased] = 0.5
    return Edges(raw.user_id, raw.item_id, w)


def events_to_edges(events: Events, type_weights: dict) -> Edges:
    """Full pipeline: events → capped (user, item, weight) edges."""
    return proper_edge_weight(raw_edge_weight(events, type_weights))
