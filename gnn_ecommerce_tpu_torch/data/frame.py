"""A table of numpy columns that writes the CSV bytes of pandas'
``DataFrame.to_csv(index=False)``.

The JAX package returns pandas frames from ``eval/metrics.py:mark_frame``
and ``explain/paths.py:hit_paths_frame`` and writes them with ``to_csv``.
The port returns a :class:`Frame` under the same column names and writes
the same bytes with the ``csv`` module:

- numeric columns as numpy prints them (``astype(str)``: a float32 as its
  shortest float32 decimal, ``0.33333334``), booleans as ``True``/``False``;
- object cells as ``str(cell)`` (a list as ``[a, b, c]``), ``None`` as an
  empty field;
- a field with a comma, a quote or a line break quoted, quotes doubled;
  ``\\n`` ends each line.
"""
from __future__ import annotations

import csv

import numpy as np

# pandas' default ``na_values``: fields read as missing.
NA_VALUES = (
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
)
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


class Frame:
    """Equal-length columns by name, in order."""

    def __init__(self, columns: dict):
        self._cols = {name: _as_column(values) for name, values in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
            writer.writerow(self.columns)
            writer.writerows(zip(*(_cells(col) for col in self._cols.values())))


def _as_column(values) -> np.ndarray:
    """A numpy column; a list of lists (or of None) becomes an object array
    of those lists, one per row."""
    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    if any(v is None or isinstance(v, (list, tuple)) for v in values):
        col = np.empty(len(values), dtype=object)
        for row, value in enumerate(values):  # one list per cell, never a 2-D fill
            col[row] = value
        return col
    return np.asarray(values)


def _cells(col: np.ndarray) -> list:
    if col.dtype != object:
        return col.astype(str).tolist()
    return ["" if cell is None else str(cell) for cell in col]


def read_frame(path: str) -> Frame:
    """Every column of a CSV with a header, typed as pandas' ``read_csv``
    types it: int64, or float64 where a numeric column has a missing field
    (pandas' ``na_values``, NaN), bool for True/False columns with none
    missing, else strings (a numpy ``str`` column, or an object column with
    ``None`` where a field is missing)."""
    from .events import read_csv

    return Frame({name: _pandas_column(col) for name, col in read_csv(path).items()})


def _pandas_column(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind != "U":
        return col
    na = np.isin(col, NA_VALUES)
    rest = col[~na]
    try:
        values = rest.astype(np.float64)
    except ValueError:
        values = None
    if values is not None:
        out = np.full(len(col), np.nan)
        out[~na] = values
        return out
    if not na.any():
        return np.isin(col, _TRUE) if np.isin(rest, _TRUE + _FALSE).all() else col
    out = np.empty(len(col), dtype=object)
    out[:] = col.tolist()
    out[na] = None
    return out
