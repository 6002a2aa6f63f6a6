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
