"""The floors of DGCF's work (``models/dgcf.py``), beside ``peaks.py``'s
(whose rates they use) and counted the same way: the logical work, each
input read once and each output written once, whatever the program runs.

- :func:`intent_gather_floor_s`: the routed products of one step's forward,
  from the program's counter ``train.dgcf.routed_arcs`` (arcs × intents,
  every iteration): each product reads each arc's tail id (int32) and its K
  f32 weights once, each f32 row that an arc reads once, writes each f32
  output row once, and does ``2·d`` f32 operations an arc (``d / K`` columns
  for each of its K weights).
- :func:`dgcf_step_floor_s`: one DGCF step's model work: L·T routed
  products and L·T − 1 score updates (the last is skipped) forward, each
  ``2·arcs·d`` f32 operations, and twice that backward; the table, Adam's
  two moments and the arcs' head and tail ids read once, the table and the
  moments written once.
"""
from __future__ import annotations

from benchmark import peaks


def intent_gather_floor_s(shape: dict, routed_arcs: float) -> float:
    """Seconds: the routed products of one step at ``shape`` (the driver's,
    with ``n_factors``), ``routed_arcs`` that step's counter."""
    arcs, d, k = shape["arcs"], shape["dim"], shape["n_factors"]
    products = routed_arcs / (arcs * k)
    rows_read = shape["users_with_arcs"] + shape["items_with_arcs"]
    nbytes = arcs * (4 + 4 * k) + rows_read * d * 4 + shape["n_nodes"] * d * 4
    return products * peaks.floor_s(nbytes, 2.0 * arcs * d, "f32")


def dgcf_step_floor_s(shape: dict) -> float:
    """Seconds: one DGCF step's model work at ``shape`` (with ``n_factors``
    and ``n_iterations``)."""
    n, arcs, d = shape["n_nodes"], shape["arcs"], shape["dim"]
    passes = shape["layers"] * shape["n_iterations"]
    ops = 3 * 2.0 * arcs * d * (2 * passes - 1)
    nbytes = 3 * 2 * n * d * 4 + arcs * 8
    return peaks.floor_s(nbytes, ops, "f32")
