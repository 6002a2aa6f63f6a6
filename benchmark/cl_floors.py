"""The floors of SimGCL's work (``models/simgcl.py``), beside ``peaks.py``'s
(whose rates and ``spmm_floor_s`` they use) and counted the same way: the
logical work, each input read once and each output written once.

- :func:`views_floor_s`: the perturbed views' forward in one step, from the
  program's counters of that step: ``train.cl.view_arcs`` (arcs of both
  directions, every view and layer) and ``train.cl.noised_rows`` (rows
  noised, every view and layer). Each view-layer is one sparse product in
  each direction over half its arcs (``peaks.spmm_floor_s``: each source
  row that an arc reads once, every output row written once), and its
  noise reads and writes each noised f32 row once.
- :func:`simgcl_step_floor_s`: one SimGCL step's model work: the clean
  LightGCN term as ``peaks.lightgcn_step_floor_s`` counts it (L products of
  Â forward, twice that backward), the two views' L products forward and
  twice that backward, both InfoNCE GEMMs forward and backward over the
  batch's unique rows, and the table, Adam's two moments and the arcs read
  once, the table and moments written once.
"""
from __future__ import annotations

from benchmark import peaks


def views_floor_s(shape: dict, view_arcs: float, noised_rows: float) -> float:
    """Seconds: the views' forward of one step at ``shape`` (a driver's
    ``graph_shape``), ``view_arcs`` and ``noised_rows`` that step's
    counters."""
    d = shape["dim"]
    view_layers = noised_rows / shape["n_nodes"]
    if view_layers <= 0:
        return 0.0
    arcs_dir = view_arcs / view_layers / 2
    per_layer = (peaks.spmm_floor_s(shape["items_with_arcs"], arcs_dir, shape["n_users"], d)
                 + peaks.spmm_floor_s(shape["users_with_arcs"], arcs_dir, shape["n_items"], d))
    noise = peaks.floor_s(noised_rows * d * 4 * 2, 0.0, "f32")
    return view_layers * per_layer + noise


def infonce_ops(rows: float, dim: int) -> float:
    """One InfoNCE term over ``rows`` unique rows: the [rows, rows] scores
    forward (``2·rows²·dim``) and the two products of its backward."""
    return 3 * 2.0 * rows * rows * dim


def simgcl_step_floor_s(shape: dict) -> float:
    """Seconds: one SimGCL step's model work at ``shape`` (with ``batch``,
    ``unique_users`` and ``unique_pos``, the mean unique ids a batch)."""
    n, arcs, d, L = shape["n_nodes"], shape["arcs"], shape["dim"], shape["layers"]
    ops = (3 * L * 2.0 * arcs * d) * 3  # the clean term and two views, each forward and twice backward
    ops += infonce_ops(shape["unique_users"], d) + infonce_ops(shape["unique_pos"], d)
    nbytes = 3 * 2 * n * d * 4 + arcs * 8
    return peaks.floor_s(nbytes, ops, "f32")
