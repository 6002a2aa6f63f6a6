"""The harness's side of the program's public entry points: the run's raw
inputs handed to ``gnn_ecommerce_tpu_torch`` in its own types.

Only the drivers import this; the reference never does.
"""
from __future__ import annotations

import numpy as np
import torch

from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit, PreparedData, SamplerArrays

from . import inputs

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
MODES = {"bf16": "bfloat16", "f32": "float32"}


def sampler_arrays(u, i, w, n_users: int) -> SamplerArrays:
    """The BPR sampler over the graph's purchases, each user's purchases
    also its ignore list (as the program's ``bench.py`` lays it out)."""
    pos_users, indptr, pi_s = inputs.purchase_rows(u, i, w, n_users)
    return SamplerArrays(users=pos_users, pos_indptr=indptr, pos_flat=pi_s,
                         ign_indptr=indptr, ign_flat=pi_s)


def prepared(u, i, w, n_users: int, n_items: int) -> PreparedData:
    """What the service loads: the train graph's edges and the purchases that
    mask each user's answers. The eval splits are empty; serving reads none."""
    empty = EvalSplit(user_ids=np.zeros(0, np.int64), truth=CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)),
                      train_mask=CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)))
    return PreparedData(
        n_users=int(n_users), n_items=int(n_items),
        edge_user=np.asarray(u, np.int64), edge_item_node=np.asarray(i, np.int64) + n_users,
        edge_weight=np.asarray(w, np.float32), sampler=sampler_arrays(u, i, w, n_users),
        val=empty, test=empty,
        user_classes=np.arange(n_users), item_classes=np.arange(n_items),
    )


def graph_shape(u, i, n_users: int, n_items: int, dim: int, layers: int) -> dict:
    """The logical sizes the floors count: nodes, arcs of both directions,
    and the distinct rows each direction's arcs read."""
    return {
        "n_users": int(n_users), "n_items": int(n_items), "n_nodes": int(n_users + n_items),
        "edges": int(len(u)), "arcs": 2 * int(len(u)), "dim": int(dim), "layers": int(layers),
        "users_with_arcs": int(len(np.unique(u))), "items_with_arcs": int(len(np.unique(i))),
    }
