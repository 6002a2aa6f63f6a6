"""Bipartite graph container with precomputed symmetric normalization.

Counterpart of ``gnn_ecommerce_tpu/graph/build.py``: host numpy builds the
normalized bidirectional arc list, sorted by destination (a CSR over
destinations, ``indptr``); the tensors go to the requested device at the
end, or stay on the host (``to_device=False``).

Node ids: users occupy ``[0, n_users)``, items ``[n_users, n_users +
n_items)``. Because arcs are sorted by ``dst``, item→user arcs (``dst <
n_users``) form a prefix and user→item arcs the suffix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..native import coo_sort_by_dst


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Static weighted bipartite graph in unified node space (tensors)."""

    src: torch.Tensor     # [2E] int32, message source node ids
    dst: torch.Tensor     # [2E] int32, message destination node ids (sorted)
    w_norm: torch.Tensor  # [2E] float32, D^-1/2 A D^-1/2 edge coefficients
    w_raw: torch.Tensor   # [2E] float32, unnormalized edge weights
    indptr: torch.Tensor  # [N+1] int32, CSR row pointers over dst
    deg: torch.Tensor     # [N] float32, weighted degree per node
    n_users: int
    n_items: int

    @property
    def num_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def num_arcs(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_edges(self) -> int:
        """Undirected edge count |E| (half the stored arcs)."""
        return self.num_arcs // 2


def symmetric_normalize(
    src: np.ndarray, dst: np.ndarray, weight: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """``w / sqrt(deg_src * deg_dst)`` with weighted degrees aggregated at
    the destination (PyG ``gcn_norm`` without self-loops); degree ≤ 0 gives
    coefficient 0. Returns (normalized weights f32, degrees f32)."""
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, dst, weight.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    w_norm = weight.astype(np.float64) * d_inv_sqrt[src] * d_inv_sqrt[dst]
    return w_norm.astype(np.float32), deg.astype(np.float32)


def build_graph(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    weight: np.ndarray,
    n_users: int,
    n_items: int,
    *,
    items_offset: bool = False,
    to_device: bool = True,
    device: str | torch.device = "cuda",
) -> BipartiteGraph:
    """Build a normalized bidirectional bipartite graph from (user, item, w).

    ``items_offset`` marks ``item_idx`` as already shifted by ``+n_users``.
    The tensors go to ``device``, or with ``to_device=False`` stay on the
    host (CPU tensors over the numpy arrays, whatever ``device`` says).
    """
    dev = resolve_device(device) if to_device else torch.device("cpu")
    user_idx = np.asarray(user_idx, dtype=np.int64)
    item_idx = np.asarray(item_idx, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float64)
    if not items_offset:
        item_idx = item_idx + n_users
    num_nodes = n_users + n_items
    if user_idx.size:
        if user_idx.min() < 0 or user_idx.max() >= n_users:
            raise ValueError("user id out of range")
        if item_idx.min() < n_users or item_idx.max() >= num_nodes:
            raise ValueError("item id out of range")

    src = np.concatenate([user_idx, item_idx])
    dst = np.concatenate([item_idx, user_idx])
    w = np.concatenate([weight, weight])
    w_norm, deg = symmetric_normalize(src, dst, w, num_nodes)
    # Stable counting sort keeps the arc order within a row, as the JAX
    # build does, so segment sums are deterministic across rebuilds.
    order, indptr = coo_sort_by_dst(dst, num_nodes)
    arrays = dict(
        src=src[order].astype(np.int32),
        dst=dst[order].astype(np.int32),
        w_norm=w_norm[order],
        w_raw=w[order].astype(np.float32),
        indptr=indptr.astype(np.int32),
        deg=deg,
    )
    return BipartiteGraph(
        n_users=int(n_users),
        n_items=int(n_items),
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
    )
