"""Shortest-path explanations over the user-item graph.

Counterpart of ``gnn_ecommerce_tpu/explain/paths.py``: the train graph's
undirected adjacency as a numpy CSR, one frontier BFS with parent pointers
per explained user (answering all of its hits at once), hop count = number
of edges, and a flag on paths longer than 3 hops. :func:`hit_paths_frame`
returns a :class:`~..data.frame.Frame` under the JAX frame's column names
and writes the same CSV bytes.

As in the JAX package, the native multithreaded BFS (``native.bfs_batch``:
a node's parent is the first frontier node, in frontier order, that reaches
it) answers when the C++ library loads, and the numpy :func:`bfs_paths`
only when it does not. The two give the same distances; where a node has
several shortest parents they may choose differently, since the numpy
BFS keeps each frontier sorted by node id.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..data.frame import Frame


@dataclasses.dataclass(frozen=True)
class AdjacencyCSR:
    """Undirected adjacency over the unified node space [0, n_users+n_items)."""

    indptr: np.ndarray   # [N+1]
    indices: np.ndarray  # [2E] neighbor node ids
    n_users: int
    n_items: int

    @property
    def num_nodes(self) -> int:
        return self.n_users + self.n_items


def build_adjacency(
    edge_user: np.ndarray, edge_item_node: np.ndarray, n_users: int, n_items: int
) -> AdjacencyCSR:
    """CSR from one direction of (user, item-node) train edges; both
    directions are stored, so the graph is undirected."""
    src = np.concatenate([edge_user, edge_item_node]).astype(np.int64)
    dst = np.concatenate([edge_item_node, edge_user]).astype(np.int64)
    n = n_users + n_items
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    return AdjacencyCSR(np.cumsum(indptr), dst, n_users, n_items)


def bfs_paths(
    adj: AdjacencyCSR, source: int, targets: np.ndarray, cutoff: int = 8
) -> list[tuple[int, list[int] | None]]:
    """Single-source BFS with parent pointers; returns [(dist, path)] per
    target, ``(-1, None)`` when unreachable within ``cutoff`` hops."""
    n = adj.num_nodes
    dist = np.full(n, -1, dtype=np.int32)
    parent = np.full(n, -1, dtype=np.int64)
    dist[source] = 0
    frontier = np.array([source], dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    remaining = set(targets.tolist()) - {source}
    d = 0
    while len(frontier) and remaining and d < cutoff:
        starts, ends = adj.indptr[frontier], adj.indptr[frontier + 1]
        counts = ends - starts
        take = np.repeat(starts, counts) + (
            np.arange(int(counts.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(np.append(0, counts[:-1])), counts)
        )
        neigh = adj.indices[take]
        par = np.repeat(frontier, counts)
        new = dist[neigh] < 0
        neigh, par = neigh[new], par[new]
        # The first visit within the level wins (any shortest parent is valid).
        neigh, first = np.unique(neigh, return_index=True)
        parent[neigh] = par[first]
        d += 1
        dist[neigh] = d
        frontier = neigh
        remaining -= set(neigh.tolist())

    out = []
    for t in targets:
        if dist[t] < 0:
            out.append((-1, None))
            continue
        path = [int(t)]
        while path[-1] != source:
            path.append(int(parent[path[-1]]))
        out.append((int(dist[t]), path[::-1]))
    return out


def hit_paths_frame(
    adj: AdjacencyCSR,
    user_ids: np.ndarray,
    topk_idx: np.ndarray,
    truth_sets: list[set],
    flag_hops: int = 3,
    cutoff: int = 8,
) -> Frame:
    """Per-(user, hit item) path analysis (the reference's ``hit_df``).

    Args:
        user_ids: [Nu] relabelled user ids of evaluated users.
        topk_idx: [Nu, K] recommended LOCAL item ids.
        truth_sets: per user, the set of LOCAL ground-truth item ids.
        flag_hops: paths strictly longer than this (or missing) are flagged.

    Returns a frame with columns user_id_idx, item_id_idx (local),
    path_length (-1 when unreachable), path (node-space ids, None when
    unreachable), longer_than_{flag_hops}.
    """
    per_source: list[tuple[int, list[int]]] = []
    for u, recs, truth in zip(user_ids, topk_idx, truth_sets):
        hits = sorted(set(int(r) for r in recs) & truth)
        if hits:
            per_source.append((int(u), hits))

    results = []  # (user, local item, dist, path)
    if per_source and native.available():
        sources = np.array([u for u, _ in per_source], dtype=np.int64)
        t_indptr = np.cumsum([0] + [len(h) for _, h in per_source]).astype(np.int64)
        targets = np.concatenate(
            [np.asarray(h, dtype=np.int64) + adj.n_users for _, h in per_source]
        )
        dist, paths = native.bfs_batch(
            adj.indptr, adj.indices, sources, t_indptr, targets, cutoff
        )
        for s_idx, (u, hits) in enumerate(per_source):
            for j, item in enumerate(hits):
                t = t_indptr[s_idx] + j
                d = int(dist[t])
                path = paths[t, : d + 1].tolist() if d >= 0 else None
                results.append((u, item, d, path))
    else:
        for u, hits in per_source:
            targets = np.asarray(hits, dtype=np.int64) + adj.n_users
            for item, (d, path) in zip(hits, bfs_paths(adj, u, targets, cutoff)):
                results.append((u, item, d, path))

    return Frame({
        "user_id_idx": np.array([r[0] for r in results], dtype=np.int64),
        "item_id_idx": np.array([r[1] for r in results], dtype=np.int64),
        "path_length": np.array([r[2] for r in results], dtype=np.int64),
        "path": [r[3] for r in results] if results else np.empty(0, dtype=object),
        f"longer_than_{flag_hops}": np.array(
            [d < 0 or d > flag_hops for _, _, d, _ in results], dtype=bool
        ),
    })
