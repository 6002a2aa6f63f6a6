"""Path-subgraph plots.

Counterpart of ``gnn_ecommerce_tpu/explain/plots.py``: draws the union of
one user's shortest paths to its hit items as a spring-layout graph, users
orange, items blue, the user and its hit items red. matplotlib and networkx
are imported only when a plot is drawn; without them
:func:`plot_user_paths` raises ``ImportError`` naming both.
"""
from __future__ import annotations

import numpy as np

from ..data.frame import Frame


def plot_user_paths(
    hit_df: Frame,
    user_id: int,
    n_users: int,
    out_path: str | None = None,
    seed: int = 42,
):
    """Plot all stored paths of one user (a :func:`~.paths.hit_paths_frame`
    frame); returns the matplotlib Figure."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except ImportError as e:
        raise ImportError(
            f"plot_user_paths needs matplotlib and networkx ({e})"
        ) from e

    rows = np.flatnonzero(np.asarray(hit_df["user_id_idx"]) == user_id)
    if len(rows) == 0:
        raise ValueError(f"user {user_id} has no hit paths in hit_df")

    g = nx.Graph()
    hits = set()
    for r in rows:
        path = hit_df["path"][r]
        hits.add(int(hit_df["item_id_idx"][r]) + n_users)
        if not path:
            continue
        g.add_edges_from(zip(path[:-1], path[1:]))

    def color(node: int) -> str:
        if node == user_id or node in hits:
            return "tab:red"
        return "tab:orange" if node < n_users else "tab:blue"

    fig, ax = plt.subplots(figsize=(8, 6))
    pos = nx.spring_layout(g, seed=seed)
    nx.draw_networkx(
        g,
        pos=pos,
        ax=ax,
        node_color=[color(n) for n in g.nodes],
        with_labels=True,
        font_size=7,
        node_size=250,
    )
    ax.set_title(f"user {user_id}: paths to {len(hits)} hit item(s)")
    ax.axis("off")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
    return fig
