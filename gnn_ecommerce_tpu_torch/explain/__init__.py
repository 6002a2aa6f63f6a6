from .paths import AdjacencyCSR, build_adjacency, bfs_paths, hit_paths_frame
from .plots import plot_user_paths

__all__ = [
    "AdjacencyCSR",
    "build_adjacency",
    "bfs_paths",
    "hit_paths_frame",
    "plot_user_paths",
]
