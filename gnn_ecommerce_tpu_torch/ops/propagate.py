"""Layered graph propagation (forward only), the reference for the fast path.

Counterpart of ``gnn_ecommerce_tpu/ops/propagate.py:propagate_segment``: one
LGConv layer with normalization precomputed is ``X' = Â X``, computed as a
row gather, a per-arc weight multiply and an ``index_add_`` into f32. The
serving path does not run it; ``chip_smoke.py`` holds the fast forward
against it on the card.
"""
from __future__ import annotations

import torch

from ..graph.build import BipartiteGraph


def propagate_segment(graph: BipartiteGraph, x: torch.Tensor) -> torch.Tensor:
    """``out[d] = Σ_{e: dst_e = d} w_norm_e · x[src_e]``, accumulated in f32
    whatever ``x.dtype`` is, returned in ``x.dtype``."""
    msgs = x.index_select(0, graph.src).float() * graph.w_norm[:, None]
    out = torch.zeros(graph.num_nodes, x.shape[1], dtype=torch.float32, device=x.device)
    out.index_add_(0, graph.dst, msgs)
    return out.to(x.dtype)
