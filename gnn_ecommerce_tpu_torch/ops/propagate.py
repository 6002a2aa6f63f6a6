"""Layered graph propagation, the reference for the fast path and the
propagation of the driver's layered branch.

Counterpart of ``gnn_ecommerce_tpu/ops/propagate.py:propagate_segment``: one
LGConv layer with normalization precomputed is ``X' = Â X``, computed as a
row gather, a per-arc weight multiply and an ``index_add_`` into f32.

Â is exactly symmetric (both arc directions carry ``w / sqrt(d_src d_dst)``),
so the gradient is ``Âᵀ g = Â g``: one more pass of the same gather and
``index_add_``, with no saved messages (``_spmm_symmetric_bwd`` in the JAX
package). On the card ``index_add_`` adds with atomics, so the sums are not
bitwise reproducible there.
"""
from __future__ import annotations

import torch

from ..graph.build import BipartiteGraph


def _spmm(graph: BipartiteGraph, x: torch.Tensor) -> torch.Tensor:
    msgs = x.index_select(0, graph.src).float() * graph.w_norm[:, None]
    out = torch.zeros(graph.num_nodes, x.shape[1], dtype=torch.float32, device=x.device)
    out.index_add_(0, graph.dst, msgs)
    return out.to(x.dtype)


class _SymmetricSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return _spmm(graph, x)

    @staticmethod
    def backward(ctx, g):
        return _spmm(ctx.graph, g), None


def propagate_segment(graph: BipartiteGraph, x: torch.Tensor) -> torch.Tensor:
    """``out[d] = Σ_{e: dst_e = d} w_norm_e · x[src_e]``, accumulated in f32
    whatever ``x.dtype`` is, returned in ``x.dtype``; differentiable in
    ``x``."""
    return _SymmetricSpmm.apply(x, graph)
