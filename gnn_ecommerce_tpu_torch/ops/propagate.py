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

``propagate_segment_chunked`` bounds the message temporary by taking the
arcs in sequential chunks, and ``propagate`` picks an implementation by
name from a registry that ``register_impl`` extends.
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


def propagate_segment_chunked(
    graph: BipartiteGraph, x: torch.Tensor, num_chunks: int = 8
) -> torch.Tensor:
    """Memory-bounded variant: the arcs in ``num_chunks`` sequential chunks
    of ``ceil(2|E| / num_chunks)`` (the last one shorter), each gathered,
    weighted and ``index_add_``-ed into one f32 accumulator; differentiable
    through autograd."""
    n_arcs = graph.src.shape[0]
    chunk = -(-n_arcs // num_chunks)
    out = torch.zeros(graph.num_nodes, x.shape[1], dtype=torch.float32, device=x.device)
    for lo in range(0, n_arcs, max(chunk, 1)):
        s, d = graph.src[lo : lo + chunk], graph.dst[lo : lo + chunk]
        msgs = x.index_select(0, s).float() * graph.w_norm[lo : lo + chunk, None]
        out = out.index_add(0, d, msgs)
    return out.to(x.dtype)


# Implementation registry: name -> fn(graph, x) -> x' (alternate kernels
# register here via register_impl).
_IMPLEMENTATIONS = {
    "segment": propagate_segment,
    "segment_chunked": propagate_segment_chunked,
}


def register_impl(name: str, fn) -> None:
    _IMPLEMENTATIONS[name] = fn


def propagate(graph: BipartiteGraph, x: torch.Tensor, impl: str = "segment") -> torch.Tensor:
    return _IMPLEMENTATIONS[impl](graph, x)
