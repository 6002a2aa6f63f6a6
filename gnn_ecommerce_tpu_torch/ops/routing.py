"""Intent routing over the whole graph: the sparse operations of DGCF
(``models/dgcf.py``) with per-arc weights that change inside a forward and
carry a gradient.

The graph is the unified arc list of ``graph/build.py`` (both directions,
sorted by destination): the head h of an arc is the row it writes, the tail
t the row it reads. :class:`RoutingGraph` holds it as a CSR over heads, the
tail of each arc, and ``rev``, the reverse arc of each arc (the (u→i) and
(i→u) arcs of one edge point at each other). Per-arc tensors are ``[E, K]``
f32, the equations' ``[K, E]`` stored arc-major, so that an arc's K values
lie together.

- :func:`intent_softmax`: ``S = softmax_k(A)`` per arc.
- :func:`intent_degree`: ``deg_k(v) = Σ_{arcs with head v} S[a, k]``, by
  ``torch.segment_reduce`` over the CSR (each head's arcs summed in order:
  the same bytes every call).
- :func:`intent_spmm`: ``out[h, k-chunk] = Σ_{arcs of h} w[a, k] ·
  x[t_a, k-chunk]`` (chunks of ``c = d / K`` columns). A CUDA table
  launches ``csrc/intent_gather.cu`` (``INTENT_GATHER``); only a CPU table
  takes the plain version, :func:`intent_gather_plain`. Its gradient with
  respect to x is the same product over the reverse arcs
  (``w[rev]``: ``(Σ_h w·g[h])`` at each tail), and with respect to w the
  per-arc dot product of the output gradient with x.
- :func:`intent_sddmm`: ``out[a, k] = ⟨p[h_a, k-chunk], q[t_a, k-chunk]⟩``,
  plain torch in fixed blocks of ``SDDMM_BLOCK`` arcs, so that nothing of
  size [E, d] is made or kept for the backward. Its gradients are
  :func:`intent_spmm`'s product over the heads (for p) and over the
  reverse arcs (for q).

Rows are gathered in ``gather_dtype`` (bf16 rows of 16 bytes, the main
path, or f32); weights, products and sums are f32. No step syncs with the
host or has a shape that depends on the data.

Counter (``tracing.py``): ``ops.intent_gather.split_rows``, the rows that a
CUDA :func:`intent_spmm` call splits into segments of ``INTENT_SPLIT_ARCS``
arcs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.build import BipartiteGraph
from ..tracing import count
from ._kernels import INTENT_GATHER
from .spmm_fast import ell_table

# A row of more arcs than this is cut into segments of this many, each
# summed by one lane group into a partial row, the partials then added in
# order (the ELL's split, ``spmm_fast.ELL_SPLIT_ARCS``).
INTENT_SPLIT_ARCS = 256
# Arcs a block of the plain per-arc dot product: two [block, d] gathers of
# bf16 rows are 256 MB at d 64.
SDDMM_BLOCK = 1 << 20


@dataclasses.dataclass(frozen=True)
class IntentPlan:
    """The kernel's work list over a head-sorted CSR: each item is
    (first arc, arc count, destination), a destination ``>= 0`` an output
    row and ``-(p + 1)`` partial row p. Rows of more than ``split`` arcs
    give one item a segment (their partial rows consecutive, row by row in
    ``comb_row`` order, ``comb_ptr`` their ranges); the segments come first,
    then the whole rows, longest first."""

    src: torch.Tensor  # [E] int32 tail of each arc
    item_arc: torch.Tensor  # [n_work] int64
    item_n: torch.Tensor  # [n_work] int32
    item_dest: torch.Tensor  # [n_work] int32
    comb_row: torch.Tensor  # [n_split_rows] int32
    comb_ptr: torch.Tensor  # [n_split_rows + 1] int64
    n_out: int
    n_arcs: int
    n_work: int
    n_partial: int
    n_split_rows: int


def build_intent_plan(indptr: np.ndarray, src: torch.Tensor, split: int = INTENT_SPLIT_ARCS) -> IntentPlan:
    """The plan of the CSR ``indptr`` [n_out + 1] (host) whose arcs' tails
    are ``src`` [E] int32, on ``src``'s device."""
    indptr = np.asarray(indptr, np.int64)
    lens = np.diff(indptr)
    long_rows = np.flatnonzero(lens > split)
    nseg = -(-lens[long_rows] // split)
    seg_row = np.repeat(long_rows, nseg)
    seg_k = np.arange(len(seg_row)) - np.repeat(np.cumsum(nseg) - nseg, nseg)
    seg_arc = indptr[seg_row] + seg_k * split
    seg_n = np.minimum(split, indptr[seg_row + 1] - seg_arc)
    short = np.flatnonzero(lens <= split)
    short = short[np.argsort(-lens[short], kind="stable")]
    item_arc = np.concatenate([seg_arc, indptr[short]])
    item_n = np.concatenate([seg_n, lens[short]])
    item_dest = np.concatenate([-(np.arange(len(seg_row)) + 1), short])
    dev = src.device
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
    return IntentPlan(
        src=src,
        item_arc=put(item_arc, np.int64),
        item_n=put(item_n, np.int32),
        item_dest=put(item_dest, np.int32),
        comb_row=put(long_rows, np.int32),
        comb_ptr=put(np.concatenate([[0], np.cumsum(nseg)]), np.int64),
        n_out=len(lens),
        n_arcs=int(indptr[-1]),
        n_work=len(item_arc),
        n_partial=len(seg_row),
        n_split_rows=len(long_rows),
    )


@dataclasses.dataclass(frozen=True)
class RoutingGraph:
    """Both directions' arcs as one CSR over heads (users, then items), with
    each arc's tail, head and reverse arc, on one device."""

    indptr: torch.Tensor  # [N + 1] int64
    src: torch.Tensor  # [E] int32 tail of each arc
    head: torch.Tensor  # [E] int32 head of each arc
    rev: torch.Tensor  # [E] int64 the reverse arc of each arc
    plan: IntentPlan
    n_users: int
    n_items: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def n_arcs(self) -> int:
        return int(self.src.shape[0])


def reverse_arcs(head: torch.Tensor, tail: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[E] int64: for each arc (h, t), the position of an arc (t, h). Arcs
    sorted by (h, t) and by (t, h), both stably, pair up rank for rank, so
    repeated edges pair one to one."""
    h, t = head.long(), tail.long()
    fwd = torch.argsort(h * n_nodes + t, stable=True)
    back = torch.argsort(t * n_nodes + h, stable=True)
    rev = torch.empty_like(fwd)
    rev[fwd] = back
    return rev


def build_routing_graph(graph: BipartiteGraph, device=None) -> RoutingGraph:
    """The routing graph of ``graph``'s unified, destination-sorted arcs (no
    weights: DGCF routes over the observed arcs alone), on ``device``
    (``graph``'s by default). Builds no B_ii and no plan of the fast
    bipartite path."""
    dev = torch.device(device) if device is not None else graph.src.device
    src = graph.src.to(dev, torch.int32)
    head = graph.dst.to(dev, torch.int32)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    return RoutingGraph(
        indptr=torch.from_numpy(indptr).to(dev),
        src=src,
        head=head,
        rev=reverse_arcs(head, src, graph.num_nodes),
        plan=build_intent_plan(indptr, src),
        n_users=graph.n_users,
        n_items=graph.n_items,
    )


def intent_softmax(a: torch.Tensor) -> torch.Tensor:
    """``S = softmax_k(A)`` of the [E, K] scores, per arc."""
    return torch.softmax(a, dim=1)


def intent_degree(s: torch.Tensor, rg: RoutingGraph) -> torch.Tensor:
    """[N, K] ``deg_k(v) = Σ_{arcs with head v} S[a, k]``."""
    return torch.segment_reduce(s, "sum", offsets=rg.indptr, axis=0, unsafe=True)


def _rows(x: torch.Tensor, gather_dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` as the rows a product gathers: cast to ``gather_dtype`` once
    (kept as it is when None); on the card in 16-byte rows of bf16 or f32
    (``spmm_fast.ell_table``)."""
    if x.device.type == "cpu":
        return x if gather_dtype is None else x.to(gather_dtype)
    return ell_table(x, gather_dtype)


def _sum_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """f32, or f64 where an operand is f64 (the plain versions' gradient
    checks)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32


def intent_gather_plain(rows: torch.Tensor, w: torch.Tensor, rg: RoutingGraph) -> torch.Tensor:
    """Plain torch version of the kernel: [N, d] f32 from ``rows`` (already
    in the gather type) and the [E, K] weights: every message
    ``float(rows[t]) · w`` in f32, summed per head in arc order."""
    e, k = w.shape
    d = rows.shape[1]
    msgs = rows.index_select(0, rg.src).to(_sum_dtype(rows, w)).view(e, k, d // k) * w[:, :, None]
    return torch.segment_reduce(msgs.view(e, d), "sum", offsets=rg.indptr, axis=0, unsafe=True)


def intent_gather(rows: torch.Tensor, w: torch.Tensor, rg: RoutingGraph) -> torch.Tensor:
    """``out[h, k-chunk] = Σ_{arcs of h} w[a, k] · rows[t_a, k-chunk]``, [N, d]
    f32, no gradient. A CUDA table launches the kernel; only a CPU table
    takes :func:`intent_gather_plain`."""
    if rows.device.type == "cpu":
        return intent_gather_plain(rows, w, rg)
    count("ops.intent_gather.split_rows", rg.plan.n_split_rows)
    return INTENT_GATHER(rows, w.contiguous(), rg.plan)


def sddmm_plain(p: torch.Tensor, q: torch.Tensor, rg: RoutingGraph, k: int) -> torch.Tensor:
    """[E, K] f32 ``⟨p[h_a, k-chunk], q[t_a, k-chunk]⟩`` of rows already in
    the gather type, in blocks of ``SDDMM_BLOCK`` arcs; no gradient."""
    d = p.shape[1]
    out = torch.empty(rg.n_arcs, k, dtype=_sum_dtype(p, q), device=p.device)
    for s in range(0, rg.n_arcs, SDDMM_BLOCK):
        ph = p.index_select(0, rg.head[s:s + SDDMM_BLOCK]).to(out.dtype).view(-1, k, d // k)
        qt = q.index_select(0, rg.src[s:s + SDDMM_BLOCK]).view(-1, k, d // k)
        out[s:s + SDDMM_BLOCK] = (ph * qt).sum(-1)
    return out


class _IntentSpmm(torch.autograd.Function):
    """Forward: the intent-weighted gather-sum. Backward: for x the same
    product of the output gradient over the reverse arcs, for w the per-arc
    dot product of the output gradient with x's gathered rows."""

    @staticmethod
    def forward(ctx, w, x, rg, gather_dtype):
        rows = _rows(x, gather_dtype)
        ctx.rg, ctx.gather_dtype, ctx.x_dtype = rg, gather_dtype, x.dtype
        ctx.save_for_backward(w, rows)
        return intent_gather(rows, w, rg)

    @staticmethod
    def backward(ctx, g):
        w, rows = ctx.saved_tensors
        rg = ctx.rg
        g_rows = _rows(g, ctx.gather_dtype)
        grad_w = grad_x = None
        if ctx.needs_input_grad[0]:
            grad_w = sddmm_plain(g_rows, rows, rg, w.shape[1])
        if ctx.needs_input_grad[1]:
            grad_x = intent_gather(g_rows, w.index_select(0, rg.rev), rg).to(ctx.x_dtype)
        return grad_w, grad_x, None, None


def intent_spmm(w: torch.Tensor, x: torch.Tensor, rg: RoutingGraph,
                gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[N, d] f32 ``out[h, k-chunk] = Σ_{arcs of h} w[a, k] · x[t_a,
    k-chunk]`` for the [E, K] weights ``w``; x's rows gathered in
    ``gather_dtype`` (f32 when None). Differentiable in ``w`` and ``x``."""
    return _IntentSpmm.apply(w, x, rg, gather_dtype)


class _IntentSddmm(torch.autograd.Function):
    """Forward: the per-arc dot product per intent. Backward:
    :func:`intent_gather` of the output gradient over the heads for p, over
    the reverse arcs for q."""

    @staticmethod
    def forward(ctx, p, q, rg, k, gather_dtype):
        p_rows, q_rows = _rows(p, gather_dtype), _rows(q, gather_dtype)
        ctx.rg, ctx.gather_dtype, ctx.dtypes = rg, gather_dtype, (p.dtype, q.dtype)
        ctx.save_for_backward(p_rows, q_rows)
        return sddmm_plain(p_rows, q_rows, rg, k)

    @staticmethod
    def backward(ctx, g):
        p_rows, q_rows = ctx.saved_tensors
        rg = ctx.rg
        g = g.contiguous()
        grad_p = grad_q = None
        if ctx.needs_input_grad[0]:
            grad_p = intent_gather(q_rows, g, rg).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            grad_q = intent_gather(p_rows, g.index_select(0, rg.rev), rg).to(ctx.dtypes[1])
        return grad_p, grad_q, None, None, None


def intent_sddmm(p: torch.Tensor, q: torch.Tensor, rg: RoutingGraph, k: int,
                 gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[E, K] f32 ``out[a, k] = ⟨p[h_a, k-chunk], q[t_a, k-chunk]⟩`` for
    [N, d] ``p`` and ``q`` (chunks of ``d / k`` columns), their rows gathered
    in ``gather_dtype`` (f32 when None). Differentiable in ``p`` and ``q``."""
    return _IntentSddmm.apply(p, q, rg, k, gather_dtype)
