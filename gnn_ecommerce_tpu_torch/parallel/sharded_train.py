"""The GSPMD training steps over a (data × model) mesh, one process per rank.

Counterpart of ``gnn_ecommerce_tpu/parallel/sharded_train.py``. The JAX
package annotates shardings and lets GSPMD insert the collectives; a
process world has no GSPMD, so the same math runs with the collectives
called by name (``parallel/distributed.py``):

- the embedding table and its Adam moments are row bands over ``model``
  (:func:`shard_params`; rows padded to a multiple of the axis), the same on
  every rank of ``data``. A step all-gathers the bands into the table;
- the layered step's arcs are split over ``data`` (:func:`shard_graph`,
  padded with no-op arcs), each rank sums its arcs and one all-reduce adds
  the partial sums;
- the fast step's B_ii rows are split over ``model``
  (``edge_partition_fast.ItemBand``), and its sparse products either run
  on SpMM plans over every rank (``ops/spmm_sharded.py``,
  ``shard_fast_bipartite(fast_ops=True)``) or, plan-less (JAX's default),
  sum each direction's arcs split over ``data`` with one all-reduce
  (:func:`shard_arcs`), as :func:`shard_fast_bipartite` lays them out;
- the batch is whole on every rank, which computes the whole batch's loss
  (the one-device ``make_loss_fn``) over the gathered table. GSPMD splits
  the batch over ``data``; here a split would need an all-reduce of the
  [n, D] cotangent over ``data`` before the chain's own collectives, whose
  backward expects the cotangent whole on every rank, to save the work of
  one batch.

The gradient: every rank's autograd graph yields the whole table's
gradient, each collective's backward following from whether its input is
replicated (``ops/spmm_sharded.py``, ``ItemBand``, :func:`propagate_arc_shards`),
and the band gather's backward keeps this rank's band (:func:`gather_bands`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..graph.build import BipartiteGraph
from ..models.lightgcn import get_embedding
from ..ops.bipartite import (
    ArcCsr, BipartiteSplit, FastBipartite, _seg_spmm, fast_batch_embeddings, fast_get_embedding,
)
from ..ops.spmm_sharded import ShardedFastOps, build_sharded_fast_ops, sharded_to_items, sharded_to_users
from ..train.step import make_loss_fn, make_train_fns
from .distributed import all_gather_rows, all_reduce_sum, broadcast_rows
from .edge_partition_fast import ItemBand, _is_unified, _map_tree, place_item_op
from .mesh import Mesh


def _band_rows(n_rows: int, mesh: Mesh) -> int:
    """Rows of each ``model`` band of an ``n_rows`` table."""
    return -(-n_rows // mesh.shape["model"])


def shard_params(params, mesh: Mesh):
    """This rank's ``model`` band of every ``{"embedding": [N, D]}`` node
    of ``params`` (the params, or an Adam state's moments): rows [m·R, (m+1)·R)
    with R = ceil(N / model), zero past N. Other leaves pass through."""
    m = mesh.index("model")

    def one(node):
        emb = node["embedding"]
        R = _band_rows(emb.shape[0], mesh)
        band = emb.new_zeros(R, emb.shape[1])
        rows = emb[m * R : (m + 1) * R]
        band[: rows.shape[0]] = rows
        return {"embedding": band}

    return _map_tree(params, _is_unified, one)


def unshard_params(tree, mesh: Mesh, n_rows: int):
    """Inverse of :func:`shard_params` (the checkpoint view): every band
    all-gathered over ``model`` into the unpadded [n_rows, D] table."""
    return _map_tree(
        tree, _is_unified,
        lambda node: {"embedding": all_gather_rows(node["embedding"], mesh, "model")[:n_rows]},
    )


def shard_graph(graph: BipartiteGraph, mesh: Mesh) -> BipartiteGraph:
    """This rank's ``data`` shard of the arcs, on the mesh's device.

    The arc arrays are padded to a multiple of the ``data`` axis, as the
    JAX package pads them, with no-op tail arcs: weight 0, source 0 and
    destination ``num_nodes`` (out of range; :func:`propagate_arc_shards`
    drops it), so the destinations stay sorted. Shard ``d`` keeps the
    padded arcs [d·E/n, (d+1)·E/n)."""
    n, d = mesh.shape["data"], mesh.index("data")
    e = int(graph.src.shape[0])
    pad = (-e) % n
    per = (e + pad) // n

    def shard(x, fill):
        x = torch.cat([x, x.new_full((pad,), fill)]) if pad else x
        return x[d * per : (d + 1) * per].to(mesh.device)

    return BipartiteGraph(
        src=shard(graph.src, 0),
        dst=shard(graph.dst, graph.num_nodes),
        w_norm=shard(graph.w_norm, 0),
        w_raw=shard(graph.w_raw, 0),
        indptr=graph.indptr.to(mesh.device),
        deg=graph.deg.to(mesh.device),
        n_users=graph.n_users,
        n_items=graph.n_items,
    )


def _arc_sum(graph: BipartiteGraph, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Â x over the whole graph: this rank's arcs summed in f32 (pad arcs
    land in a spare row that is cut), then all-reduced over ``data``."""
    msgs = x.index_select(0, graph.src).float() * graph.w_norm[:, None]
    out = torch.zeros(graph.num_nodes + 1, x.shape[1], dtype=torch.float32, device=x.device)
    out.index_add_(0, graph.dst, msgs)
    return all_reduce_sum(out[: graph.num_nodes].contiguous(), mesh, "data").to(x.dtype)


class _ArcShardSpmm(torch.autograd.Function):
    """Â is symmetric over the whole arc set, so the gradient ``Âᵀ g`` is
    the same sharded sum applied to the cotangent (which, like ``x``, is
    the same on every rank)."""

    @staticmethod
    def forward(ctx, x, graph, mesh):
        ctx.graph, ctx.mesh = graph, mesh
        return _arc_sum(graph, mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _arc_sum(ctx.graph, ctx.mesh, g), None, None


def propagate_arc_shards(graph: BipartiteGraph, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One layered propagation ``Â x`` over a :func:`shard_graph` graph:
    the GSPMD step's segment sums with their partials all-reduced over
    ``data``; differentiable in ``x``."""
    return _ArcShardSpmm.apply(x, graph, mesh)


def shard_arcs(split: BipartiteSplit, out: str, mesh: Mesh) -> ArcCsr:
    """This rank's ``data`` shard of one direction's dst-sorted arcs (``out``
    "items": users → items; "users": items → users) as a CSR over the
    ``n_out`` outputs plus one spare row, on the mesh's device.

    As :func:`shard_graph` and the JAX package do, the arcs are padded to a
    multiple of the ``data`` axis with no-op arcs (source 0, weight 0,
    destination ``n_out``: the spare row, which the sum cuts) and shard
    ``d`` keeps the padded arcs [d·E/n, (d+1)·E/n)."""
    if out == "items":
        src, dst, w, n_out = split.ui_src_user, split.ui_dst_item, split.ui_w, split.n_items
    else:
        src, dst, w, n_out = split.iu_src_item, split.iu_dst_user, split.iu_w, split.n_users
    n, d = mesh.shape["data"], mesh.index("data")
    e = len(w)
    pad = (-e) % n
    per = (e + pad) // n

    def shard(x, fill):
        x = np.concatenate([x, np.full(pad, fill, x.dtype)]) if pad else x
        return x[d * per : (d + 1) * per]

    dst_d = shard(np.asarray(dst, np.int64), n_out)
    indptr = np.searchsorted(dst_d, np.arange(n_out + 2, dtype=np.int64))
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(mesh.device)
    return ArcCsr(put(indptr, np.int64), put(shard(np.asarray(src), 0), np.int64),
                  put(shard(np.asarray(w, np.float32), 0), np.float32))


def _shard_sum(x: torch.Tensor, csr: ArcCsr, mesh: Mesh) -> torch.Tensor:
    """The whole direction's product on every rank: this rank's arcs summed
    in f32 by the fixed-order segment sum (the spare row cut), then the
    partial sums all-reduced over ``data``."""
    part = _seg_spmm(x, csr)[:-1].contiguous()
    return all_reduce_sum(part, mesh, "data")


class _ArcShardPair(torch.autograd.Function):
    """Forward over this rank's ``fwd`` arcs, all-reduced over ``data``;
    backward the same over its ``bwd`` arcs, the transpose (``(Â_iu)ᵀ =
    Â_ui``). The cotangent is the same on every rank, as ``x`` is, so every
    rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, fwd: ArcCsr, bwd: ArcCsr, mesh):
        ctx.bwd, ctx.mesh, ctx.dtype = bwd, mesh, x.dtype
        return _shard_sum(x, fwd, mesh)

    @staticmethod
    def backward(ctx, g):
        return _shard_sum(g, ctx.bwd, ctx.mesh).to(ctx.dtype), None, None, None


@dataclasses.dataclass(frozen=True)
class ShardedFastBipartite:
    """The fast path laid out on a mesh: the host split, this rank's B_ii
    band over ``model``, the replicated per-user CSR of the batch forward,
    and for the sparse products either its SpMM plans over the whole mesh
    (``fops``) or, with ``fops`` None, this rank's ``data`` shard of each
    direction's arcs (``item_arcs``, ``user_arcs``: :func:`shard_arcs`).
    It stands in for ``ops.bipartite.FastBipartite`` in
    ``fast_get_embedding`` and ``fast_batch_embeddings``."""

    split: BipartiteSplit
    item_op: ItemBand
    fops: ShardedFastOps | None
    user_csr: ArcCsr
    mesh: Mesh
    item_arcs: ArcCsr | None = None
    user_arcs: ArcCsr | None = None

    @property
    def n_users(self) -> int:
        return self.split.n_users

    @property
    def n_items(self) -> int:
        return self.split.n_items

    def to_items(self, x_users: torch.Tensor) -> torch.Tensor:
        if self.fops is None:
            return _ArcShardPair.apply(x_users, self.item_arcs, self.user_arcs, self.mesh)
        return sharded_to_items(x_users, self.fops)

    def to_users(self, x_items: torch.Tensor) -> torch.Tensor:
        if self.fops is None:
            return _ArcShardPair.apply(x_items, self.user_arcs, self.item_arcs, self.mesh)
        return sharded_to_users(x_items, self.fops)


def shard_fast_bipartite(
    fb: FastBipartite,
    mesh: Mesh,
    fast_ops: bool = False,
    msgs_dtype: str = "float32",
    heavy_users: int = 0,
    heavy_dtype: str = "float32",
) -> ShardedFastBipartite:
    """Lay ``fb`` out on ``mesh`` for this rank: B_ii's rows over ``model``
    (a view of them) and the per-user CSR replicated. ``fast_ops=True`` adds
    the fast SpMM plans over every rank (``build_sharded_fast_ops``, with
    the dense heavy head replicated), as JAX's driver asks; the default
    ``fast_ops=False`` is the JAX package's GSPMD segment-sum path: each
    direction's arcs split over ``data`` (:func:`shard_arcs`), summed per
    rank and all-reduced (``msgs_dtype`` and the head are then not used)."""
    band = place_item_op(fb.item_op, mesh)
    if not fast_ops:
        return ShardedFastBipartite(
            fb.split, band, None, fb.user_csr, mesh,
            item_arcs=shard_arcs(fb.split, "items", mesh), user_arcs=shard_arcs(fb.split, "users", mesh),
        )
    fops = build_sharded_fast_ops(
        fb.split, mesh, msgs_dtype=msgs_dtype, heavy_users=heavy_users, heavy_dtype=heavy_dtype
    )
    return ShardedFastBipartite(fb.split, band, fops, fb.user_csr, mesh)


class _GatherBands(torch.autograd.Function):
    """Forward: the ``model`` bands all-gathered into the [n_rows, D] table.
    Backward: every rank computes the whole batch's loss, so the cotangent
    is the whole table's gradient on every rank and this rank's band of it
    is the band's gradient, with no collective. ``data`` replicas of a band
    take data rank 0's (a broadcast), which keeps them bit-equal whatever
    order the card's atomic adds took."""

    @staticmethod
    def forward(ctx, band, mesh, n_rows):
        ctx.mesh, ctx.R = mesh, band.shape[0]
        out = all_gather_rows(band, mesh, "model")
        return (out.clone() if out is band else out)[:n_rows]

    @staticmethod
    def backward(ctx, g):
        mesh, R = ctx.mesh, ctx.R
        rows = g[mesh.index("model") * R :][:R]
        grad = g.new_zeros(R, g.shape[1])
        grad[: rows.shape[0]] = rows
        if mesh.shape["data"] > 1:
            broadcast_rows(grad, mesh, "data")
        return grad, None, None


def gather_bands(band: torch.Tensor, mesh: Mesh, n_rows: int) -> torch.Tensor:
    """The unpadded [n_rows, D] table from this rank's :func:`shard_params`
    band; differentiable, its gradient this rank's band of the table's."""
    return _GatherBands.apply(band, mesh, n_rows)


def sharded_fast_embedding(params: dict, sfb: ShardedFastBipartite, num_layers: int) -> torch.Tensor:
    """The final [n_users + n_items, D] embedding on every rank, from
    params in :func:`shard_params`' layout (``ops.bipartite.
    fast_get_embedding`` over the mesh)."""
    E = gather_bands(params["embedding"], sfb.mesh, sfb.n_users + sfb.n_items)
    return fast_get_embedding({"embedding": E}, sfb, num_layers)


def _make_banded_step(cfg, optimizer, mesh: Mesh, batch_size: int, decay: float, **loss_kw):
    """``train.step.make_train_fns``' step over params in
    :func:`shard_params`' layout: the one-device loss (``make_loss_fn(cfg,
    decay, **loss_kw)``) of the whole batch, on every rank, over the
    gathered table."""
    loss_fn = make_loss_fn(cfg, decay, **loss_kw)

    def banded_loss(params: dict, graph, users, pos, neg):
        E = gather_bands(params["embedding"], mesh, graph.n_users + graph.n_items)
        return loss_fn({"embedding": E}, graph, users, pos, neg)

    step, _ = make_train_fns(cfg, optimizer, batch_size, decay, loss_fn=banded_loss)
    return step


def make_sharded_fast_train_step(cfg, optimizer, mesh: Mesh, batch_size: int, decay: float,
                                 edge_cap: int):
    """The GSPMD step over the fast path: ``step(params, opt_state, sfb,
    sdata, generator) -> (params, opt_state, metrics)`` with ``sfb`` from
    :func:`shard_fast_bipartite` and params in :func:`shard_params`' layout
    (``optimizer``: ``train.step.Adam``, updating in place). The forward is
    the batched training path (``ops.bipartite.fast_batch_embeddings``):
    to_items by K1 on each rank's plan, or plan-less by the segment sum of
    this rank's ``data`` shard of the arcs, and one all-reduce; the B_ii
    chain on ``model`` bands; the batch users' own arcs from the replicated
    CSR.
    ``step.on_batch(params, opt_state, sfb, users, pos, neg)`` takes a given
    batch, ``step.loss_fn(params, sfb, users, pos, neg)`` is the loss."""
    L = cfg.num_layers
    return _make_banded_step(
        cfg, optimizer, mesh, batch_size, decay,
        batch_embed_fn=lambda p, sfb, u, po, ne: fast_batch_embeddings(p, sfb, L, u, po, ne, edge_cap),
    )


def make_sharded_train_step(cfg, optimizer, mesh: Mesh, batch_size: int, decay: float,
                            propagate_fn: Callable | None = None):
    """The GSPMD step over the layered path: ``step(params, opt_state,
    graph, sdata, generator) -> (params, opt_state, metrics)`` with
    ``graph`` from :func:`shard_graph` and params in :func:`shard_params`'
    layout. ``propagate_fn(graph, x)`` defaults to
    :func:`propagate_arc_shards` on ``mesh``. The metrics carry
    ``dropped_arcs`` 0 (the layered path drops nothing)."""
    if propagate_fn is None:
        propagate_fn = functools.partial(propagate_arc_shards, mesh=mesh)
    return _make_banded_step(
        cfg, optimizer, mesh, batch_size, decay,
        embed_fn=lambda p, graph: get_embedding(p, graph, cfg, propagate_fn),
    )


__all__ = [
    "ShardedFastBipartite",
    "gather_bands",
    "make_sharded_fast_train_step",
    "make_sharded_train_step",
    "propagate_arc_shards",
    "shard_arcs",
    "shard_fast_bipartite",
    "shard_graph",
    "shard_params",
    "sharded_fast_embedding",
    "unshard_params",
]
