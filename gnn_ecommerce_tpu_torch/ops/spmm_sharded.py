"""The fast SpMM pair over a mesh: each rank reduces its own share of arcs.

Counterpart of ``gnn_ecommerce_tpu/ops/spmm_sharded.py``. The arcs of each
direction are partitioned over every shard of the mesh (one process each,
``parallel/mesh.py``), with the JAX package's ranges:

- ``to_items`` (``Â_iu · x_users``): contiguous arc ranges; each rank sums
  its arcs into a partial [n_items, D] f32 output, and one all-reduce
  (``psum``) adds the partials;
- ``to_users`` (``Â_ui · x_items``): contiguous user-row ranges of equal
  size (a multiple of ``ot``); each rank writes its own rows, and an
  all-gather concatenates them (``shard_map``'s ``out_specs=P(axes)``).

Each rank runs K1, the port's CUDA segment reduce (``csrc/segreduce.cu``
through ``ops/spmm_fast.py:gather_segreduce``), on its own plan: in f32, or
in bf16 with K1's cast. The JAX package padded the plans to one shared shape
so that one Mosaic program served the whole mesh; K1 needs no such padding,
and padded arcs only added exact zeros, so the plans here are unpadded. The
dense heavy-user head stays a replicated ``device.mm_f32`` product outside
the sparse work, as it stayed an XLA ``dot`` outside ``shard_map``.

Every rank's part is a plain function of its local tensors
(:func:`local_to_items`, :func:`local_to_users`); the collectives sit in
:func:`sharded_to_items` / :func:`sharded_to_users`. The pair is its own
transpose (``Â_ui = Â_iuᵀ``), so each direction's gradient is the other
direction applied to the cotangent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import mm_f32
from ..parallel.distributed import all_gather_rows, all_reduce_sum
from ..parallel.mesh import Mesh
from .bipartite import _DTYPES, BipartiteSplit, split_heavy_users
from .spmm_fast import SegReducePlan, build_segreduce_plan, gather_segreduce


@dataclasses.dataclass(frozen=True)
class PlanStack:
    """One shard's :class:`SegReducePlan` of a direction. The JAX package
    stacked every device's padded plan on a leading axis; here a rank holds
    its own plan only, unpadded."""

    plan: SegReducePlan
    shard: int
    n_shards: int

    @property
    def n_out(self) -> int:
        return self.plan.n_out


@dataclasses.dataclass(frozen=True)
class ShardedFastOps:
    """This rank's plans for both SpMM directions, plus the replicated dense
    heavy head (``w_hi`` [n_items, K] over users ``hi_ids``)."""

    items_stack: PlanStack  # an arc range -> partial item rows; all-reduced
    users_stack: PlanStack  # a user-row range's arcs -> its rows; all-gathered
    hi_ids: torch.Tensor | None = None
    w_hi: torch.Tensor | None = None
    n_users: int = 0
    n_items: int = 0
    msgs_dtype: str = "float32"
    mesh: Mesh | None = None


def user_rows_per_shard(n_users: int, n_shards: int, ot: int) -> int:
    """Rows of each shard's to_users output: equal, a multiple of ``ot``."""
    return -(-n_users // (n_shards * ot)) * ot


def build_sharded_fast_ops(
    split: BipartiteSplit,
    mesh: Mesh,
    msgs_dtype: str = "float32",
    heavy_users: int = 0,
    heavy_dtype: str = "float32",
    ot: int = 512,
    ch: int = 256,
) -> ShardedFastOps:
    """This rank's (``mesh.rank``) plans, built on the host from the same arc
    and row ranges as the JAX package's; ``ot`` sets the user-row ranges,
    ``ch`` the chunk of the port's plans. Every shard of the mesh takes an
    equal share whatever its axes."""
    n_dev, s = mesh.size, mesh.rank
    dev = mesh.device
    hi_ids, w_hi, ui_src, ui_dst, ui_w, iu_indptr, iu_src, iu_w, _ = split_heavy_users(
        split, heavy_users, heavy_dtype, device=dev
    )
    lo, hi = np.linspace(0, len(ui_src), n_dev + 1).astype(np.int64)[s : s + 2]
    items_plan = build_segreduce_plan(
        ui_src[lo:hi], ui_dst[lo:hi], ui_w[lo:hi], split.n_items, ch=ch, device=dev
    )
    rows = user_rows_per_shard(split.n_users, n_dev, ot)
    r0, r1 = min(s * rows, split.n_users), min((s + 1) * rows, split.n_users)
    a0, a1 = int(iu_indptr[r0]), int(iu_indptr[r1])
    iu_dst = np.repeat(np.arange(r0, r1, dtype=np.int64), np.diff(iu_indptr[r0 : r1 + 1]))
    users_plan = build_segreduce_plan(
        iu_src[a0:a1], iu_dst - s * rows, iu_w[a0:a1], rows, ch=ch, device=dev
    )
    return ShardedFastOps(
        items_stack=PlanStack(items_plan, s, n_dev),
        users_stack=PlanStack(users_plan, s, n_dev),
        hi_ids=hi_ids,
        w_hi=w_hi,
        n_users=split.n_users,
        n_items=split.n_items,
        msgs_dtype=msgs_dtype,
        mesh=mesh,
    )


def local_segreduce(table: torch.Tensor, stack: PlanStack, msgs_dtype: str) -> torch.Tensor:
    """One rank's gather + K1 reduce over its plan: [n_out, D] f32."""
    return gather_segreduce(table, stack.plan, _DTYPES[msgs_dtype])


def local_to_items(x_users: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    """This rank's partial ``to_items`` tail over its arc range: [n_items,
    D] f32 (the replicated user table in)."""
    return local_segreduce(x_users, sfo.items_stack, sfo.msgs_dtype)


def local_to_users(x_items: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    """This rank's own ``to_users`` tail rows: [rows, D] f32."""
    return local_segreduce(x_items, sfo.users_stack, sfo.msgs_dtype)


def _to_items(x_users: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    out = all_reduce_sum(local_to_items(x_users, sfo), sfo.mesh)
    if sfo.w_hi is not None:
        xh = x_users.index_select(0, sfo.hi_ids).to(sfo.w_hi.dtype)
        out = out + mm_f32(sfo.w_hi, xh)
    return out


def _to_users(x_items: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    out = all_gather_rows(local_to_users(x_items, sfo), sfo.mesh)[: sfo.n_users]
    if sfo.w_hi is not None:
        heavy = mm_f32(sfo.w_hi.T, x_items.to(sfo.w_hi.dtype))
        out = out.index_add(0, sfo.hi_ids, heavy)
    return out


class _ShardedToItems(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_users, sfo):
        ctx.sfo, ctx.dtype = sfo, x_users.dtype
        return _to_items(x_users, sfo)

    @staticmethod
    def backward(ctx, g):
        return _to_users(g, ctx.sfo).to(ctx.dtype), None


class _ShardedToUsers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_items, sfo):
        ctx.sfo, ctx.dtype = sfo, x_items.dtype
        return _to_users(x_items, sfo)

    @staticmethod
    def backward(ctx, g):
        return _to_items(g, ctx.sfo).to(ctx.dtype), None


def sharded_to_items(x_users: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    """out_items = Â_iu · x_users [n_items, D] f32 on every rank, from the
    replicated user table: K1 over this rank's arcs, one all-reduce, the
    head. Same math as ``ops.bipartite.fast_to_items``; its gradient is
    :func:`sharded_to_users`."""
    return _ShardedToItems.apply(x_users, sfo)


def sharded_to_users(x_items: torch.Tensor, sfo: ShardedFastOps) -> torch.Tensor:
    """out_users = Â_ui · x_items [n_users, D] f32 on every rank: K1 over
    this rank's user rows, one all-gather, the head. Its gradient is
    :func:`sharded_to_items`."""
    return _ShardedToUsers.apply(x_items, sfo)
