"""The fast forward over a user-partitioned mesh: the forward half of the
fast edge partition.

Counterpart of ``gnn_ecommerce_tpu/parallel/edge_partition_fast.py``.
Ownership is by USER: user rows are padded to ``S · R`` (``R`` a multiple of
``ot``) and shard ``s`` (the process of rank ``s`` on the mesh's ``model``
axis) owns rows ``[sR, (s+1)R)``. The item side (embedding, every item-chain
activation, the final item output) is replicated. Each arc lives on the
shard that owns its user:

- ``to_items`` (:func:`ep_to_items`): arcs by source-user owner. K1 gathers
  from the shard's own [R, D] rows into a partial [I, D] f32 sum; one
  all-reduce adds the shards' partials (the JAX ``psum``).
- ``to_users`` (:func:`ep_to_users`): arcs by destination-user owner. K1
  gathers from the replicated item activations into the shard's own rows;
  nothing moves.
- the dense item-item chain: each shard multiplies its row band of B_ii
  (:func:`place_item_op`) and an all-gather reassembles the [I, ·] product
  (GSPMD's all-gather of the band outputs).
- the dense heavy-user head: per-shard column blocks [I, K_s] of the
  head's users that the shard owns, through the same two paths.

The pair is its own transpose, layout included (arc (u, i) lives on
owner(u) in both directions with one weight), so each direction's gradient
is the other applied to the cotangent. K1 (``csrc/segreduce.cu``) runs in
both directions on the shard's plans, in f32 or in bf16 with its cast.

The train step (``make_fast_edge_fns``) samples the same batch on every
shard (one generator seed) and computes the replicated loss everywhere; a
batch user's layer-0 row and its messages come from the shard that owns it
(one all-reduce each). Its gradients follow the forward's
layout: ``emb_users`` gets this shard's rows only, with no collective
(``ep_to_items``' backward is ``local_ep_to_users``); ``emb_items`` gets
the whole gradient on every shard, the items' partial gradients being
all-reduced where the shards read the replicated activations in part (the
B_ii band, the batch's messages). Adam then keeps the item rows and their
moments equal on every shard.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import divisor, mm_f32
from ..models.losses import bpr_loss
from ..ops.bipartite import (
    _DTYPES, BipartiteSplit, batch_messages, heavy_tail, item_chain_core, item_op_mm,
)
from ..ops.spmm_fast import build_segreduce_plan
from ..ops.spmm_sharded import PlanStack, local_segreduce, user_rows_per_shard
from ..train.step import make_train_fns
from .distributed import all_gather_rows, all_reduce_sum, sum_grads, sum_partials
from .mesh import Mesh

# The mesh axis that carries the user shards.
AXIS = "model"


@dataclasses.dataclass(frozen=True)
class FastEdgePartition:
    """One shard's plans, local batch CSR, head block and B_ii band.

    ``hi_loc``/``w_hi`` are None when the shard owns no heavy user;
    ``item_op`` is None until a B_ii band is given."""

    items_stack: PlanStack  # src-owned tail arcs, LOCAL src ids; all-reduced
    users_stack: PlanStack  # dst-owned tail arcs; the shard's own rows out
    # The shard's users' FULL arcs (heavy users included), a CSR over its R
    # local rows (padded rows have degree 0): what a batched forward gathers.
    indptr_loc: torch.Tensor  # [R+1] int64
    batch_item: torch.Tensor  # [A_s] int32 local item ids
    batch_w: torch.Tensor  # [A_s] float32
    hi_loc: torch.Tensor | None = None  # [K_s] int64 local rows of heavy users
    w_hi: torch.Tensor | None = None  # [I, K_s] dense head weights
    item_op: "ItemBand | None" = None
    rows_per_shard: int = 0
    n_users: int = 0
    n_items: int = 0
    n_shards: int = 0
    msgs_dtype: str = "float32"
    mesh: Mesh | None = None

    @property
    def shard(self) -> int:
        return self.items_stack.shard

    @property
    def padded_users(self) -> int:
        return self.rows_per_shard * self.n_shards


@dataclasses.dataclass(frozen=True)
class ItemBand:
    """This shard's row band of the row-sharded B_ii, and the product that
    reassembles ``B_ii @ x`` on every shard.

    Rows are padded to a multiple of the shard count as in the JAX package
    (``band`` rows a shard); the band itself is a view of B_ii's rows (the
    last one shorter), and the padding is added to its product instead, as
    the zero rows the JAX package appended would give."""

    rows: torch.Tensor  # [≤ band, I] rows of B_ii
    band: int
    n_items: int
    mesh: Mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.rows.dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[n_items, n] f32 = B_ii @ x (x: [I, n] in B_ii's dtype, the same
        on every shard); differentiable in ``x``."""
        return _BandProduct.apply(x, self)


class _BandProduct(torch.autograd.Function):
    """Forward: this shard's band ``B_band @ x``, all-gathered. Backward
    (the cotangent ``g`` is the same on every shard): ``B_bandᵀ @ g[band]``,
    each shard's part of ``B_iiᵀ g = B_ii g``, all-reduced in f32. As on
    one device (``device._MmBf16``), a bf16 band takes the cotangent rounded
    to bf16 and its result is rounded once, after the sum."""

    @staticmethod
    def forward(ctx, x, band: ItemBand):
        ctx.band, ctx.dtype = band, x.dtype
        part = item_op_mm(band.rows, x)
        if part.shape[0] < band.band:
            part = torch.cat([part, part.new_zeros(band.band - part.shape[0], part.shape[1])])
        return all_gather_rows(part, band.mesh, AXIS)[: band.n_items]

    @staticmethod
    def backward(ctx, g):
        band = ctx.band
        lo = min(band.mesh.index(AXIS) * band.band, band.n_items)
        g_band = g[lo : lo + band.rows.shape[0]].to(band.dtype)
        part = mm_f32(band.rows.T, g_band)
        return all_reduce_sum(part, band.mesh, AXIS).to(ctx.dtype), None


def place_item_op(item_op: torch.Tensor, mesh: Mesh, shard: int | None = None) -> ItemBand:
    """Shard ``shard``'s (default: this rank's) row band of B_ii
    [n_items, n_items], a view without a copy."""
    S = mesh.shape[AXIS]
    s = mesh.index(AXIS) if shard is None else shard
    n_items = int(item_op.shape[0])
    band = -(-n_items // S)
    return ItemBand(item_op[min(s * band, n_items) : min((s + 1) * band, n_items)], band, n_items, mesh)


def build_fast_edge_partition(
    split: BipartiteSplit,
    mesh: Mesh,
    item_op: torch.Tensor | None = None,
    msgs_dtype: str = "float32",
    heavy_users: int = 0,
    heavy_dtype: str = "float32",
    ot: int = 512,
    ch: int = 256,
) -> FastEdgePartition:
    """This rank's shard, built on the host (numpy) and placed on
    ``mesh.device``. The mesh is 1-axis (``model``, the JAX driver's
    ``make_mesh(n, (n,), ("model",))``). ``item_op`` is the dense B_ii of
    ``ops.bipartite.build_item_operator``; the shard keeps a view of its
    band (:func:`place_item_op`). ``ot`` sets ``R``, ``ch`` the chunk of
    the port's plans."""
    S, s, dev = mesh.shape[AXIS], mesh.index(AXIS), mesh.device
    n_users, n_items = split.n_users, split.n_items
    R = user_rows_per_shard(n_users, S, ot)
    hi, head_coo, ui_src, ui_dst, ui_w, iu_indptr, iu_src, iu_w = heavy_tail(split, heavy_users)

    # to_items: arcs by SOURCE-user owner, src ids localized.
    m = ui_src // R == s
    items_plan = build_segreduce_plan(
        (ui_src[m] - s * R).astype(np.int32), ui_dst[m], ui_w[m], n_items, ch=ch, device=dev
    )
    # to_users: arcs by DESTINATION-user owner, a contiguous range of the
    # dst-sorted tail; destinations localized.
    lo, hi_row = min(s * R, n_users), min((s + 1) * R, n_users)
    a0, a1 = int(iu_indptr[lo]), int(iu_indptr[hi_row])
    iu_dst = np.repeat(np.arange(lo, hi_row, dtype=np.int64), np.diff(iu_indptr[lo : hi_row + 1]))
    users_plan = build_segreduce_plan(
        iu_src[a0:a1], iu_dst - s * R, iu_w[a0:a1], R, ch=ch, device=dev
    )

    # The batched-forward CSR over the shard's local users (FULL arcs).
    full_indptr = np.asarray(split.iu_indptr, dtype=np.int64)
    f0, f1 = int(full_indptr[lo]), int(full_indptr[hi_row])
    indptr_loc = np.full(R + 1, f1 - f0, np.int64)
    indptr_loc[: hi_row - lo + 1] = full_indptr[lo : hi_row + 1] - f0

    # The head: the columns of the heavy users this shard owns.
    hi_loc = w_hi = None
    if hi is not None:
        mine = np.flatnonzero(hi // R == s)  # ranks of this shard's heavy users
        if len(mine):
            keys, w_sum = head_coo
            rank = keys % len(hi)
            take = (rank >= mine[0]) & (rank <= mine[-1])  # hi ascending: a run
            flat = (keys[take] // len(hi)) * len(mine) + (rank[take] - mine[0])
            dt = _DTYPES[heavy_dtype]
            w_hi = torch.zeros(n_items * len(mine), dtype=dt, device=dev)
            w_hi[torch.from_numpy(flat).to(dev)] = torch.from_numpy(w_sum[take]).to(dev).to(dt)
            w_hi = w_hi.view(n_items, len(mine))
            hi_loc = torch.from_numpy(hi[mine] - s * R).to(dev)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return FastEdgePartition(
        items_stack=PlanStack(items_plan, s, S),
        users_stack=PlanStack(users_plan, s, S),
        indptr_loc=put(indptr_loc, np.int64),
        batch_item=put(split.iu_src_item[f0:f1], np.int32),
        batch_w=put(split.iu_w[f0:f1], np.float32),
        hi_loc=hi_loc,
        w_hi=w_hi,
        item_op=None if item_op is None else place_item_op(item_op, mesh, s),
        rows_per_shard=R,
        n_users=n_users,
        n_items=n_items,
        n_shards=S,
        msgs_dtype=msgs_dtype,
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# The self-transpose SpMM pair: each shard's part, then the collective
# ---------------------------------------------------------------------------


def local_ep_to_items(x_users_loc: torch.Tensor, fep: FastEdgePartition) -> torch.Tensor:
    """This shard's partial ``Â_iu · x_users`` [I, D] f32 from its own [R,
    D] user rows: K1 over its arcs plus its head block."""
    out = local_segreduce(x_users_loc, fep.items_stack, fep.msgs_dtype)
    if fep.w_hi is not None:
        xh = x_users_loc.index_select(0, fep.hi_loc).to(fep.w_hi.dtype)
        out = out + mm_f32(fep.w_hi, xh)
    return out


def local_ep_to_users(x_items: torch.Tensor, fep: FastEdgePartition) -> torch.Tensor:
    """This shard's own rows of ``Â_ui · x_items`` [R, D] f32: K1 over the
    arcs into its users plus its head block."""
    out = local_segreduce(x_items, fep.users_stack, fep.msgs_dtype)
    if fep.w_hi is not None:
        heavy = mm_f32(fep.w_hi.T, x_items.to(fep.w_hi.dtype))
        out = out.index_add(0, fep.hi_loc, heavy)
    return out


def _to_items(x_users_loc, fep):
    return all_reduce_sum(local_ep_to_items(x_users_loc, fep), fep.mesh, AXIS)


class _EpToItems(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_users_loc, fep):
        ctx.fep, ctx.dtype = fep, x_users_loc.dtype
        return _to_items(x_users_loc, fep)

    @staticmethod
    def backward(ctx, g):
        return local_ep_to_users(g, ctx.fep).to(ctx.dtype), None


class _EpToUsers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_items, fep):
        ctx.fep, ctx.dtype = fep, x_items.dtype
        return local_ep_to_users(x_items, fep)

    @staticmethod
    def backward(ctx, g):
        return _to_items(g, ctx.fep).to(ctx.dtype), None


def ep_to_items(x_users: torch.Tensor, fep: FastEdgePartition) -> torch.Tensor:
    """out_items [I, D] f32, the same on every shard, = Â_iu · x_users from
    each shard's own [R, D] rows ``x_users``: one all-reduce. Its gradient,
    this shard's rows of the cotangent's ``to_users``, is
    :func:`ep_to_users`."""
    return _EpToItems.apply(x_users, fep)


def ep_to_users(x_items: torch.Tensor, fep: FastEdgePartition) -> torch.Tensor:
    """This shard's rows [R, D] f32 of Â_ui · x_items (x_items replicated):
    no collective. Its gradient is :func:`ep_to_items`."""
    return _EpToUsers.apply(x_items, fep)


# ---------------------------------------------------------------------------
# Params layout: the shard's user rows + the replicated item rows
# ---------------------------------------------------------------------------


def _map_tree(tree, is_node, fn):
    if is_node(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, is_node, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, is_node, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(getattr(tree, f.name), is_node, fn) for f in dataclasses.fields(tree)
        })
    return tree


def _is_unified(node) -> bool:
    return isinstance(node, dict) and set(node) == {"embedding"}


def _is_split(node) -> bool:
    return isinstance(node, dict) and set(node) == {"emb_users", "emb_items"}


def split_ep_tree(tree, fep: FastEdgePartition, mesh: Mesh | None = None):
    """Map every ``{"embedding": [N, D]}`` node (params, or an optimizer
    state's moment dicts) to the shard's layout: ``emb_users`` its [R, D]
    user rows (zero past ``n_users``), ``emb_items`` the [I, D] item rows.
    Other leaves (an optimizer's step) pass through. ``mesh`` must be the
    partition's own (default)."""
    if mesh is not None and mesh is not fep.mesh:
        raise ValueError("split_ep_tree: mesh is not the mesh the partition was built on")
    s, R, n_users = fep.shard, fep.rows_per_shard, fep.n_users

    def one(node):
        emb = node["embedding"]
        lo, hi = min(s * R, n_users), min((s + 1) * R, n_users)
        users = emb.new_zeros(R, emb.shape[1])
        users[: hi - lo] = emb[lo:hi]
        return {"emb_users": users, "emb_items": emb[n_users:].clone()}

    return _map_tree(tree, _is_unified, one)


def merge_ep_view(tree, fep: FastEdgePartition):
    """Inverse of :func:`split_ep_tree`: unified, unpadded ``{"embedding":
    [N, D]}`` nodes (the checkpoint view) on every shard, through one
    all-gather of the user rows per node."""

    def one(node):
        users = all_gather_rows(node["emb_users"], fep.mesh, AXIS)[: fep.n_users]
        return {"embedding": torch.cat([users, node["emb_items"]])}

    return _map_tree(tree, _is_split, one)


# ---------------------------------------------------------------------------
# The embedding and training functions
# ---------------------------------------------------------------------------


def make_fast_edge_fns(cfg, optimizer, mesh: Mesh, fep: FastEdgePartition, batch_size: int,
                       decay: float, edge_cap: int):
    """Build (embed, train_step) over the fast edge partition.

    embed(params, fep) -> [n_users + n_items, D] f32, the final embedding
    on every shard, from params in the split layout (:func:`split_ep_tree`).
    train_step(params, opt_state, fep, sdata, generator) -> (params,
    opt_state, metrics): one step on the batch that ``generator`` draws
    (every shard seeds its generator alike, so every shard draws it), with
    ``optimizer`` (``train.step.Adam``) over the split layout, in place;
    ``train_step.on_batch(params, opt_state, fep, users, pos, neg)`` takes a
    given batch and ``train_step.loss_fn(params, fep, users, pos, neg) ->
    (loss, (bpr, reg, dropped))`` is the loss. ``dropped`` sums every
    shard's batch arcs beyond ``edge_cap`` (the JAX package's count)."""
    L = cfg.num_layers
    n_users, R = fep.n_users, fep.rows_per_shard

    def chain(params: dict, fep_: FastEdgePartition):
        """(alpha, out_i, S_i) of the item chain over the shards."""
        E_u = params["emb_users"]
        alpha = cfg.alphas(E_u.device)
        return alpha, *item_chain_core(
            E_u, params["emb_items"], lambda x: ep_to_items(x, fep_), fep_.item_op, L, alpha
        )

    def embed(params: dict, fep_: FastEdgePartition) -> torch.Tensor:
        alpha, out_i, S_i = chain(params, fep_)
        out_u = alpha[0] * params["emb_users"].float() + ep_to_users(S_i, fep_)
        users = all_gather_rows(out_u, fep_.mesh, AXIS)[:n_users]
        return torch.cat([users, out_i])

    def batch_partial(E_u_loc, fep_: FastEdgePartition, S_i, users):
        """This shard's share of the batch users' aggregation: the layer-0
        rows of the users it owns and the messages along their arcs (all of
        a user's arcs live on its owner), each summed over the shards. The
        one-device ``ops.bipartite.fast_batch_embeddings`` per shard.

        Every shard records the same autograd graph whatever its data (a
        shard without users gathers one arc of weight 0): the backward's
        collectives then run in the same order on every shard."""
        loc = users - fep_.shard * R
        owned = (loc >= 0) & (loc < R)
        locc = loc.clamp(0, R - 1)
        start = fep_.indptr_loc[locc]
        deg = torch.where(owned, fep_.indptr_loc[locc + 1] - start, 0)
        item, weight = fep_.batch_item, fep_.batch_w
        if not item.numel():  # a shard with no users: one arc of weight 0
            item, weight = item.new_zeros(1), weight.new_zeros(1)
        agg, dropped = batch_messages(start, deg, item, weight, sum_grads(S_i, fep_.mesh, AXIS), edge_cap)
        e0 = torch.where(owned[:, None], E_u_loc[locc].float(), 0.0)
        return (sum_partials(e0, fep_.mesh, AXIS), sum_partials(agg, fep_.mesh, AXIS),
                all_reduce_sum(dropped, fep_.mesh, AXIS))

    def loss_fn(params: dict, fep_: FastEdgePartition, users, pos, neg):
        alpha, out_i, S_i = chain(params, fep_)
        e_u, agg, dropped = batch_partial(params["emb_users"], fep_, S_i, users)
        u_out = alpha[0] * e_u + agg
        p_out, n_out = out_i[pos - n_users], out_i[neg - n_users]
        bpr = bpr_loss((u_out * p_out).sum(-1), (u_out * n_out).sum(-1))
        # Ego-embedding L2 on the batch rows, as models.losses.reg_loss sums it.
        E_i32 = params["emb_items"].float()
        sq = sum(e.pow(2).sum() for e in (e_u, E_i32[pos - n_users], E_i32[neg - n_users]))
        reg = decay * 0.5 * sq / divisor(users.shape[0], sq.device)
        return bpr + reg, (bpr, reg, dropped)

    train_step, _ = make_train_fns(cfg, optimizer, batch_size, decay, loss_fn=loss_fn)
    return embed, train_step
