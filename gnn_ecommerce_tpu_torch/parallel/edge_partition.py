"""Explicit edge partition: the layered propagation over ranks that own
rows, with an all-to-all of boundary rows each layer.

Counterpart of ``gnn_ecommerce_tpu/parallel/edge_partition.py``. The
unified node space is padded to ``S · R`` rows and rank ``s`` of the mesh's
``model`` axis owns rows [sR, (s+1)R). Every arc lives on the owner of its
DESTINATION, so a rank's segment sums are complete; what moves is the
SOURCE rows of cut arcs. For each (owner, consumer) pair the build lists
the sorted unique rows the consumer needs; each layer the owner gathers
them into [S, max_send, D] blocks and one all-to-all delivers them.

A rank's arcs are split into local-source and remote-source lists: the
local sum needs nothing from the exchange (the JAX package lets XLA overlap
the two; here they run one after the other). The propagation is made of
gathers, segment sums and the all-to-all, whose gradient is the reverse
all-to-all (``distributed.exchange_rows``), so autograd gives the backward
exchange. The batch's rows are looked up by mask-and-sum: the owner
contributes a row, the others zeros, one all-reduce.

The JAX package builds every shard's arrays at once and pads them to one
shape; here a rank builds its own, unpadded but for the send blocks (one
size for the all-to-all). No Pallas kernel is reached: this is the
segment-sum path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import divisor
from ..graph.build import BipartiteGraph
from ..models.losses import bpr_loss
from ..train.step import make_train_fns
from .distributed import all_gather_rows, exchange_rows, sum_partials
from .sharded_train import shard_params, unshard_params
from .mesh import Mesh

AXIS = "model"


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """One rank's arcs and its part of the boundary exchange."""

    src_loc: torch.Tensor  # [Al] int64 local source row
    dst_loc: torch.Tensor  # [Al] int64 destination - rank offset (sorted)
    w_loc: torch.Tensor  # [Al] f32
    src_rem: torch.Tensor  # [Ar] int64 slot into the flattened [S·max_send] receive buffer
    dst_rem: torch.Tensor  # [Ar] int64 destination - rank offset (sorted)
    w_rem: torch.Tensor  # [Ar] f32
    send_idx: torch.Tensor  # [S, max_send] int64 local rows this rank sends to each peer
    rows_per_shard: int
    n_shards: int
    max_send: int
    num_nodes: int  # unpadded
    mesh: Mesh | None = None

    @property
    def padded_nodes(self) -> int:
        return self.rows_per_shard * self.n_shards

    @property
    def shard(self) -> int:
        return self.mesh.index(AXIS)


def build_edge_partition(graph: BipartiteGraph, mesh: Mesh) -> EdgePartition:
    """This rank's part (the mesh's ``model`` index, of ``model`` shards),
    built on the host from the dst-sorted arcs of ``graph`` and placed on
    the mesh's device. ``max_send`` is the largest (owner, consumer) list
    over the whole mesh, as in the JAX package."""
    src = graph.src.cpu().numpy().astype(np.int64)
    dst = graph.dst.cpu().numpy().astype(np.int64)
    w = graph.w_norm.cpu().numpy().astype(np.float32)
    n = graph.num_nodes
    S, s = mesh.shape[AXIS], mesh.index(AXIS)
    R = -(-n // S)
    bounds = np.searchsorted(dst, np.arange(S + 1) * R)

    # need[consumer][owner]: the sorted unique global source rows.
    need = [[np.empty(0, np.int64)] * S for _ in range(S)]
    for c in range(S):
        c_src = src[bounds[c] : bounds[c + 1]]
        owner = c_src // R
        for p in np.unique(owner):
            if p != c:
                need[c][int(p)] = np.unique(c_src[owner == p])
    max_send = max((len(need[c][o]) for c in range(S) for o in range(S)), default=1) or 1

    s_src, s_dst, s_w = (a[bounds[s] : bounds[s + 1]] for a in (src, dst, w))
    owner = s_src // R
    local = owner == s
    slot = np.zeros(int((~local).sum()), np.int64)
    r_src, r_owner = s_src[~local], owner[~local]
    send_idx = np.zeros((S, max_send), np.int64)
    for p in range(S):
        if p == s:
            continue
        m = r_owner == p
        slot[m] = p * max_send + np.searchsorted(need[s][p], r_src[m])
        rows = need[p][s]  # owned here, needed by p
        send_idx[p, : len(rows)] = rows - s * R

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(mesh.device)

    return EdgePartition(
        src_loc=put(s_src[local] - s * R, np.int64),
        dst_loc=put(s_dst[local] - s * R, np.int64),
        w_loc=put(s_w[local], np.float32),
        src_rem=put(slot, np.int64),
        dst_rem=put(s_dst[~local] - s * R, np.int64),
        w_rem=put(s_w[~local], np.float32),
        send_idx=put(send_idx, np.int64),
        rows_per_shard=R,
        n_shards=S,
        max_send=max_send,
        num_nodes=n,
        mesh=mesh,
    )


def _exchange_spmm(x: torch.Tensor, part: EdgePartition) -> torch.Tensor:
    """One propagation layer on this rank: x [R, D] f32 its rows. The
    owners' boundary rows arrive by one all-to-all; the local-source and
    remote-source partial sums add into the rank's own rows."""
    D = x.shape[1]
    send = x[part.send_idx.reshape(-1)]  # [S·max_send, D], a block per peer
    recv = exchange_rows(send, part.mesh, AXIS)
    out = torch.zeros(part.rows_per_shard, D, dtype=torch.float32, device=x.device)
    out = out.index_add(0, part.dst_loc, x[part.src_loc] * part.w_loc[:, None])
    return out.index_add(0, part.dst_rem, recv[part.src_rem] * part.w_rem[:, None])


def _embed_local(emb_local: torch.Tensor, part: EdgePartition, alpha, num_layers: int) -> torch.Tensor:
    x = emb_local.float()
    out = alpha[0] * x
    for layer in range(num_layers):
        x = _exchange_spmm(x, part)
        out = out + alpha[layer + 1] * x
    return out


def _lookup(out_local: torch.Tensor, ids: torch.Tensor, part: EdgePartition) -> torch.Tensor:
    """Rows ``ids`` (global) of the rank-distributed [R, D] ``out_local``,
    the same on every rank: each id's owner contributes the row, one
    all-reduce (``sum_partials``: the gradient stays with the owner)."""
    R = part.rows_per_shard
    loc = ids - part.shard * R
    ok = (loc >= 0) & (loc < R)
    vals = torch.where(ok[:, None], out_local[loc.clamp(0, R - 1)], 0.0)
    return sum_partials(vals, part.mesh, AXIS)


def pad_params(params, part: EdgePartition, mesh: Mesh | None = None):
    """This rank's [R, D] rows of every ``{"embedding": [N, D]}`` node of
    ``params`` (the params, or an Adam state's moments), the table
    zero-padded to S·R rows: the GSPMD step's ``model`` bands
    (``sharded_train.shard_params``). ``mesh`` must be the part's own
    (default)."""
    if mesh is not None and mesh is not part.mesh:
        raise ValueError("pad_params: mesh is not the mesh the partition was built on")
    return shard_params(params, part.mesh)


def unpad_params(tree, part: EdgePartition):
    """Inverse of :func:`pad_params` (the checkpoint view): every rank's
    rows all-gathered into the unpadded [N, D] table."""
    return unshard_params(tree, part.mesh, part.num_nodes)


def make_explicit_fns(cfg, optimizer, mesh: Mesh, part: EdgePartition, batch_size: int, decay: float):
    """Build (embed, train_step) over an explicit edge partition.

    embed(params, part) -> [S·R, D] f32, the final embedding (padded) on
    every rank, from params in :func:`pad_params`' layout.
    train_step(params, opt_state, part, sdata, generator) -> (params,
    opt_state, metrics), updating in place (``optimizer``:
    ``train.step.Adam``); ``train_step.on_batch`` takes a given batch and
    ``train_step.loss_fn(params, part, users, pos, neg)`` is the loss. The
    metrics carry ``dropped_arcs`` 0 (this path drops nothing)."""
    L = cfg.num_layers

    def embed(params: dict, part_: EdgePartition) -> torch.Tensor:
        emb = params["embedding"]
        out = _embed_local(emb, part_, cfg.alphas(emb.device), L)
        return all_gather_rows(out, part_.mesh, AXIS)

    def loss_fn(params: dict, part_: EdgePartition, users, pos, neg):
        emb = params["embedding"]
        out = _embed_local(emb, part_, cfg.alphas(emb.device), L)
        u, p, n = (_lookup(out, ids, part_) for ids in (users, pos, neg))
        bpr = bpr_loss((u * p).sum(-1), (u * n).sum(-1))
        # Ego-embedding L2 on the batch rows, looked up the same way.
        e = emb.float()
        sq = sum(_lookup(e, ids, part_).pow(2).sum() for ids in (users, pos, neg))
        reg = decay * 0.5 * sq / divisor(users.shape[0], sq.device)
        return bpr + reg, (bpr, reg, torch.zeros((), dtype=torch.int64, device=users.device))

    train_step, _ = make_train_fns(cfg, optimizer, batch_size, decay, loss_fn=loss_fn)
    return embed, train_step
