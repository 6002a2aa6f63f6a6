"""Bipartite-factorized LightGCN propagation, forward and backward.

Counterpart of ``gnn_ecommerce_tpu/ops/bipartite.py``. Propagation
alternates sides of the bipartite graph, so every item layer l ≥ 2 is
``i^l = B_ii · i^{l-2}`` with the dense item-item operator
``B_ii = Â_iu · Â_ui``, and the user side only matters through

    out_u = α_0 E_u + Â_ui · S_i,     S_i = Σ_{l=1..L} α_l i^{l-1}
    out_i = Σ_l α_l i^l,              i^1 = Â_iu · E_u

A forward is then two sparse products plus dense B_ii matmuls. With plans
(``FastOps``) they are ``fast_to_items`` through the CUDA segment reduce and
``fast_to_users`` through the ELL, and an optional dense head of the
heaviest users (``w_hi``) takes their arcs out of both plans. Without plans
(``FastBipartite.fops`` None, ``build_fast_bipartite``'s default) they are
the sorted segment sums :func:`to_items` / :func:`to_users`.

The backward is symmetric: ``(Â_iu)ᵀ = Â_ui`` and ``B_iiᵀ = B_ii``, so the
gradient of ``fast_to_items`` is ``fast_to_users`` and the other way round
(``_FastToItems``/``_FastToUsers``; ``to_items``/``to_users`` likewise,
``_SegPair``), and the B_ii matmuls carry their own
gradients (``device.mm_f32``). A training step reads the final embedding
only at its batch: :func:`fast_batch_embeddings` replaces the full
``fast_to_users`` by the batch users' own arcs.

The graph arrays stay on the host (numpy) in :class:`BipartiteSplit`; the
plans, the per-direction arc CSRs (:class:`ArcCsr`) and the operators built
from them live on the device.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time

import numpy as np
import torch

from .. import native
from ..device import mm_f32, resolve_device
from ..graph.build import BipartiteGraph
from ..models.lightgcn import uniform_alphas
from .spmm_fast import (
    BucketedSegReducePlan,
    EllPlan,
    SegReducePlan,
    build_bucketed_segreduce_plan,
    build_ell_plan,
    build_segreduce_plan,
    ell_apply,
    gather_segreduce,
    gather_segreduce_bucketed,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class BipartiteSplit:
    """Direction-split arc lists on the host, derived from the unified
    dst-sorted arcs (arcs with dst < n_users form the item→user prefix)."""

    # items → users (output users): sorted by dst user
    iu_src_item: np.ndarray  # [E] local item ids
    iu_dst_user: np.ndarray  # [E] user ids
    iu_w: np.ndarray  # [E] normalized weights
    iu_indptr: np.ndarray  # [n_users+1] CSR offsets into the iu arrays
    # users → items (output items): sorted by dst item
    ui_src_user: np.ndarray  # [E] user ids
    ui_dst_item: np.ndarray  # [E] local item ids
    ui_w: np.ndarray  # [E] normalized weights
    n_users: int
    n_items: int


def split_graph(graph: BipartiteGraph) -> BipartiteSplit:
    n_users = graph.n_users
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    w = graph.w_norm.cpu().numpy()
    n_iu = int(np.searchsorted(dst, n_users))
    iu_indptr = np.searchsorted(
        dst[:n_iu], np.arange(n_users + 1, dtype=np.int64)
    ).astype(np.int32)
    return BipartiteSplit(
        iu_src_item=src[:n_iu] - n_users,
        iu_dst_user=dst[:n_iu],
        iu_w=w[:n_iu],
        iu_indptr=iu_indptr,
        ui_src_user=src[n_iu:],
        ui_dst_item=dst[n_iu:] - n_users,
        ui_w=w[n_iu:],
        n_users=n_users,
        n_items=graph.n_items,
    )


@dataclasses.dataclass(frozen=True)
class ArcCsr:
    """One direction's arcs on the device, a CSR over their destinations:
    destination ``d``'s arcs are ``src[indptr[d]:indptr[d+1]]`` with weights
    ``w[...]``, in the split's (dst-sorted) order."""

    indptr: torch.Tensor  # [n_out+1] int64
    src: torch.Tensor  # [E] int64 source ids (local item ids or user ids)
    w: torch.Tensor  # [E] float32 normalized weights


def arc_csr(split: BipartiteSplit, out: str, device: str | torch.device = "cuda") -> ArcCsr:
    """The arcs into ``out`` ("users": items → users, a CSR over users;
    "items": users → items, a CSR over items) on ``device``."""
    dev = resolve_device(device)
    if out == "users":
        indptr, src, w = split.iu_indptr, split.iu_src_item, split.iu_w
    else:
        indptr = np.searchsorted(split.ui_dst_item, np.arange(split.n_items + 1, dtype=np.int64))
        src, w = split.ui_src_user, split.ui_w
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
    return ArcCsr(put(indptr, np.int64), put(src, np.int64), put(w, np.float32))


def _seg_spmm(x: torch.Tensor, csr: ArcCsr) -> torch.Tensor:
    """f32 messages ``x[src]·w`` summed into their sorted destinations by
    ``torch.segment_reduce``, which adds each destination's arcs in order
    (no atomics: the same bytes every call, on the card too)."""
    msgs = x.index_select(0, csr.src).float() * csr.w[:, None]
    return torch.segment_reduce(msgs, "sum", offsets=csr.indptr, unsafe=True)


class _SegPair(torch.autograd.Function):
    """Forward over ``fwd``'s arcs; backward over ``bwd``'s, the transpose
    (``(Â_ui)ᵀ = Â_iu``), as the JAX pair's custom VJPs are."""

    @staticmethod
    def forward(ctx, x, fwd: ArcCsr, bwd: ArcCsr):
        ctx.bwd, ctx.dtype = bwd, x.dtype
        return _seg_spmm(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _seg_spmm(g, ctx.bwd).to(ctx.dtype), None, None


def to_users(x_items: torch.Tensor, split: BipartiteSplit) -> torch.Tensor:
    """out_users = Â_ui · x_items [n_users, D] f32 (one sorted segment sum;
    the split's arcs go to ``x_items``' device on each call). Its gradient
    is :func:`to_items`."""
    dev = x_items.device
    return _SegPair.apply(x_items, arc_csr(split, "users", dev), arc_csr(split, "items", dev))


def to_items(x_users: torch.Tensor, split: BipartiteSplit) -> torch.Tensor:
    """out_items = Â_iu · x_users [n_items, D] f32; its gradient is
    :func:`to_users`."""
    dev = x_users.device
    return _SegPair.apply(x_users, arc_csr(split, "items", dev), arc_csr(split, "users", dev))


@dataclasses.dataclass(frozen=True)
class FastOps:
    """Plans for both sparse directions, plus the optional dense head of the
    heaviest users: ``w_hi`` [n_items, K] serves both directions,

        to_items += w_hi @ x_users[hi_ids]
        to_users[hi_ids] += w_hiᵀ @ x_items
    """

    # gather users → reduce to items (CUDA kernel), whole or by source ranges
    items_plan: SegReducePlan | BucketedSegReducePlan
    users_ell: EllPlan  # gather items → reduce to users
    hi_ids: torch.Tensor | None = None  # [K] int32 heavy user ids
    w_hi: torch.Tensor | None = None  # [n_items, K] dense normalized weights
    msgs_dtype: str = "float32"


def heavy_tail(split: BipartiteSplit, heavy_users: int) -> tuple:
    """Choose the heavy-user head on the host and return the sparse TAIL.

    Returns ``(hi, head_coo, ui_src, ui_dst, ui_w, iu_indptr, iu_src,
    iu_w)``: ``hi`` the ascending heavy user ids (numpy) and ``head_coo =
    (keys, w_sum)`` the head's deduplicated COO, ``keys = item * len(hi) +
    rank`` ascending (both None without a head); the arc arrays are the tail
    (heavy users' arcs removed from both directions). The head is chosen
    with the JAX package's numpy code, so both packages pick the same users
    and build the same tail. The dense head is laid out by the caller: one
    [n_items, K] matrix (:func:`split_heavy_users`) or per-shard column
    blocks (``parallel/edge_partition_fast.py``).
    """
    ui_src, ui_dst, ui_w = split.ui_src_user, split.ui_dst_item, split.ui_w
    iu_indptr, iu_src, iu_w = split.iu_indptr, split.iu_src_item, split.iu_w
    n_users = split.n_users

    hi = head_coo = None
    if heavy_users > 0:
        deg = np.bincount(ui_src, minlength=n_users)
        k = min(int(heavy_users), n_users)
        top = np.argpartition(-deg, k - 1)[:k] if k < n_users else np.arange(n_users)
        top = np.sort(top[deg[top] > 0])
        if len(top):
            hi = top
            rank = np.full(n_users, -1, np.int64)
            rank[hi] = np.arange(len(hi))
            m = rank[ui_src] >= 0
            # Duplicate (item, user) arcs sum in the head, as they do in the
            # sparse plans (build_graph does not deduplicate edge rows).
            key = ui_dst[m].astype(np.int64) * len(hi) + rank[ui_src[m]]
            order = np.argsort(key, kind="stable")
            key_s, w_s = key[order], ui_w[m][order].astype(np.float32)
            uniq, start = np.unique(key_s, return_index=True)
            w_sum = np.add.reduceat(w_s, start) if len(start) else w_s
            head_coo = (uniq, w_sum)
            keep = ~m
            ui_src, ui_dst, ui_w = ui_src[keep], ui_dst[keep], ui_w[keep]
            deg_iu = np.diff(iu_indptr)
            keep_iu = np.repeat(rank < 0, deg_iu)
            iu_indptr = np.append(0, np.cumsum(np.where(rank < 0, deg_iu, 0)))
            iu_src, iu_w = iu_src[keep_iu], iu_w[keep_iu]
    return hi, head_coo, ui_src, ui_dst, ui_w, iu_indptr, iu_src, iu_w


def split_heavy_users(
    split: BipartiteSplit,
    heavy_users: int,
    heavy_dtype: str,
    build_head: bool = True,
    device: str | torch.device = "cuda",
) -> tuple:
    """Extract the dense heavy-user head and return the sparse TAIL arcs.

    Returns ``(hi_ids, w_hi, ui_src, ui_dst, ui_w, iu_indptr, iu_src,
    iu_w, head_coo)``: ``hi_ids``/``w_hi``/``head_coo`` are None without a
    head; the arc arrays are the tail of :func:`heavy_tail`, and
    ``head_coo`` its deduplicated host COO. ``w_hi`` [n_items, K] is filled
    on the device from that COO; ``build_head=False`` leaves it None (for a
    caller that shares an existing head) and returns the rest unchanged.
    """
    dev = resolve_device(device)
    hi, head_coo, *tail = heavy_tail(split, heavy_users)
    hi_ids = w_hi = None
    if hi is not None:
        if build_head:
            uniq, w_sum = head_coo
            dt = _DTYPES[heavy_dtype]
            w_hi = torch.zeros(split.n_items * len(hi), dtype=dt, device=dev)
            w_hi[torch.from_numpy(uniq).to(dev)] = torch.from_numpy(w_sum).to(dev).to(dt)
            w_hi = w_hi.view(split.n_items, len(hi))
        hi_ids = torch.from_numpy(hi.astype(np.int32)).to(dev)
    return (hi_ids, w_hi, *tail, head_coo)


def build_fast_ops(
    split: BipartiteSplit,
    msgs_dtype: str = "float32",
    heavy_users: int = 0,
    heavy_dtype: str = "float32",
    src_buckets: int = 0,
    device: str | torch.device = "cuda",
) -> FastOps:
    """The plans of both sparse directions and the optional heavy-user head
    on ``device``. ``src_buckets > 0`` builds the to_items plan bucketed by
    ranges of source users (:func:`build_bucketed_segreduce_plan` over the
    tail arcs); the forward then runs one K1 pass per bucket, and the
    backward stays the ELL, as in the JAX package."""
    dev = resolve_device(device)
    hi_ids, w_hi, ui_src, ui_dst, ui_w, iu_indptr, iu_src, iu_w, _ = split_heavy_users(
        split, heavy_users, heavy_dtype, device=dev
    )
    if src_buckets > 0:
        items_plan = build_bucketed_segreduce_plan(
            ui_src, ui_dst, ui_w, split.n_items, n_src=split.n_users, n_buckets=src_buckets, device=dev
        )
    else:
        items_plan = build_segreduce_plan(ui_src, ui_dst, ui_w, split.n_items, device=dev)
    return FastOps(
        items_plan=items_plan,
        users_ell=build_ell_plan(iu_indptr, iu_src, iu_w, split.n_users, device=dev),
        hi_ids=hi_ids,
        w_hi=w_hi,
        msgs_dtype=msgs_dtype,
    )


def _to_items(x_users: torch.Tensor, fops: FastOps) -> torch.Tensor:
    reduce = (
        gather_segreduce_bucketed if isinstance(fops.items_plan, BucketedSegReducePlan)
        else gather_segreduce
    )
    out = reduce(x_users, fops.items_plan, _DTYPES[fops.msgs_dtype])
    if fops.w_hi is not None:
        xh = x_users.index_select(0, fops.hi_ids).to(fops.w_hi.dtype)
        out = out + mm_f32(fops.w_hi, xh)
    return out


def _to_users(x_items: torch.Tensor, fops: FastOps) -> torch.Tensor:
    out = ell_apply(
        x_items,
        fops.users_ell,
        gather_dtype=torch.bfloat16 if fops.msgs_dtype == "bfloat16" else None,
    )
    if fops.w_hi is not None:
        heavy = mm_f32(fops.w_hi.T, x_items.to(fops.w_hi.dtype))
        out.index_add_(0, fops.hi_ids, heavy)
    return out


class _FastToItems(torch.autograd.Function):
    """Forward ``Â_iu · x``; backward ``Â_ui · g``: the ELL (bf16 gather in
    bf16 mode) and the head's ``w_hiᵀ``, as the JAX pair's VJP is."""

    @staticmethod
    def forward(ctx, x_users, fops):
        ctx.fops, ctx.dtype = fops, x_users.dtype
        return _to_items(x_users, fops)

    @staticmethod
    def backward(ctx, g):
        return _to_users(g, ctx.fops).to(ctx.dtype), None


class _FastToUsers(torch.autograd.Function):
    """Forward ``Â_ui · x``; backward ``Â_iu · g``: the CUDA segment reduce
    and the head's ``w_hi``."""

    @staticmethod
    def forward(ctx, x_items, fops):
        ctx.fops, ctx.dtype = fops, x_items.dtype
        return _to_users(x_items, fops)

    @staticmethod
    def backward(ctx, g):
        return _to_items(g, ctx.fops).to(ctx.dtype), None


def fast_to_items(x_users: torch.Tensor, fops: FastOps) -> torch.Tensor:
    """out_items = Â_iu · x_users [n_items, D] f32: the CUDA segment reduce
    (+ the head); differentiable, its gradient is :func:`fast_to_users`."""
    return _FastToItems.apply(x_users, fops)


def fast_to_users(x_items: torch.Tensor, fops: FastOps) -> torch.Tensor:
    """out_users = Â_ui · x_items [n_users, D] f32: the degree-binned ELL
    (+ the head); differentiable, its gradient is :func:`fast_to_items`."""
    return _FastToUsers.apply(x_items, fops)


# ---------------------------------------------------------------------------
# Item-item 2-hop operator
# ---------------------------------------------------------------------------


def build_item_operator(
    split: BipartiteSplit,
    dtype: torch.dtype = torch.float32,
    ell_width: int = 8,
    heavy_chunk: int = 512,
    scatter_chunk: int = 8_000_000,
    band_bytes: float = 2.5e9,
    verbose: bool = False,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Dense B_ii = Â_iu · Â_ui [n_items, n_items] on the device.

    B_ii[a, b] = Σ_u Â_iu[a, u] · Â_ui[u, b], a sum of per-user outer
    products. Users of degree ≤ ``ell_width`` are aggregated on the host into
    a deduplicated (a, b, v) COO (``native.pair_aggregate``) and scattered
    ``scatter_chunk`` pairs at a time (each element once, so the chunking
    leaves the bytes alone); heavier users are densified ``heavy_chunk`` at a
    time into M [I, C] and add ``M @ Mᵀ`` band by band, each band's f32
    product at most ``band_bytes``. Accumulation is f32 throughout, with one
    cast to ``dtype`` at the end. ``verbose`` prints each phase's seconds to
    stderr. The JAX build's int32 band split and tile padding are TPU
    constraints and are dropped: the f32 accumulator here is the whole
    [I, I], and ``band_bytes`` bounds the matmul temporaries.
    """
    dev = resolve_device(device)
    n_items = split.n_items
    band_rows = max(1, int(band_bytes // (4 * n_items))) if n_items else 1
    t_start = last = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal last
        if verbose:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            print(f"  b_ii phase {name}: +{now - last:.1f}s (total {now - t_start:.1f}s)",
                  file=sys.stderr, flush=True)
            last = now

    order = np.argsort(split.ui_src_user, kind="stable")
    ui_user = split.ui_src_user[order]
    ui_item = split.ui_dst_item[order]
    ui_w = split.ui_w[order].astype(np.float32)
    _, first = np.unique(ui_user, return_index=True)
    counts = np.diff(np.append(first, len(ui_user)))
    user_indptr = np.append(first, len(ui_user))

    phase("host csr")
    B = torch.zeros(n_items, n_items, dtype=torch.float32, device=dev)
    coo_a, coo_b, coo_v = native.pair_aggregate(
        user_indptr, ui_item, ui_w, n_items, ell_width
    )
    phase(f"pair_aggregate ({len(coo_a)} pairs)")
    for s in range(0, len(coo_a), max(1, int(scatter_chunk))):
        sl = slice(s, s + int(scatter_chunk))
        flat = torch.from_numpy(coo_a[sl] * n_items + coo_b[sl]).to(dev)
        B.view(-1).index_add_(0, flat, torch.from_numpy(coo_v[sl].astype(np.float32)).to(dev))
    del coo_a, coo_b, coo_v
    phase("scatter")

    heavy = counts > ell_width
    h_first, h_counts = first[heavy], counts[heavy]
    if len(h_first):
        # Heavy users' arcs, uploaded once: column (user within its chunk),
        # item and weight per arc, in user order.
        take = np.repeat(h_first, h_counts) + (
            np.arange(int(h_counts.sum()))
            - np.repeat(np.cumsum(np.append(0, h_counts[:-1])), h_counts)
        )
        cols = np.repeat(np.arange(len(h_first)) % heavy_chunk, h_counts)
        h_flat = torch.from_numpy(ui_item[take].astype(np.int64) * heavy_chunk + cols).to(dev)
        h_vals = torch.from_numpy(ui_w[take]).to(dev)
        arc_ptr = np.append(0, np.cumsum(h_counts))
        mm_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
        for s in range(0, len(h_first), heavy_chunk):
            lo, hi = int(arc_ptr[s]), int(arc_ptr[min(s + heavy_chunk, len(h_first))])
            M = torch.zeros(n_items * heavy_chunk, dtype=torch.float32, device=dev)
            M.index_add_(0, h_flat[lo:hi], h_vals[lo:hi])
            M = M.view(n_items, heavy_chunk).to(mm_dtype)
            Mt = M.T
            for a0 in range(0, n_items, band_rows):
                B[a0 : a0 + band_rows] += mm_f32(M[a0 : a0 + band_rows], Mt)
            del M, Mt
        phase(f"heavy matmuls ({len(h_first)} users)")
    return B if dtype == torch.float32 else B.to(dtype)


@dataclasses.dataclass(frozen=True)
class FastBipartite:
    """Everything the fast forward needs: the host split, the dense 2-hop
    operator, and for the sparse products either the plans (``fops``) or,
    with ``fops=None``, the users → items arcs as a CSR over items
    (``item_csr``: :func:`to_items` / :func:`to_users`). ``user_csr``, the
    items → users arcs as a CSR over users, serves batch forwards on either
    path. Each CSR left None is built from ``split`` on ``item_op``'s device,
    so ``FastBipartite(split, item_op)`` is the JAX package's plan-less form.
    ``build_seconds`` records :func:`build_fast_bipartite`'s phases
    (``item_op``, ``plans``: the plans or the CSRs)."""

    split: BipartiteSplit
    item_op: torch.Tensor  # [I, I] B_ii (f32 or bf16)
    fops: FastOps | None = None
    user_csr: ArcCsr | None = None
    item_csr: ArcCsr | None = None
    build_seconds: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        dev = self.item_op.device
        if self.user_csr is None:
            object.__setattr__(self, "user_csr", arc_csr(self.split, "users", dev))
        if self.fops is None and self.item_csr is None:
            object.__setattr__(self, "item_csr", arc_csr(self.split, "items", dev))

    @property
    def n_users(self) -> int:
        return self.split.n_users

    @property
    def n_items(self) -> int:
        return self.split.n_items

    def to_items(self, x_users: torch.Tensor) -> torch.Tensor:
        if self.fops is None:
            return _SegPair.apply(x_users, self.item_csr, self.user_csr)
        return fast_to_items(x_users, self.fops)

    def to_users(self, x_items: torch.Tensor) -> torch.Tensor:
        if self.fops is None:
            return _SegPair.apply(x_items, self.user_csr, self.item_csr)
        return fast_to_users(x_items, self.fops)


def build_fast_bipartite(
    graph: BipartiteGraph,
    dtype: torch.dtype = torch.float32,
    fast_ops: bool = False,
    msgs_dtype: str = "float32",
    heavy_users: int = 0,
    heavy_dtype: str = "float32",
    src_buckets: int = 0,
    band_bytes: float | None = None,
    device: str | torch.device = "cuda",
) -> FastBipartite:
    """Split the graph and build B_ii on ``device``, and the plans when
    ``fast_ops`` (else the plan-less segment-sum path: ``msgs_dtype`` and
    the heavy head are then not used, as in the JAX package).
    ``band_bytes=None`` bounds B_ii's f32 matmul bands at 1.5 GB when a
    heavy head is resident, else 2.5 GB; ``src_buckets > 0`` buckets the
    to_items plan (:func:`build_fast_ops`)."""
    dev = resolve_device(device)
    if band_bytes is None:
        band_bytes = 1.5e9 if (fast_ops and heavy_users > 0) else 2.5e9
    split = split_graph(graph)
    t0 = time.perf_counter()
    fops = (
        build_fast_ops(split, msgs_dtype, heavy_users, heavy_dtype, src_buckets, device=dev)
        if fast_ops else None
    )
    user_csr = arc_csr(split, "users", dev)
    item_csr = None if fast_ops else arc_csr(split, "items", dev)
    t1 = time.perf_counter()
    item_op = build_item_operator(split, dtype=dtype, band_bytes=band_bytes, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return FastBipartite(
        split=split,
        item_op=item_op,
        fops=fops,
        user_csr=user_csr,
        item_csr=item_csr,
        build_seconds={"plans": t1 - t0, "item_op": t2 - t1},
    )


def item_chain_core(E_u, E_i, to_items_fn, B, num_layers: int, alpha):
    """The item-side layer chain. Returns (out_i, S_i): the final [n_items,
    D] item embedding and the alpha-weighted item source that to_users
    consumes. Two levels are computed per B pass, ``B @ [i^{l-2} |
    i^{l-1}]``, so B streams once per pair of layers. Differentiable in
    ``E_u`` and ``E_i`` (B carries no gradient).

    ``B`` is the dense [n_items, n_items] operator, or a callable with a
    ``dtype`` that returns the [n_items, n] f32 product ``B @ x`` for an
    [n_items, n] ``x`` in that dtype (the fast edge partition's row-banded
    B_ii, ``parallel/edge_partition_fast.py:ItemBand``)."""
    if B is None:
        raise ValueError("item_chain_core needs the item-item operator B_ii")
    product = B if callable(B) else functools.partial(mm_f32, B)
    i_seq = [E_i.float(), to_items_fn(E_u)]
    D = E_i.shape[1]
    l = 2
    while l <= num_layers:
        if l + 1 <= num_layers:
            both = torch.cat([i_seq[l - 2].to(B.dtype), i_seq[l - 1].to(B.dtype)], dim=1)
            nxt = product(both)
            i_seq.append(nxt[:, :D])
            i_seq.append(nxt[:, D:])
            l += 2
        else:
            i_seq.append(product(i_seq[l - 2].to(B.dtype)))
            l += 1
    out_i = sum(alpha[l] * i_seq[l] for l in range(num_layers + 1))
    S_i = sum(alpha[l] * i_seq[l - 1] for l in range(1, num_layers + 1))
    return out_i, S_i


def _item_chain(params: dict, fb: FastBipartite, num_layers: int, alpha):
    """(E_u, out_i, S_i, alpha) of :func:`item_chain_core` over the unified
    table; ``alpha=None`` is uniform 1/(L+1)."""
    E = params["embedding"]
    alpha = (uniform_alphas(num_layers) if alpha is None else alpha).to(E.device)
    E_u, E_i = E[: fb.n_users], E[fb.n_users :]
    out_i, S_i = item_chain_core(E_u, E_i, fb.to_items, fb.item_op, num_layers, alpha)
    return E_u, out_i, S_i, alpha


def fast_get_embedding(
    params: dict, fb: FastBipartite, num_layers: int, alpha=None, to_users_fn=None
) -> torch.Tensor:
    """Alpha-weighted LightGCN embedding via the 2-SpMM factorization: an
    exact restructure of the layered ``get_embedding``. Returns the unified
    [n_users + n_items, D] final embedding in the table's dtype.
    ``to_users_fn(S_i)`` replaces ``fb``'s to_users."""
    E_u, out_i, S_i, alpha = _item_chain(params, fb, num_layers, alpha)
    users_of = fb.to_users if to_users_fn is None else to_users_fn
    out_u = alpha[0] * E_u.float() + users_of(S_i)
    return torch.cat([out_u, out_i]).to(params["embedding"].dtype)


def fast_batch_embeddings(
    params: dict,
    fb: FastBipartite,
    num_layers: int,
    users: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    edge_cap: int,
    alpha=None,
):
    """Final embeddings for ONE BPR batch, the training step's fast path.

    A BPR step reads ``out_u`` only at its B users, so ``to_users`` shrinks
    from every arc to the batch users' own arcs: their CSR rows are gathered
    into a fixed ``edge_cap`` buffer and summed by batch slot. The item chain
    stays global (S_i feeds every user). Per step this removes the full
    ``fast_to_users`` from the forward and, by the pair's symmetry, the full
    ``fast_to_items`` from the backward.

    Returns (u_out, p_out, n_out, dropped): [B, D] f32 final embeddings of
    the batch users, positive and negative items (node-space ids, as
    sampled), and a 0-d int64 tensor counting the batch arcs beyond
    ``edge_cap`` (dropped; 0 in a healthy configuration). Nothing here waits
    for the device.
    """
    E_u, out_i, S_i, alpha = _item_chain(params, fb, num_layers, alpha)
    csr = fb.user_csr
    start = csr.indptr[users]
    agg, dropped = batch_messages(start, csr.indptr[users + 1] - start, csr.src, csr.w, S_i, edge_cap)
    u_out = alpha[0] * E_u[users].float() + agg
    n_users = fb.n_users
    return u_out, out_i[pos - n_users], out_i[neg - n_users], dropped


def batch_messages(start, deg, item, w, S_i, edge_cap: int):
    """Each batch slot's messages ``Σ w·S_i[item]`` over its arcs, which are
    ``item[start:start+deg]`` / ``w[...]`` of a CSR: the batch's arcs in
    slot order fill a fixed ``edge_cap`` buffer and are summed by slot.
    Returns (agg [B, D] f32, the 0-d int64 count of arcs beyond
    ``edge_cap``, which are dropped)."""
    B = start.shape[0]
    cum = torch.cumsum(deg, 0)
    total = cum[-1]
    k = torch.arange(edge_cap, dtype=torch.int64, device=start.device)
    slot = torch.searchsorted(cum, k, right=True).clamp(max=B - 1)
    valid = k < total
    e_idx = torch.where(valid, start[slot] + (k - (cum - deg)[slot]), 0)
    msgs = S_i.index_select(0, item[e_idx].long()) * torch.where(valid, w[e_idx], 0.0)[:, None]
    agg = torch.zeros(B, S_i.shape[1], dtype=torch.float32, device=S_i.device)
    return agg.index_add(0, slot, msgs), (total - edge_cap).clamp(min=0)
