"""The SpMM pair of the fast bipartite forward.

Counterpart of ``gnn_ecommerce_tpu/ops/spmm_fast.py``:

- ``to_items = Â_iu · x_users`` (gather from the big user table, reduce over
  items) runs the hand-written CUDA segment reduce ``csrc/segreduce.cu``
  through :func:`gather_segreduce`, over a CSR-over-items plan of the arcs
  (:func:`build_segreduce_plan`) cut into chunks of at most ``ch`` arcs,
  runs of short rows packed whole into one chunk (the sharded paths run
  the same kernel on users-side plans of rows of a few arcs);
- ``to_users = Â_ui · x_items`` (gather from the small item table) runs
  the hand-written CUDA ELL gather ``csrc/ell_gather.cu`` through
  :func:`gather_ell`, over a degree-binned ELL plan (:func:`build_ell_plan`)
  whose rows it writes once each; its plain version is the gather +
  width-sum :func:`ell_apply`, which the JAX package leaves to XLA.

Both are exact restructurings of the segment sum; only the summation order
differs. The src-bucketed to_items plan (:class:`BucketedSegReducePlan`,
:func:`gather_segreduce_bucketed`) cuts the arcs by ranges of source rows,
so that each pass gathers from a slice of the table; its passes chain
through the kernel's accumulate mode.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..device import aligned_len, aligned_zeros, resolve_device
from ._kernels import ELL_GATHER, SEGREDUCE

# ---------------------------------------------------------------------------
# Degree-binned ELL (gather + width-sum; no scatter)
# ---------------------------------------------------------------------------

# A bin wider than this many arcs is split: each of its rows is cut into
# segments of this many arcs (the last shorter), which the kernel sums
# apart and adds in segment order. Only hubs split: with the main
# configuration's 16,384-user head no tail row comes near it, without a
# head (the service's f32 plan) the users of tens of thousands of arcs do.
ELL_SPLIT_ARCS = 256
# Columns of the kernel's bin descriptor (EllPlan.bins).
ELL_BIN_COLS = ("first_item", "first_row", "width", "first_arc", "first_split_row")


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """Rows grouped into degree bins; each bin is a dense [rows_b, W_b]
    (index, weight) pair, a view into one flat buffer of each. Outputs come
    back in bin order and are un-permuted by one row gather at
    ``inv_order`` (:func:`ell_apply`); the kernel (:func:`gather_ell`)
    writes bin row r straight into output row ``order[r]``.

    The kernel's work items, listed by ``bins`` widest bin first: one item
    a row of a bin no wider than ``split_arcs``; ``ceil(W / split_arcs)``
    items a row of a wider bin, its segments of ``split_arcs`` arcs in
    order, whose sums (partial rows, item q in partial row q) are added in
    segment order. Split bins are the widest, so their items come first."""

    idx: tuple  # per bin: [rows_b, W_b] int32 rows of the table (views of idx_flat)
    w: tuple  # per bin: [rows_b, W_b] float32 normalized weights, 0 = pad (views of w_flat)
    inv_order: torch.Tensor  # [n_out] int32; out = cat(bin outs)[inv_order]
    n_out: int
    widths: tuple
    idx_flat: torch.Tensor  # [sum rows_b * W_b] int32, the bins one after the other
    w_flat: torch.Tensor  # [sum rows_b * W_b] float32
    order: torch.Tensor  # [n_out] int32: bin row -> output row (order[inv_order] = arange)
    # [n_bins, 5] int64, widest bin first: ELL_BIN_COLS (first_split_row:
    # n_split_rows for a bin that is not split)
    bins: torch.Tensor
    n_work: int  # the kernel's work items: rows of unsplit bins and segments of split ones
    n_segments: int  # segments of split rows: the partial rows, items [0, n_segments)
    n_split_rows: int  # rows of split bins
    split_arcs: int


def _ell_widths(max_deg: int) -> list[int]:
    """×1.5 width schedule (1, 2, 3, 5, 8, 12, 18, ...)."""
    ws, W = [1, 2, 3], 3
    while W < max_deg:
        W = int(np.ceil(W * 1.5))
        ws.append(W)
    return ws


def _ell_bins(spans: list, split_arcs: int) -> tuple:
    """The kernel's descriptor of bins ``spans`` ((first row, rows, width,
    first arc) each, in bin order): [n_bins, 5] int64 rows of
    ELL_BIN_COLS, widest first, and (n_work, n_segments, n_split_rows)."""
    recs, item, segs, split_row = [], 0, 0, 0
    for lo, rows, width, arc in reversed(spans):
        recs.append([item, lo, width, arc, split_row])
        if width > split_arcs:
            n_seg = rows * -(-width // split_arcs)
            item, segs, split_row = item + n_seg, segs + n_seg, split_row + rows
        else:
            item += rows
    table = np.array(recs, dtype=np.int64).reshape(-1, len(ELL_BIN_COLS))
    table[table[:, 2] <= split_arcs, 4] = split_row
    return table, (item, segs, split_row)


def build_ell_plan(
    indptr: np.ndarray,
    src: np.ndarray,
    w: np.ndarray,
    n_out: int,
    device: str | torch.device = "cuda",
) -> EllPlan:
    """Build from a CSR over destinations (``indptr`` [n_out+1] into
    dst-sorted ``src``/``w`` arc arrays). Bins wider than ELL_SPLIT_ARCS
    are split into segments for the kernel (:class:`EllPlan`)."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    order = native.ell_sort_by_degree(indptr)
    dsort = deg[order]
    idx_bins, w_bins, spans = [], [], []
    lo = arc = 0
    for W in _ell_widths(int(dsort[-1]) if n_out else 1):
        if lo >= n_out:
            break
        hi = int(np.searchsorted(dsort, W, side="right"))
        if hi <= lo:
            continue
        ib, wb = native.ell_fill_bin(indptr, src, w, order[lo:hi], W)
        idx_bins.append(ib.reshape(-1))
        w_bins.append(wb.reshape(-1))
        spans.append((lo, hi - lo, W, arc))
        arc += ib.size
        lo = hi
    idx_flat = torch.from_numpy(np.concatenate(idx_bins or [np.zeros(0, np.int32)])).to(dev)
    w_flat = torch.from_numpy(np.concatenate(w_bins or [np.zeros(0, np.float32)])).to(dev)
    del idx_bins, w_bins
    bins, (n_work, n_segments, n_split_rows) = _ell_bins(spans, ELL_SPLIT_ARCS)
    if max(n_out, n_work) >= 2**31:
        raise ValueError(f"the kernel holds rows and work items in int32: {n_out}, {n_work}")
    inv = np.empty(n_out, np.int32)
    inv[order] = np.arange(n_out, dtype=np.int32)
    return EllPlan(
        idx=tuple(idx_flat[a : a + rows * W].view(rows, W) for _, rows, W, a in spans),
        w=tuple(w_flat[a : a + rows * W].view(rows, W) for _, rows, W, a in spans),
        inv_order=torch.from_numpy(inv).to(dev),
        n_out=int(n_out),
        widths=tuple(W for _, _, W, _ in spans),
        idx_flat=idx_flat,
        w_flat=w_flat,
        order=torch.from_numpy(order.astype(np.int32)).to(dev),
        bins=torch.from_numpy(bins).to(dev),
        n_work=int(n_work),
        n_segments=int(n_segments),
        n_split_rows=int(n_split_rows),
        split_arcs=ELL_SPLIT_ARCS,
    )


def ell_apply(
    table: torch.Tensor, plan: EllPlan, gather_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """[n_out, D] float32 = Â · table via per-bin gather + width-sum: the
    plain version of :func:`gather_ell`.

    ``gather_dtype=torch.bfloat16`` casts the table once before the gathers
    (one rounding per message); weights and sums stay f32 either way."""
    if gather_dtype is not None:
        table = table.to(gather_dtype)
    d = table.shape[1]
    outs = [
        (
            table.index_select(0, ib.reshape(-1)).reshape(*ib.shape, d).float()
            * wb[..., None]
        ).sum(dim=1)
        for ib, wb in zip(plan.idx, plan.w)
    ]
    if not outs:
        return torch.zeros(plan.n_out, d, dtype=torch.float32, device=table.device)
    return torch.cat(outs).index_select(0, plan.inv_order)


def ell_table(table: torch.Tensor, gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The table :func:`gather_ell`'s kernel reads, with the values
    :func:`ell_apply` gathers: for ``gather_dtype=torch.bfloat16`` a
    non-bf16 table's :func:`bf16_rows`; else the f32 or bf16 table itself
    when its rows are 16-byte rows the kernel takes
    (``ELL_GATHER.takes_rows``), or a copy into such rows (an f32 table of
    90 columns gets rows of 92). Another dtype is read as f32."""
    if gather_dtype == torch.bfloat16 and table.dtype != torch.bfloat16:
        return bf16_rows(table)
    if table.dtype not in (torch.float32, torch.bfloat16):
        table = table.float()
    if ELL_GATHER.takes_rows(table):
        return table
    return aligned_zeros(*table.shape, table.dtype, table.device).copy_(table)


def gather_ell(
    table: torch.Tensor, plan: EllPlan, gather_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """[n_out, D] float32 = Â · table over the ELL plan: :func:`ell_apply`'s
    values up to the order of each row's sum (arc order).

    A CUDA table launches ``csrc/ell_gather.cu`` on :func:`ell_table`'s
    layout (one row pass, and a combine pass when the plan splits rows);
    only a CPU table takes the plain version, :func:`ell_apply`."""
    if table.device.type == "cpu":
        return ell_apply(table, plan, gather_dtype)
    return ELL_GATHER(ell_table(table, gather_dtype), plan)


# ---------------------------------------------------------------------------
# to_items: the CUDA segment reduce over a chunked CSR plan
# ---------------------------------------------------------------------------


# A row with more chunks than this is combined by a block of warps, a row
# with fewer by one warp.
LONG_ROW_CHUNKS = 32
# A row of at most this many arcs (and at most ch) is short: runs of short
# rows are packed whole into chunks of at most ch arcs, one warp a chunk
# writing each row as it ends. Longer rows keep chunks of their own. The
# largest limit at which no plan of the main configuration ran slower than
# unpacked on an H100 (chip_smoke.py phase 3, check_short_rows): packing
# rows of 17 to 64 arcs sped the users side up but slowed the items side.
SHORT_ROW_ARCS = 16
# A packed chunk spans at most this many rows: its warp writes a row every
# few arcs, and on an H100 a chunk of 256 one-arc rows outlasted the rest
# of its pass (the src-bucketed plan's tails, in accumulate mode), as
# chunks of 32 rows did on an edge rank's to_items plan.
PACKED_ROWS = 16


@dataclasses.dataclass(frozen=True)
class SegReducePlan:
    """Dst-sorted arcs (a CSR over the ``n_out`` rows), cut into chunks of at
    most ``ch`` arcs, one warp each. A run of consecutive short rows (at
    most ``SHORT_ROW_ARCS`` arcs) is packed whole into chunks of at most
    ``PACKED_ROWS`` rows, each of which writes its rows' output rows as
    they end. A longer row gets chunks of its own: its only chunk writes
    the output row, the chunks of a row with several write partial rows
    that a second pass adds in a fixed order, and that pass also zeroes
    the rows with no arc. Every output row has one writer. The plain
    version reads ``src``/``dst``/``w`` directly. No padding: every arc is
    real."""

    src: torch.Tensor  # [E] int32 rows of the table
    dst: torch.Tensor  # [E] int32 output rows, ascending
    w: torch.Tensor  # [E] float32 normalized weights
    chunk_ptr: torch.Tensor  # [n_chunks+1] int64 arc offsets of the chunks
    row_chunks: torch.Tensor  # [n_out] int32 chunks holding the row's arcs (0: no arc)
    # [n_chunks] int32: r in [0, n_out) for row r's only chunk; n_out + r for
    # a packed chunk whose first row is r; -1 - p for a chunk that writes
    # partial row p (a row's chunks take consecutive p).
    chunk_slot: torch.Tensor
    packed: torch.Tensor  # [n_packed] int32 the packed chunks, ascending (launched first)
    # [n_comb] int32 rows with no chunk or several: the n_long rows of more
    # than LONG_ROW_CHUNKS chunks, then the others, each part ascending.
    comb_rows: torch.Tensor
    comb_ptr: torch.Tensor  # [n_comb+1] int64 partial rows of each comb row
    n_out: int
    n_src: int  # the table needs at least this many rows
    n_partial: int  # partial rows: the chunks of rows with several
    n_long: int  # the first n_long comb rows are each combined by a block
    n_packed: int  # packed chunks: the chunks that hold more than one row

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_ptr.shape[0]) - 1


def _packed_starts(cnt: np.ndarray, indptr: np.ndarray, ch: int, short: np.ndarray) -> np.ndarray:
    """The first rows of the packed chunks: each run of short rows (a row
    with no arc does not end a run) is cut greedily, in row order, into
    chunks of whole rows of at most ``ch`` arcs spanning at most
    PACKED_ROWS rows."""
    n_out = len(cnt)
    rows = np.arange(n_out + 1)
    # fit[i]: one past the last row that a chunk starting at row i holds
    # whole within ch arcs; stop[i]: the first long row from i on; nxt[j]:
    # the first short row from j on (n_out: none).
    fit = np.searchsorted(indptr, indptr[:-1] + ch, side="right") - 1
    ends = np.append(np.flatnonzero((cnt > 0) & ~short), n_out)
    stop = ends[np.searchsorted(ends, rows[:-1])]
    shorts = np.append(np.flatnonzero(short), n_out)
    nxt = shorts[np.searchsorted(shorts, rows)]
    starts, i = [], int(nxt[0])
    while i < n_out:
        starts.append(i)
        i = int(nxt[min(stop[i], fit[i], i + PACKED_ROWS)])
    return np.asarray(starts, dtype=np.int64)


def _segreduce_plan(src, dst_sorted, w, n_out: int, ch: int, device, short_arcs: int) -> SegReducePlan:
    """:func:`build_segreduce_plan` with rows of at most ``short_arcs`` arcs
    packed; 0 packs none (every row in chunks of its own, the layout of
    the kernel before packing, kept to time against)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst_sorted, dtype=np.int64)
    if len(dst) and (np.any(np.diff(dst) < 0) or dst[0] < 0 or dst[-1] >= n_out):
        raise ValueError("dst_sorted must be ascending ids in [0, n_out)")
    if 2 * n_out >= 2**31:
        raise ValueError(f"chunk_slot holds n_out + row in int32: n_out {n_out} is too large")
    cnt = np.bincount(dst, minlength=n_out)
    indptr = np.concatenate([[0], np.cumsum(cnt)])
    short = (cnt > 0) & (cnt <= min(short_arcs, ch))
    row_chunks = np.where(short, 1, -(-cnt // ch))
    # Chunks that start at each row: a long row's own, and one at the first
    # row of each packed chunk; a chunk runs to the next one's first arc.
    per_row = np.where(short, 0, row_chunks)
    per_row[_packed_starts(cnt, indptr, ch, short)] = 1
    chunk_row = np.repeat(np.arange(n_out), per_row)
    k_in_row = np.arange(len(chunk_row)) - np.repeat(np.cumsum(per_row) - per_row, per_row)
    chunk_ptr = np.append(indptr[chunk_row] + ch * k_in_row, len(dst))
    long_rows = np.flatnonzero(row_chunks > LONG_ROW_CHUNKS)
    comb_rows = np.concatenate(
        [long_rows, np.flatnonzero((row_chunks != 1) & (row_chunks <= LONG_ROW_CHUNKS))]
    )
    comb_ptr = np.concatenate([[0], np.cumsum(row_chunks[comb_rows])])
    first_partial = np.zeros(n_out, np.int64)
    first_partial[comb_rows] = comb_ptr[:-1]
    packed = dst[chunk_ptr[1:] - 1] != chunk_row if len(chunk_row) else np.zeros(0, bool)
    chunk_slot = np.where(
        row_chunks[chunk_row] == 1,
        chunk_row + n_out * packed,
        -1 - (first_partial[chunk_row] + k_in_row),
    )

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return SegReducePlan(
        src=put(src, np.int32),
        dst=put(dst, np.int32),
        w=put(w, np.float32),
        chunk_ptr=put(chunk_ptr, np.int64),
        row_chunks=put(row_chunks, np.int32),
        chunk_slot=put(chunk_slot, np.int32),
        packed=put(np.flatnonzero(packed), np.int32),
        comb_rows=put(comb_rows, np.int32),
        comb_ptr=put(comb_ptr, np.int64),
        n_out=int(n_out),
        n_src=int(src.max()) + 1 if len(src) else 0,
        n_partial=int(comb_ptr[-1]),
        n_long=len(long_rows),
        n_packed=int(packed.sum()),
    )


def build_segreduce_plan(
    src: np.ndarray,
    dst_sorted: np.ndarray,
    w: np.ndarray,
    n_out: int,
    ch: int = 256,
    device: str | torch.device = "cuda",
) -> SegReducePlan:
    return _segreduce_plan(src, dst_sorted, w, n_out, ch, device, SHORT_ROW_ARCS)


def segreduce_plain(
    table: torch.Tensor, plan: SegReducePlan, prev: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain torch version of the kernel, same arithmetic: f32 rows times
    f32 weights, or bf16 rows times bf16-rounded weights; products summed
    into f32 by ``index_add_``. With ``prev`` ([n_out, D] f32) the result
    is ``prev + sums``, the kernel's accumulate mode (a new tensor here)."""
    w = plan.w
    if table.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    msgs = table.index_select(0, plan.src).float() * w[:, None]
    out = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float32, device=table.device)
    out.index_add_(0, plan.dst, msgs)
    return out if prev is None else prev + out


def bf16_rows_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the padded cast: ``table.to(bfloat16)`` in a
    zeroed [n, D] view of 16-byte rows (``device.aligned_zeros``)."""
    return aligned_zeros(*table.shape, torch.bfloat16, table.device).copy_(table)


def bf16_rows(table: torch.Tensor) -> torch.Tensor:
    """``table`` rounded to bf16 in rows of a 16-byte stride (pad columns
    zero), so the kernel loads them 16 bytes a lane: the values of
    ``table.to(torch.bfloat16)``. A CUDA f32 table launches the cast kernel
    of ``csrc/segreduce.cu``; only a CPU table takes the plain version. Any
    layout is taken."""
    if table.device.type == "cpu":
        return bf16_rows_plain(table)
    return SEGREDUCE.cast_bf16(table, aligned_len(table.shape[1], torch.bfloat16))


def segreduce_table(table: torch.Tensor, msgs_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The table :func:`gather_segreduce` reduces, in a layout the kernel
    reads: for ``msgs_dtype=torch.bfloat16`` a non-bf16 table's
    :func:`bf16_rows`; else the table itself, or a contiguous copy when
    its rows overlap (an expanded gradient) or its columns are strided."""
    if msgs_dtype == torch.bfloat16 and table.dtype != torch.bfloat16:
        return bf16_rows(table)
    if not SEGREDUCE.takes_rows(table):
        return table.contiguous()
    return table


def gather_segreduce(
    table: torch.Tensor, plan: SegReducePlan, msgs_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[n_out, D] float32 = Â · table. ``msgs_dtype=torch.bfloat16`` casts the
    table once (into 16-byte rows, :func:`bf16_rows`) and rounds each weight
    to bf16 (the main configuration's mode); ``torch.float32`` is exact up to
    summation order. A bf16 table is read as it is. Any layout is taken
    (:func:`segreduce_table`).

    A CUDA table launches ``csrc/segreduce.cu``; only a CPU table takes the
    plain version."""
    table = segreduce_table(table, msgs_dtype)
    if table.device.type == "cpu":
        return segreduce_plain(table, plan)
    return SEGREDUCE(table, plan)


# ---------------------------------------------------------------------------
# Src-range-bucketed to_items: each pass gathers from a slice of the table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketedSegReducePlan:
    """One :class:`SegReducePlan` per range of source rows: bucket b holds
    the arcs whose source lies in ``spans[b] = (lo, hi)``, with source ids
    local to the range, so its pass reads only the slice ``table[lo:hi]``
    (at the benchmark's shape 8 buckets make slices of about 33 MB, which
    fit in the card's 50 MB L2). The passes chain: the first writes the
    output, each later one adds into it (the kernel's accumulate mode)."""

    buckets: tuple  # SegReducePlan per source range (src local to the range)
    spans: tuple  # ((lo, hi), ...) source rows of each bucket
    n_out: int


def build_bucketed_segreduce_plan(
    src: np.ndarray,
    dst_sorted: np.ndarray,
    w: np.ndarray,
    n_out: int,
    n_src: int,
    n_buckets: int = 8,
    ch: int = 256,
    device: str | torch.device = "cuda",
) -> BucketedSegReducePlan:
    """The JAX package's equal source ranges (``np.linspace(0, n_src,
    n_buckets + 1)``), each a :func:`build_segreduce_plan` over its arcs
    (still sorted by destination). A range may hold no arc. Unlike the JAX
    builder, buckets are not padded to one chunk count: that spared the TPU
    one kernel compile per bucket, and a CUDA launch takes any plan."""
    return _bucketed_plan(src, dst_sorted, w, n_out, n_src, n_buckets, ch, device, SHORT_ROW_ARCS)


def _bucketed_plan(src, dst_sorted, w, n_out: int, n_src: int, n_buckets: int, ch: int, device,
                   short_arcs: int) -> BucketedSegReducePlan:
    """:func:`build_bucketed_segreduce_plan` whose buckets pack rows of at
    most ``short_arcs`` arcs (:func:`_segreduce_plan`)."""
    dev = resolve_device(device)
    src = np.asarray(src)
    dst_sorted = np.asarray(dst_sorted)
    w = np.asarray(w)
    bounds = np.linspace(0, n_src, n_buckets + 1).astype(np.int64)
    plans, spans = [], []
    for b in range(n_buckets):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        m = (src >= lo) & (src < hi)
        plans.append(_segreduce_plan(src[m] - lo, dst_sorted[m], w[m], n_out, ch, dev, short_arcs))
        spans.append((lo, hi))
    return BucketedSegReducePlan(buckets=tuple(plans), spans=tuple(spans), n_out=int(n_out))


def gather_segreduce_bucketed(
    table: torch.Tensor, plan: BucketedSegReducePlan, msgs_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[n_out, D] float32 = Â · table, one pass per bucket over the slice
    ``table[lo:hi]``: :func:`gather_segreduce`'s result up to the order of
    each row's sum (bucket by bucket). The bf16 cast happens once, before
    the first bucket. A CUDA table launches ``csrc/segreduce.cu`` once per
    bucket, every pass after the first in accumulate mode; only a CPU table
    takes the plain version."""
    table = segreduce_table(table, msgs_dtype)
    out = None
    for (lo, hi), p in zip(plan.spans, plan.buckets):
        sub = table[lo:hi]
        if table.device.type == "cpu":
            out = segreduce_plain(sub, p, out)
        else:
            out = SEGREDUCE(sub, p, out)
    if out is None:  # no bucket
        out = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float32, device=table.device)
    return out
