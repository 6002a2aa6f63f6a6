"""The SpMM pair of the fast bipartite forward.

Counterpart of ``gnn_ecommerce_tpu/ops/spmm_fast.py``:

- ``to_items = Â_iu · x_users`` (gather from the big user table, reduce over
  items) runs the hand-written CUDA segment reduce ``csrc/segreduce.cu``
  through :func:`gather_segreduce`, over a CSR-over-items plan of the arcs
  (:func:`build_segreduce_plan`) cut into chunks of at most ``ch`` arcs;
- ``to_users = Â_ui · x_items`` (gather from the small item table) is the
  degree-binned ELL gather + width-sum :func:`ell_apply` in plain torch, as
  the JAX package leaves it to XLA.

Both are exact restructurings of the segment sum; only the summation order
differs. The src-bucketed plan of the JAX package is a rejected design and
is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ._kernels import SEGREDUCE

# ---------------------------------------------------------------------------
# Degree-binned ELL (gather + width-sum; no scatter)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """Rows grouped into degree bins; each bin is a dense [rows_b, W_b]
    (index, weight) pair. Outputs come back in bin order and are un-permuted
    by one row gather at ``inv_order``."""

    idx: tuple  # per bin: [rows_b, W_b] int32 rows of the table
    w: tuple  # per bin: [rows_b, W_b] float32 normalized weights (0 = pad)
    inv_order: torch.Tensor  # [n_out] int32; out = cat(bin outs)[inv_order]
    n_out: int
    widths: tuple


def _ell_widths(max_deg: int) -> list[int]:
    """×1.5 width schedule (1, 2, 3, 5, 8, 12, 18, ...)."""
    ws, W = [1, 2, 3], 3
    while W < max_deg:
        W = int(np.ceil(W * 1.5))
        ws.append(W)
    return ws


def build_ell_plan(
    indptr: np.ndarray,
    src: np.ndarray,
    w: np.ndarray,
    n_out: int,
    device: str | torch.device = "cuda",
) -> EllPlan:
    """Build from a CSR over destinations (``indptr`` [n_out+1] into
    dst-sorted ``src``/``w`` arc arrays)."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    order = native.ell_sort_by_degree(indptr)
    dsort = deg[order]
    idx_bins, w_bins, widths = [], [], []
    lo = 0
    for W in _ell_widths(int(dsort[-1]) if n_out else 1):
        if lo >= n_out:
            break
        hi = int(np.searchsorted(dsort, W, side="right"))
        if hi <= lo:
            continue
        ib, wb = native.ell_fill_bin(indptr, src, w, order[lo:hi], W)
        idx_bins.append(torch.from_numpy(ib).to(dev))
        w_bins.append(torch.from_numpy(wb).to(dev))
        widths.append(W)
        lo = hi
    inv = np.empty(n_out, np.int32)
    inv[order] = np.arange(n_out, dtype=np.int32)
    return EllPlan(
        idx=tuple(idx_bins),
        w=tuple(w_bins),
        inv_order=torch.from_numpy(inv).to(dev),
        n_out=int(n_out),
        widths=tuple(widths),
    )


def ell_apply(
    table: torch.Tensor, plan: EllPlan, gather_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """[n_out, D] float32 = Â · table via per-bin gather + width-sum.

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


# ---------------------------------------------------------------------------
# to_items: the CUDA segment reduce over a chunked CSR plan
# ---------------------------------------------------------------------------


# A row with more chunks than this is combined by a block of warps, a row
# with fewer by one warp.
LONG_ROW_CHUNKS = 32


@dataclasses.dataclass(frozen=True)
class SegReducePlan:
    """Dst-sorted arcs (a CSR over the ``n_out`` rows), cut into chunks of at
    most ``ch`` arcs that never cross a row. The kernel gives each chunk a
    warp: a row's only chunk writes the output row itself, the chunks of a
    row with several write partial rows that a second pass adds in a fixed
    order, and that pass also zeroes the rows with no arc. The plain version
    reads ``src``/``dst``/``w`` directly. No padding: every arc is real."""

    src: torch.Tensor  # [E] int32 rows of the table
    dst: torch.Tensor  # [E] int32 output rows, ascending
    w: torch.Tensor  # [E] float32 normalized weights
    chunk_ptr: torch.Tensor  # [n_chunks+1] int64 arc offsets of the chunks
    row_chunk_ptr: torch.Tensor  # [n_out+1] int64 chunk range of each row
    # [n_chunks] int32: the output row of a row's only chunk; -1 - p for a
    # chunk that writes partial row p (a row's chunks take consecutive p).
    chunk_slot: torch.Tensor
    # [n_comb] int32 rows with no chunk or several: the n_long rows of more
    # than LONG_ROW_CHUNKS chunks, then the others, each part ascending.
    comb_rows: torch.Tensor
    comb_ptr: torch.Tensor  # [n_comb+1] int64 partial rows of each comb row
    n_out: int
    n_src: int  # the table needs at least this many rows
    n_partial: int  # partial rows: the chunks of rows with several
    n_long: int  # the first n_long comb rows are each combined by a block

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_ptr.shape[0]) - 1


def build_segreduce_plan(
    src: np.ndarray,
    dst_sorted: np.ndarray,
    w: np.ndarray,
    n_out: int,
    ch: int = 256,
    device: str | torch.device = "cuda",
) -> SegReducePlan:
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst_sorted, dtype=np.int64)
    if len(dst) and (np.any(np.diff(dst) < 0) or dst[0] < 0 or dst[-1] >= n_out):
        raise ValueError("dst_sorted must be ascending ids in [0, n_out)")
    cnt = np.bincount(dst, minlength=n_out)
    indptr = np.concatenate([[0], np.cumsum(cnt)])
    per_row = -(-cnt // ch)
    row_chunk_ptr = np.concatenate([[0], np.cumsum(per_row)])
    chunk_row = np.repeat(np.arange(n_out), per_row)
    k_in_row = np.arange(int(row_chunk_ptr[-1])) - np.repeat(row_chunk_ptr[:-1], per_row)
    chunk_ptr = np.append(indptr[chunk_row] + ch * k_in_row, len(dst))
    long_rows = np.flatnonzero(per_row > LONG_ROW_CHUNKS)
    comb_rows = np.concatenate([long_rows, np.flatnonzero((per_row != 1) & (per_row <= LONG_ROW_CHUNKS))])
    comb_ptr = np.concatenate([[0], np.cumsum(per_row[comb_rows])])
    first_partial = np.zeros(n_out, np.int64)
    first_partial[comb_rows] = comb_ptr[:-1]
    chunk_slot = np.where(
        per_row[chunk_row] == 1, chunk_row, -1 - (first_partial[chunk_row] + k_in_row)
    )

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return SegReducePlan(
        src=put(src, np.int32),
        dst=put(dst, np.int32),
        w=put(w, np.float32),
        chunk_ptr=put(chunk_ptr, np.int64),
        row_chunk_ptr=put(row_chunk_ptr, np.int64),
        chunk_slot=put(chunk_slot, np.int32),
        comb_rows=put(comb_rows, np.int32),
        comb_ptr=put(comb_ptr, np.int64),
        n_out=int(n_out),
        n_src=int(src.max()) + 1 if len(src) else 0,
        n_partial=int(comb_ptr[-1]),
        n_long=len(long_rows),
    )


def segreduce_plain(table: torch.Tensor, plan: SegReducePlan) -> torch.Tensor:
    """Plain torch version of the kernel, same arithmetic: f32 rows times
    f32 weights, or bf16 rows times bf16-rounded weights; products summed
    into f32 by ``index_add_``."""
    w = plan.w
    if table.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    msgs = table.index_select(0, plan.src).float() * w[:, None]
    out = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float32, device=table.device)
    out.index_add_(0, plan.dst, msgs)
    return out


def bf16_row_width(d: int) -> int:
    """Columns of a bf16 row padded to a multiple of 16 bytes (96 for 90)."""
    return -(-d // 8) * 8


def bf16_rows_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the padded cast: the [n, D] bf16 view of a
    zeroed [n, bf16_row_width(D)] buffer holding ``table.to(bfloat16)``."""
    n, d = table.shape
    buf = torch.zeros(n, bf16_row_width(d), dtype=torch.bfloat16, device=table.device)
    buf[:, :d] = table
    return buf[:, :d]


def bf16_rows(table: torch.Tensor) -> torch.Tensor:
    """``table`` rounded to bf16 in rows of a 16-byte stride (pad columns
    zero), so the kernel loads them 16 bytes a lane: the values of
    ``table.to(torch.bfloat16)``. A CUDA f32 table launches the cast kernel
    of ``csrc/segreduce.cu``; only a CPU table takes the plain version. Any
    layout is taken."""
    if table.device.type == "cpu":
        return bf16_rows_plain(table)
    return SEGREDUCE.cast_bf16(table, bf16_row_width(table.shape[1]))


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
