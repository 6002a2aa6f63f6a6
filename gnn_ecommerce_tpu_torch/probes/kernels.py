"""The probes' kernels, each beside its plain PyTorch version.

- K2 :func:`tile_segreduce` (``csrc/tile_segreduce.cu``): the tiled segment
  reduce of ``scripts/proto_segreduce.py:make_seg_reduce``;
- K4 :func:`row_gather` (``csrc/row_gather.cu``): the per-row gather of
  ``scripts/pallas_gather_probe.py:pallas_row_dma_gather``;
- K5 :func:`lane_gather` and K6 :func:`lane_gather_8x512`
  (``csrc/lane_gather.cu``): the lane-axis gather of
  ``scripts/microbench_gather.py:t13`` and
  ``scripts/microbench_gather2.py:t_pallas_lane``.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import torch

from ..device import mm_f32
from ..ops._kernels import LANE_GATHER, ROW_GATHER, TILE_SEGREDUCE

# Chunks whose one-hot the plain K2 builds at once ([B, OT, CH] in the
# messages' type: 256 MB at OT=512, CH=2048 in f32).
PLAIN_CHUNK_BATCH = 64


def tile_segreduce_plain(msgs, seg, tile_map, first, n_tiles: int, ot: int) -> torch.Tensor:
    """The TPU kernel's arithmetic: per chunk a one-hot [OT, CH] times the
    chunk's messages into f32 (bf16 messages through ``device.mm_f32``), each
    tile's sum restarting at every chunk with ``first == 1``. A tile with no
    chunk is zero."""
    e_pad, d = msgs.shape
    n_chunks = tile_map.numel()
    ch = e_pad // n_chunks
    seg = seg.reshape(n_chunks, ch).long()
    tile_map, first = tile_map.long(), first.reshape(-1)
    # A chunk counts when no later chunk of its tile resets the sum.
    order = torch.arange(n_chunks, device=msgs.device)
    last_reset = torch.full((n_tiles,), -1, dtype=torch.long, device=msgs.device)
    resets = first == 1
    last_reset.scatter_reduce_(0, tile_map[resets], order[resets], "amax")
    keep = order >= last_reset[tile_map]
    out = torch.zeros(n_tiles, ot, d, dtype=torch.float32, device=msgs.device)
    rows = torch.arange(ot, device=msgs.device)
    for lo in range(0, n_chunks, PLAIN_CHUNK_BATCH):
        hi = min(lo + PLAIN_CHUNK_BATCH, n_chunks)
        onehot = (rows[None, :, None] == seg[lo:hi, None, :]).to(msgs.dtype)
        block = msgs[lo * ch : hi * ch].reshape(hi - lo, ch, d)
        part = torch.stack([mm_f32(onehot[b], block[b]) for b in range(hi - lo)])
        kept = keep[lo:hi]
        out.index_add_(0, tile_map[lo:hi][kept], part[kept])
    return out.reshape(n_tiles * ot, d)


# K2's tolerance against its plain version, as a share of the largest output
# element's Σ|msg|: both sum the same f32 values (or exact products of bf16
# ones) in different orders.
TILE_SEGREDUCE_RTOL = 1e-6


def tile_segreduce_abs_sum(msgs, seg, tile_map, n_tiles: int, ot: int) -> torch.Tensor:
    """[n_tiles·OT, D] f32: each output element's Σ|msg| over every chunk of
    its tile (the scale of K2's tolerance; no chunk is dropped at a reset,
    so it is never below the kept chunks' sum)."""
    ch = msgs.shape[0] // tile_map.numel()
    seg = seg.reshape(-1).long()
    outside = (seg < 0) | (seg >= ot)  # summed nowhere
    rows = tile_map.long().repeat_interleave(ch) * ot + seg.masked_fill(outside, 0)
    vals = msgs.float().abs().masked_fill_(outside[:, None], 0.0)
    out = torch.zeros(n_tiles * ot, msgs.shape[1], dtype=torch.float32, device=msgs.device)
    return out.index_add_(0, rows, vals)


def tile_segreduce(msgs, seg, tile_map, first, n_tiles: int, ot: int) -> torch.Tensor:
    """[n_tiles·OT, D] f32: for every chunk c and position j,
    ``out[tile_map[c]·OT + seg[j]] += float(msgs[j])``, each tile zeroed at
    its chunks with ``first == 1``. ``msgs`` [E_pad, D] f32 or bf16; ``seg``
    E_pad int32 (any shape, C order: the TPU's [n_chunks, 8, CH/8] layout is
    the same); ``tile_map`` (non-decreasing) and ``first`` [n_chunks] int32."""
    seg = seg.reshape(-1)
    if msgs.device.type == "cpu":
        return tile_segreduce_plain(msgs, seg, tile_map, first, n_tiles, ot)
    return TILE_SEGREDUCE(msgs, seg.contiguous(), tile_map, first, n_tiles, ot)


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``."""
    return table.index_select(0, idx)


def row_gather(table, idx, *, k_inflight: int = 8, chunk: int = 1024) -> torch.Tensor:
    """``out[j] = table[idx[j]]``, ``n % chunk == 0`` as in the probe."""
    if idx.numel() % chunk:
        raise ValueError(f"row_gather needs n % chunk == 0, got {idx.numel()} % {chunk}")
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    return ROW_GATHER(table, idx, k_inflight=k_inflight, chunk=chunk)


def lane_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[:, idx]`` over the flattened (C-order) indices."""
    return tab.index_select(1, idx.reshape(-1))


def _lane_gather(tab, idx, layout: str) -> torch.Tensor:
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx)
    return LANE_GATHER(tab, idx, layout)


def lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[r, j] = tab[r, idx[0, j]]`` for indices laid out [1, n]."""
    if idx.dim() != 2 or idx.shape[0] != 1:
        raise ValueError(f"lane_gather takes [1, n] indices, got {tuple(idx.shape)}")
    return _lane_gather(tab, idx, "1xn")


def lane_gather_8x512(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6: the same gather for indices laid out [n/512, 512] (blocks of
    [8, 512], each the next 4,096 indices in C order)."""
    if idx.dim() != 2 or idx.shape[1] != 512 or idx.shape[0] % 8:
        raise ValueError(f"lane_gather_8x512 takes [8m, 512] indices, got {tuple(idx.shape)}")
    return _lane_gather(tab, idx, "8x512")
