"""The Hopper designs of K2 (csrc/tile_segreduce.cu), K4
(csrc/row_gather.cu) and K5/K6 (csrc/lane_gather.cu), emulated on the CPU.

The kernels run only on the card; here their fixed orders and schedules are
emulated in numpy from the same host-side choices the wrappers make (vector
width, lane groups, row bands, persistent grid, path by row bytes). K2's summation order is held to its plain version and to the probe
script's Pallas kernel in interpret mode; K4's walk is held to cover every
row once with every index it stages; K5/K6's transposed-table window walk
is held to write every output element once, equal to ``tab[:, idx]``."""
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnn_ecommerce_tpu_torch.device import aligned_len
from gnn_ecommerce_tpu_torch.ops._kernels import LANE_GATHER, ROW_GATHER, TILE_SEGREDUCE
from gnn_ecommerce_tpu_torch.probes import kernels as pk
from gnn_ecommerce_tpu_torch.probes.proto_segreduce import build_plan

torch.set_num_threads(1)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
F32 = np.float32
WARPS = 16  # K2's warps a block


def _lower_bound(a, v) -> int:
    return int(np.searchsorted(a, v, side="left"))


def _runs(rows: np.ndarray, seg: np.ndarray) -> list:
    """The runs of equal seg over a slice's rows in order, each summed from
    0 in row order, as the lane group that walks the slice sums it."""
    out, start = [], 0
    for k in range(1, len(seg) + 1):
        if k == len(seg) or seg[k] != seg[start]:
            total = np.zeros(rows.shape[1], F32)
            for j in range(start, k):
                total = total + rows[j]
            out.append((int(seg[start]), total))
            start = k
    return out


def k2_emulate(msgs, seg, tile_map, first, n_tiles, ot, *, vec, splits, bands):
    """csrc/tile_segreduce.cu's sums, in its fixed order, in f32 numpy."""
    e_pad, d = msgs.shape
    n_chunks = len(tile_map)
    ch = e_pad // n_chunks
    groups = TILE_SEGREDUCE.lane_groups(d, vec)
    band_rows = -(-ot // bands)
    out = np.zeros((n_tiles * ot, d), F32)
    partial = np.zeros((n_tiles, splits, ot, d), F32)
    written = np.zeros((n_tiles, splits, bands), bool)
    reset = np.zeros((n_tiles, splits), bool)
    for t in range(n_tiles):
        lo, hi = _lower_bound(tile_map, t), _lower_bound(tile_map, t + 1)
        for s in range(splits):
            c_lo, c_hi = lo + (hi - lo) * s // splits, lo + (hi - lo) * (s + 1) // splits
            resets = [c for c in range(c_lo, c_hi) if first[c] == 1]
            start = resets[-1] if resets else c_lo
            reset[t, s] = bool(resets)
            a0, a1 = start * ch, c_hi * ch
            for b in range(bands):
                blo, bhi = b * band_rows, min(ot, (b + 1) * band_rows)
                acc = np.zeros((bhi - blo, d), F32)
                p0 = a0
                while p0 < a1:
                    desc = np.flatnonzero(seg[p0 + 1 : a1] < seg[p0 : a1 - 1])
                    p1 = p0 + 1 + int(desc[0]) if len(desc) else a1
                    q0, q1 = p0, p1
                    if bands > 1:
                        q0 = p0 + _lower_bound(seg[p0:p1], blo)
                        q1 = q0 + _lower_bound(seg[q0:p1], bhi)
                    written[t, s, b] |= q1 > q0
                    n = q1 - q0
                    n_eff = min(WARPS * groups, n)
                    slots = {}
                    for i in range(n_eff):
                        j0, j1 = q0 + n * i // n_eff, q0 + n * (i + 1) // n_eff
                        runs = _runs(msgs[j0:j1], seg[j0:j1])
                        slots[2 * i] = runs[0]
                        if len(runs) > 1:
                            slots[2 * i + 1] = runs[-1]
                        for row, val in runs[1:-1]:
                            if blo <= row < bhi:
                                acc[row - blo] = acc[row - blo] + val
                    # Edge runs: a slot starts a row when its seg is in the band
                    # and differs from the previous written slot's.
                    order = sorted(slots)
                    starts = [
                        e for k, e in enumerate(order)
                        if blo <= slots[e][0] < bhi and (k == 0 or slots[order[k - 1]][0] != slots[e][0])
                    ]
                    for k, e0 in enumerate(starts):
                        e1 = starts[k + 1] if k + 1 < len(starts) else 2 * n_eff
                        row = slots[e0][0]
                        tot = np.zeros(d, F32)
                        for e in range(e0, e1):
                            if e in slots and slots[e][0] == row:
                                tot = tot + slots[e][1]
                        acc[row - blo] = acc[row - blo] + tot
                    p0 = p1
                if splits == 1:
                    out[t * ot + blo : t * ot + bhi] = acc
                elif written[t, s, b]:
                    partial[t, s, blo:bhi] = acc
        if splits > 1:
            s0 = max([s for s in range(splits) if reset[t, s]], default=0)
            for r in range(ot):
                tot = np.zeros(d, F32)
                for s in range(s0, splits):
                    if written[t, s, r // band_rows]:
                        tot = tot + partial[t, s, r]
                out[t * ot + r] = tot
    return out


def _layout_case(seed, n_tiles, ot, ch, d, sorted_seg):
    """seg in any order (or non-decreasing within each tile's chunks, as a
    plan makes it) and partly outside [0, OT), resets mid-tile, a tile
    with no chunk."""
    rng = np.random.default_rng(seed)
    tiles = [t for t in range(n_tiles) if t != 1]  # tile 1 has no chunk
    tile_map = np.sort(rng.choice(tiles, 5 * n_tiles)).astype(np.int32)
    first = (rng.random(len(tile_map)) < 0.3).astype(np.int32)
    seg = rng.integers(-2, ot + 2, len(tile_map) * ch).astype(np.int32)
    if sorted_seg:
        for t in tiles:
            idx = np.flatnonzero(np.repeat(tile_map, ch) == t)
            seg[idx] = np.sort(seg[idx])
    msgs = rng.standard_normal((len(seg), d)).astype(np.float32)
    return msgs, seg, tile_map, first


def _tolerance(msgs, seg, tile_map, n_tiles, ot):
    scale = pk.tile_segreduce_abs_sum(
        torch.from_numpy(msgs), torch.from_numpy(seg), torch.from_numpy(tile_map), n_tiles, ot
    ).max().item()
    return pk.TILE_SEGREDUCE_RTOL * scale


@pytest.mark.parametrize(
    "d,dtype,vec,splits,bands,sorted_seg",
    [
        (80, "bfloat16", 8, 1, 2, True),   # to_users' layout: 3 lane groups, two bands
        (80, "bfloat16", 8, 3, 1, True),   # to_items': splits
        (80, "float32", 4, 2, 3, True),    # one group of 20 lanes
        (8, "bfloat16", 8, 1, 2, True),    # one vector a row: 32 groups
        (8, "float32", 4, 2, 1, False),    # any seg order
        (33, "bfloat16", 1, 3, 1, False),  # 33 vectors: one group, 2 a lane
        (33, "float32", 1, 1, 2, True),
        (128, "bfloat16", 8, 2, 1, False),
        (128, "float32", 4, 1, 3, True),
        (90, "bfloat16", 2, 2, 2, True),   # D not a multiple of 16 bytes
    ],
)
def test_tile_segreduce_kernel_order_matches_plain(d, dtype, vec, splits, bands, sorted_seg):
    """The kernel's summation order (slices, edge runs, bands, splits and
    their combine) gives the plain version's sums within K2's tolerance, on
    layouts with seg outside [0, OT), resets mid-tile and a tile with no
    chunk; the plain version is the sequential grid's arithmetic."""
    n_tiles, ot, ch = 4, 24, 40
    msgs, seg, tile_map, first = _layout_case(d + splits + bands, n_tiles, ot, ch, d, sorted_seg)
    tmsgs = torch.from_numpy(msgs).to(getattr(torch, dtype))
    msgs = tmsgs.float().numpy()  # the values the kernel adds
    want = pk.tile_segreduce_plain(
        tmsgs, *(torch.from_numpy(a) for a in (seg, tile_map, first)), n_tiles, ot
    ).numpy()
    got = k2_emulate(msgs, seg, tile_map, first, n_tiles, ot, vec=vec, splits=splits, bands=bands)
    assert not got[ot : 2 * ot].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tolerance(msgs, seg, tile_map, n_tiles, ot))


@functools.lru_cache(maxsize=None)
def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_redesign_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_segreduce_kernel_order_matches_interpret_mode_probe(monkeypatch, dtype):
    """On a probe plan, with the wrapper's own choices of vector width,
    bands and splits, the emulated kernel agrees with the script's one-hot
    kernel in interpret mode."""
    OT, CH, D = 128, 256, 80
    rng = np.random.default_rng(3)
    dst = np.sort(rng.integers(0, 600, 3000).astype(np.int32))
    src = rng.integers(0, 300, 3000).astype(np.int32)
    plan = build_plan(src, dst, rng.random(3000).astype(np.float32), 600, OT, CH)
    msgs = (rng.standard_normal((300, D)).astype(np.float32)[plan["gidx"]] * plan["gw"][:, None])
    msgs = np.array(jnp.asarray(msgs, getattr(jnp, dtype)).astype(jnp.float32))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    f = _script("proto_segreduce").make_seg_reduce(
        OT, CH, D, plan["n_tiles"], plan["n_chunks"], getattr(jnp, dtype)
    )
    ref = np.asarray(f(
        jnp.asarray(plan["tile_map"]), jnp.asarray(plan["first"]),
        jnp.asarray(plan["seg"].reshape(-1, 8, CH // 8)), jnp.asarray(msgs, getattr(jnp, dtype)),
    ))
    vec = TILE_SEGREDUCE.vector_width(torch.from_numpy(msgs).to(getattr(torch, dtype)))
    n_tiles = plan["n_tiles"]
    got = k2_emulate(
        msgs, plan["seg"], plan["tile_map"], plan["first"], n_tiles, OT, vec=vec,
        splits=TILE_SEGREDUCE.n_splits(n_tiles, plan["n_chunks"]), bands=TILE_SEGREDUCE.n_bands(OT, D, vec),
    )
    atol = _tolerance(msgs, plan["seg"], plan["tile_map"], n_tiles, OT)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_tile_segreduce_host_choices_on_the_probe_plans():
    """The probe's plans: 16-byte vectors (8 bf16, 4 f32 columns), 3 lane
    groups at D 80 bf16, two bands of 256 rows so that two blocks fit an
    SM; to_items split 10 ways, to_users not at all."""
    bf16, f32 = torch.zeros(16, 80, dtype=torch.bfloat16), torch.zeros(16, 80)
    assert TILE_SEGREDUCE.vector_width(bf16) == 8 and TILE_SEGREDUCE.vector_width(f32) == 4
    assert TILE_SEGREDUCE.lane_groups(80, 8) == 3 and TILE_SEGREDUCE.lane_groups(80, 4) == 1
    assert TILE_SEGREDUCE.n_splits(107, 5010) == 10 and TILE_SEGREDUCE.n_splits(3202, 6404) == 1
    for vec in (8, 4):
        assert TILE_SEGREDUCE.n_bands(512, 80, vec) == 2
        assert TILE_SEGREDUCE.shared_bytes(256, 80, vec) <= TILE_SEGREDUCE.TWO_BLOCKS_SHARED_BYTES
        assert TILE_SEGREDUCE.shared_bytes(512, 80, vec) > TILE_SEGREDUCE.TWO_BLOCKS_SHARED_BYTES


@pytest.mark.parametrize("offset,d,dtype,want", [
    (0, 90, torch.bfloat16, 2), (1, 80, torch.bfloat16, 1), (2, 80, torch.bfloat16, 2),
    (4, 80, torch.bfloat16, 4), (0, 33, torch.float32, 1), (2, 80, torch.float32, 2),
    (0, 128, torch.float32, 4), (0, 8, torch.bfloat16, 8),
])
def test_tile_segreduce_vector_width_follows_d_and_alignment(offset, d, dtype, want):
    """The widest vector of at most 16 bytes that divides a row and the
    base address."""
    msgs = torch.zeros(4 * d + offset, dtype=dtype)[offset:].view(4, d)
    assert TILE_SEGREDUCE.vector_width(msgs) == want


def _bulk_walk(n: int, chunk: int, blocks: int, idx_base: int) -> tuple:
    """csrc/row_gather.cu's bulk path, host-side: block b copies rows
    [n·b/G, n·(b+1)/G) in windows of `chunk`, window i's indices staged as
    their 16-byte covering span in half i % 2 of a double buffer of
    ``bulk_index_stride(chunk)`` indices a half. Returns the rows each block
    copies, per row the index position it staged, and the halves used."""
    rows, staged, halves = [], {}, set()
    stride = ROW_GATHER.bulk_index_stride(chunk)
    for b in range(blocks):
        r0, r1 = n * b // blocks, n * (b + 1) // blocks
        rows.append(np.arange(r0, r1))
        for i in range(-(-(r1 - r0) // chunk)):
            lo_row = r0 + i * chunk
            length = min(chunk, r1 - lo_row)
            first = idx_base + 4 * lo_row
            lo, hi = first & ~15, (first + 4 * length + 15) & ~15
            assert (hi - lo) % 16 == 0 and (hi - lo) // 4 <= stride
            halves.add(i % 2)
            ioff = (first - lo) // 4
            for r in range(length):
                staged[lo_row + r] = (lo - idx_base) // 4 + ioff + r  # buffer slot's index position
    return rows, staged, halves


@pytest.mark.parametrize("n,chunk,sms", [
    (1024 * 37, 1024, 132), (2048 * 5, 2048, 132), (4096, 1024, 2), (63, 7, 3),
    (7 * 40, 7, 3), (5 * (3 * 4 * 132 + 1), 5, 132),  # several windows a block, both halves
])
@pytest.mark.parametrize("idx_base", [0, 4, 12])
def test_row_gather_bulk_walk_covers_every_row_once(n, chunk, sms, idx_base):
    """For n / chunk above and below the grid's block count: every row is
    copied by one block, once, with its own index; a block with more than
    one window uses both halves of its index buffer."""
    shared = ROW_GATHER.bulk_shared_bytes(8, 4096, chunk)
    blocks = ROW_GATHER.grid(n // chunk, sms, shared)
    assert 1 <= blocks <= n // chunk
    rows, staged, halves = _bulk_walk(n, chunk, blocks, idx_base)
    every = np.concatenate(rows)
    np.testing.assert_array_equal(np.sort(every), np.arange(n))
    assert max(map(len, rows)) - min(map(len, rows)) <= 1  # no block waits on a longer share
    assert all(staged[r] == r for r in range(n))
    assert halves == ({0, 1} if max(map(len, rows)) > chunk else {0})


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 7, 13, 1023, 1024, 2047, 12_288])
@pytest.mark.parametrize("k,row_bytes", [(4, 1024), (8, 4096), (16, 4096), (8, 256)])
def test_row_gather_bulk_shared_layout_is_aligned(chunk, k, row_bytes):
    """The bulk block's shared memory (ring | two index halves | barriers):
    each half holds a window's covering span and starts 16-byte aligned, as
    a bulk copy's destination must, at any chunk; the barriers are 8-byte
    aligned; bulk_shared_bytes adds up the same layout."""
    stride = ROW_GATHER.bulk_index_stride(chunk)
    assert stride >= chunk + 8 and stride % 4 == 0
    ring = k * row_bytes
    halves = [ring, ring + 4 * stride]
    barriers = ring + 8 * stride
    assert all(start % 16 == 0 for start in halves) and barriers % 8 == 0
    assert ROW_GATHER.bulk_shared_bytes(k, row_bytes, chunk) == barriers + (k + 2) * 8


def test_row_gather_grid_and_path_choices():
    """The bulk path runs BULK_BLOCKS_PER_SM blocks an SM (fewer where their
    shared memory does not fit), at most one per index block; rows of 1 KB
    or more take it, narrower rows the lane path."""
    per_sm = ROW_GATHER.BULK_BLOCKS_PER_SM
    assert ROW_GATHER.grid(1024, 132, ROW_GATHER.bulk_shared_bytes(8, 4096, 1024)) == min(1024, per_sm * 132)
    assert ROW_GATHER.grid(100, 132, ROW_GATHER.bulk_shared_bytes(8, 4096, 1024)) == 100
    big = ROW_GATHER.bulk_shared_bytes(16, 4096, 12_288)  # 163 KB: one a SM
    assert ROW_GATHER.grid(10_000, 132, big) == 132
    assert ROW_GATHER.path(4096) == "bulk" and ROW_GATHER.path(1024) == "bulk"
    assert ROW_GATHER.path(256) == "lanes" and ROW_GATHER.path(16) == "lanes"


@pytest.mark.parametrize("kwargs,match", [
    ({"chunk": 12_289}, "chunk <="),
    ({"k_inflight": 6}, "k_inflight in"),
    ({"chunk": 0}, "chunk <="),
])
def test_row_gather_arguments_are_checked(kwargs, match):
    before = dict(ROW_GATHER.launches)
    with pytest.raises(ValueError, match=match):
        ROW_GATHER(torch.zeros(4, 8), torch.zeros(1024, dtype=torch.int32), **kwargs)
    assert ROW_GATHER.launches == before


# ------------------------------------------------- K5/K6 (csrc/lane_gather.cu)

LANE_THREADS = 256  # the gather pass's threads a block


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the 8 bytes (y << 32) | x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _max_way(groups, addrs) -> int:
    """The most distinct 16-byte piece addresses that one group (a quarter
    warp's one instruction) puts on one of the 8 16-byte bank groups."""
    pairs = np.unique(np.stack([groups, addrs]), axis=1)
    _, counts = np.unique(np.stack([pairs[0], pairs[1] % 8]), axis=1, return_counts=True)
    return int(counts.max())


class _Buffers:
    """The order rules of the gather pass's double buffers: a cp.async lands
    at the next wait and is seen by every thread after the barrier that
    follows it; a buffer read since the last barrier takes no copy."""

    def __init__(self):
        self.tag, self.state, self.read_since_sync = {}, {}, set()

    def copy(self, key, win):
        assert key not in self.read_since_sync, f"{key} refilled while it may still be read"
        self.tag[key], self.state[key] = win, "pending"

    def wait_all(self):
        self.state = {k: "landed" if s == "pending" else s for k, s in self.state.items()}

    def sync(self):
        self.state = {k: "seen" if s == "landed" else s for k, s in self.state.items()}
        self.read_since_sync.clear()

    def read(self, key, win):
        assert self.state.get(key) == "seen" and self.tag[key] == win, (key, win, self.tag.get(key))
        self.read_since_sync.add(key)


def lane_bands(d: int) -> list:
    """(first row, rows) of each band of the padded table: BAND_ROWS rows
    each but the last, one grid row of the gather pass each."""
    dp = aligned_len(d, torch.bfloat16)
    return [(r0, min(LANE_GATHER.BAND_ROWS, dp - r0)) for r0 in range(0, dp, LANE_GATHER.BAND_ROWS)]


def lane_gather_emulate(tab, idx, blocks: int):
    """csrc/lane_gather.cu's two passes in numpy, on uint16 patterns: the
    transpose into [ni, dp] (pad zero), then per band and block of the
    persistent grid its walk over windows x, x + G, ... with the double
    buffers' order checked (:class:`_Buffers`), the fill walk stepped per
    thread as the kernel steps it, the rotated tile layout, and the 8x8
    byte-permute transpose. Returns (out, writes per element, the most
    pieces a quarter warp's fill and read instructions put on one bank
    group, per band's pieces a row P)."""
    d, ni = tab.shape
    n = len(idx)
    dp = aligned_len(d, torch.bfloat16)
    tab_t = np.zeros((ni, dp), np.uint16)
    tab_t[:, :d] = tab.T
    out = np.zeros((d, n), np.uint16)
    writes = np.zeros((d, n), np.int64)
    window = LANE_GATHER.WINDOW
    log2_jb = window.bit_length() - 1 - 3
    n_windows = -(-n // window)
    pmax = lane_bands(d)[0][1] // 8
    ways = {}
    for r0, rows in lane_bands(d):
        P = rows // 8
        rotate = P >= 8
        fill_ways = read_ways = 1
        for x in range(min(blocks, n_windows)):
            bufs = _Buffers()
            idx_s = np.zeros((2, window), np.int64)
            tile = np.zeros((2, window * pmax, 8), np.uint16)
            tid = np.arange(LANE_THREADS)

            def rows_in(win):
                return min(window, n - win * window)

            def load_idx(win, b):
                bufs.copy(("idx", b), win)
                jn = rows_in(win)
                assert jn % 4 == 0  # whole 16-byte pieces
                idx_s[b, :jn] = idx[win * window : win * window + jn]

            def load_rows(win, b):
                nonlocal fill_ways
                bufs.read(("idx", b), win)
                bufs.copy(("tile", b), win)
                jn = rows_in(win)
                filled = np.zeros(jn * P, np.int64)
                jj, c = tid // P, tid % P
                djj, dc = LANE_THREADS // P, LANE_THREADS % P
                while (jj < jn).any():
                    live = jj < jn
                    j, cc = jj[live], c[live]
                    ph = cc + ((j >> 3) & 7 if rotate else 0)
                    ph = np.where(ph >= P, ph - P, ph)
                    assert (ph < P).all()
                    slot = j * P + ph
                    np.add.at(filled, slot, 1)
                    tile[b, slot] = tab_t[idx_s[b, j][:, None], r0 + 8 * cc[:, None] + np.arange(8)]
                    fill_ways = max(fill_ways, _max_way(tid[live] // 8, slot))
                    jj, c = jj + djj, c + dc
                    wrap = c >= P
                    c, jj = np.where(wrap, c - P, c), np.where(wrap, jj + 1, jj)
                assert (filled == 1).all()  # every piece of the window, once

            def store(win, b):
                nonlocal read_ways
                bufs.read(("tile", b), win)
                jn, j0 = rows_in(win), win * window
                u = np.arange(P << log2_jb)
                rb, jb = u >> log2_jb, u & ((1 << log2_jb) - 1)
                live = 8 * jb < jn
                u, rb, jb = u[live], rb[live], jb[live]
                ph = rb + (jb & 7 if rotate else 0)
                ph = np.where(ph >= P, ph - P, ph)
                slots = (8 * jb[:, None] + np.arange(8)) * P + ph[:, None]  # [U, v]
                for v in range(8):  # one 16-byte read instruction each
                    read_ways = max(read_ways, _max_way((u // LANE_THREADS) * 32 + (u % LANE_THREADS) // 8,
                                                        slots[:, v]))
                block = tile[b, slots].astype(np.uint32)  # [U, v = j, 8 table rows]
                a = block[..., 0::2] | (block[..., 1::2] << 16)  # [U, v, word m]
                for q in range(8):
                    r = r0 + 8 * rb + q
                    sel = 0x7632 if q & 1 else 0x5410
                    words = np.stack([_byte_perm(a[:, 2 * k, q >> 1], a[:, 2 * k + 1, q >> 1], sel)
                                      for k in range(4)], axis=1)
                    vals = np.stack([words & 0xFFFF, words >> 16], axis=2).reshape(-1, 8).astype(np.uint16)
                    keep = r < d
                    cols = j0 + 8 * jb[keep, None] + np.arange(8)
                    out[r[keep, None], cols] = vals[keep]
                    np.add.at(writes, (np.broadcast_to(r[keep, None], cols.shape), cols), 1)

            w = x
            load_idx(w, 0)
            bufs.wait_all()
            bufs.sync()
            load_rows(w, 0)
            if w + blocks < n_windows:
                load_idx(w + blocks, 1)
            b = 0
            while True:
                bufs.wait_all()
                bufs.sync()
                nxt = w + blocks
                if nxt < n_windows:
                    load_rows(nxt, b ^ 1)
                    if nxt + blocks < n_windows:
                        load_idx(nxt + blocks, b)
                store(w, b)
                if nxt >= n_windows:
                    break
                bufs.sync()
                w, b = nxt, b ^ 1
        ways[P] = (fill_ways, read_ways)
    return out, writes, ways


def _lane_case(seed: int, d: int, ni: int, n: int):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 1 << 16, (d, ni), dtype=np.uint16)
    idx = rng.integers(0, ni, n).astype(np.int32)
    idx[0], idx[-1] = 0, ni - 1
    return tab, idx


J = LANE_GATHER.WINDOW


@pytest.mark.parametrize("n", [8, J - 8, J + 8, 3 * J + 8])
@pytest.mark.parametrize("d", [1, 7, 8, 80, 129, 200])
def test_lane_gather_walk_writes_each_element_once(d, n):
    """Bands of at most 128 rows, windows of J with a ragged last one, two
    blocks a band walking their windows through both buffers: each output
    element is written once and equals tab[:, idx]; the gather pass reads
    the index stream once per band."""
    tab, idx = _lane_case(d * 1000 + n, d, 1000, n)
    out, writes, _ = lane_gather_emulate(tab, idx, blocks=2)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(out, tab[:, idx])
    assert len(lane_bands(d)) == -(-d // 128)


@pytest.mark.parametrize("blocks", [1, 3, 5, 40])
@pytest.mark.parametrize("d", [16, 80, 136])
def test_lane_gather_walk_other_grids(d, blocks):
    """Grids of one block (every window through one block's two buffers)
    to more blocks than windows: the same result."""
    tab, idx = _lane_case(blocks + d, d, 300, 5 * J + 40)
    out, writes, _ = lane_gather_emulate(tab, idx, blocks)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(out, tab[:, idx])


@pytest.mark.parametrize("d", [64, 80, 96, 128, 200])
def test_lane_gather_tile_rotation_keeps_bank_conflicts_low(d):
    """With P >= 8 pieces a row the rotated tile gives a quarter warp's
    16-byte reads at most 2 pieces to a bank group (none shared when
    P % 8 == 0), and its fills at most 2."""
    tab, idx = _lane_case(d, d, 500, 2 * J)
    _, _, ways = lane_gather_emulate(tab, idx, blocks=1)
    for p, (fill, read) in ways.items():
        assert fill <= 2 and read <= (1 if p % 8 == 0 else 2), (p, fill, read)


def test_lane_gather_shared_memory_fits_at_every_d():
    """The gather block's shared memory (two windows of indices, two tiles
    of the widest band) fits a block's 227 KB at any d, as the kernel
    assumes; at the probes' d = 80 (one band of 80 rows, 160-byte
    transposed rows) it is 82 KB, two blocks an SM."""
    def shared(d):
        return 2 * J * 4 + 2 * J * lane_bands(d)[0][1] * 2

    assert aligned_len(80, torch.bfloat16) == 80 and lane_bands(80) == [(0, 80)]
    assert aligned_len(7, torch.bfloat16) == 8 and lane_bands(200) == [(0, 128), (128, 72)]
    per_sm, reserved = 233_472, 1024  # an SM's shared memory, a block's reserve
    assert shared(80) == 83_968 and 2 * (shared(80) + reserved) <= per_sm < 3 * (shared(80) + reserved)
    assert max(shared(d) for d in (1, 128, 129, 65_535)) == shared(128) <= 232_448
