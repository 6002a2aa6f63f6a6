"""Port of ``scripts/microbench_gather.py``: the primitive rates of the
LightGCN hot path on the card.

Sections t1-t14 under the script's keys, each in plain torch where XLA
lowered it: ``index_select`` for ``take`` (random, sorted and small-table
gathers; a dim sweep of 8, 128 and 256), sorted ``segment_reduce`` for
``segment_sum``, ``index_add_`` for the scatter-adds, ``index_select``
along axis 1 for the lane gather, a batched one-hot product for the MXU
expand. ``t13``, the Pallas lane gather, runs K5
(``csrc/lane_gather.cu``) and is checked against ``index_select``.
Shapes are the script's (10,157,407 arcs, 1,639,358 users, 54,571 items,
dim 80); on the CPU they are cut to ``SMALL``.

    python -m gnn_ecommerce_tpu_torch.probes.microbench_gather [--out x.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ._timing import Probe, cli
from .kernels import lane_gather

E = 10_157_407
NU = 1_639_358
NI = 54_571
SMALL = {"E": 20_000, "NU": 5_000, "NI": 600}
TILE = 4096  # the lane gather's indices per block


def sizes(device: torch.device) -> dict:
    return {"E": E, "NU": NU, "NI": NI} if device.type == "cuda" else dict(SMALL)


def gather(table, idx):
    return torch.index_select(table, 0, idx)


def segsum_sorted(msgs, lengths):
    """``segment_sum(..., indices_are_sorted=True)``: sums of consecutive
    runs of ``lengths`` rows."""
    return torch.segment_reduce(msgs, "sum", lengths=lengths)


def scatter_add(msgs, idx, n_out):
    return torch.zeros(n_out, msgs.shape[1], dtype=msgs.dtype, device=msgs.device).index_add_(
        0, idx, msgs
    )


def to_items_like(table, src, lengths, w, msgs_f32=False):
    """gather + weight + sorted segment sum (``msgs_f32``: bf16 rows made f32
    before the weight, the script's ``to_items_bf16gather``)."""
    rows = gather(table, src)
    if msgs_f32:
        rows = rows.float()
    return segsum_sorted(rows * w[:, None], lengths)


def onehot_expand(loc, chunks, c: int):
    """``einsum("tec,tcd->ted", onehot(loc), chunks)``: each output row has
    one non-zero product, so the bf16 product is exact."""
    oh = (loc[:, :, None] == torch.arange(c, device=loc.device)).to(chunks.dtype)
    return torch.bmm(oh, chunks)


def main(device="cuda", *, reps: int = 4) -> dict:
    """Run t1-t14 on ``device``; returns the script's keys."""
    probe = Probe(device, reps)
    dev, res = probe.device, probe.results
    s = sizes(dev)
    n_arcs, n_users, n_items = s["E"], s["NU"], s["NI"]
    res["shapes"] = s
    rng = np.random.default_rng(0)
    src_rand_np = rng.integers(0, n_users, n_arcs).astype(np.int32)
    item_rand_np = rng.integers(0, n_items, n_arcs).astype(np.int32)
    src_rand = torch.from_numpy(src_rand_np).to(dev)
    src_sorted = torch.from_numpy(np.sort(src_rand_np)).to(dev)
    item_rand = torch.from_numpy(item_rand_np).to(dev)
    item_sorted_np = np.sort(item_rand_np)
    item_lengths = torch.from_numpy(np.bincount(item_sorted_np, minlength=n_items)).to(dev)
    w = torch.from_numpy(rng.random(n_arcs, dtype=np.float32)).to(dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    U80 = torch.randn(n_users, 80, generator=gen, device=dev)
    U80b = U80.to(torch.bfloat16)
    I80 = torch.randn(n_items, 80, generator=gen, device=dev)
    I80b = I80.to(torch.bfloat16)

    def rec(name, fn, rows=n_arcs, row_bytes=None, **extra):
        ms = probe.time(fn)
        probe.record(name, ms, rows, None if row_bytes is None else rows * row_bytes, **extra)

    for name, table, idx in (
        ("gather_rand_big_f32d80", U80, src_rand),
        ("gather_rand_big_bf16d80", U80b, src_rand),
        ("gather_sorted_big_f32d80", U80, src_sorted),
        ("gather_rand_small_f32d80", I80, item_rand),
        ("gather_rand_small_bf16d80", I80b, item_rand),
    ):
        probe.section(name, lambda name=name, table=table, idx=idx: rec(
            name, lambda: gather(table, idx), row_bytes=table[0].numel() * table.element_size()))
    # XLA's indices_are_sorted flag has no torch counterpart: the flagged
    # gather is the sorted one, so its key repeats that measurement.
    if "gather_sorted_big_f32d80" in res:
        res["gather_sorted_flagged_big_f32d80"] = {
            **res["gather_sorted_big_f32d80"], "same_as": "gather_sorted_big_f32d80"}

    for d in (8, 128, 256):
        def td(d=d):
            T = torch.randn(n_users, d, generator=gen, device=dev)
            rec(f"gather_rand_big_f32d{d}", lambda: gather(T, src_rand), row_bytes=d * 4)
        probe.section(f"gather_rand_big_f32d{d}", td)

    probe.section("to_items_like", lambda: rec(
        "to_items_like", lambda: to_items_like(U80, src_rand, item_lengths, w), row_bytes=320))
    probe.section("to_items_bf16gather", lambda: rec(
        "to_items_bf16gather", lambda: to_items_like(U80b, src_rand, item_lengths, w, True),
        row_bytes=160))

    def t9():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("segsum_sorted_items", lambda: segsum_sorted(M, item_lengths), row_bytes=320)
    probe.section("segsum_sorted_items", t9)

    def t10():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("scatter_rand_small", lambda: scatter_add(M, item_rand, n_items), row_bytes=320)
    probe.section("scatter_rand_small", t10)

    def t11():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("scatter_rand_big", lambda: scatter_add(M, src_rand, n_users), row_bytes=320)
    probe.section("scatter_rand_big", t11)

    def t12():
        Tt = I80b.t().contiguous()  # [80, NI]
        rec("lane_gather_xla_small", lambda: torch.index_select(Tt, 1, item_rand), row_bytes=160)
    probe.section("lane_gather_xla_small", t12)

    def t13():
        n_tiles = n_arcs // TILE  # drop the remainder, as the script does
        tab = I80b.t().contiguous()
        idx2d = item_rand[: n_tiles * TILE].reshape(1, -1)
        exact = torch.equal(lane_gather(tab, idx2d), torch.index_select(tab, 1, idx2d[0]))
        assert exact, "lane_gather differs from index_select"
        rec("pallas_lane_gather_small", lambda: lane_gather(tab, idx2d), rows=n_tiles * TILE,
            row_bytes=160, exact=exact)
    probe.section("pallas_lane_gather_small", t13)

    def t14():
        C, T = 128, 512
        n_tiles = n_arcs // T
        loc = torch.from_numpy(rng.integers(0, C, (n_tiles, T)).astype(np.int32)).to(dev)
        chunks = torch.randn(n_tiles, C, 80, generator=gen, device=dev, dtype=torch.bfloat16)
        rec("onehot_expand_c128", lambda: onehot_expand(loc, chunks, C).float(),
            rows=n_tiles * T)
    probe.section("onehot_expand_c128", t14)
    return res


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
