"""Port of ``scripts/microbench_gather2.py``: the reduce-side primitives and
the lane gather with an [8, 512] index layout.

Its nine sections under the script's keys: the shipped ``to_items``
(gather + weight + sorted segment sum), sorted segment sums into items and
into users, a random scatter-add, the lane-axis ``index_select``, the
Pallas lane gather (``t_pallas_lane``, here K6 through
``csrc/lane_gather.cu``, checked against ``index_select``), the one-hot
expand with a bf16 result, a gather cast to bf16, and the ELL gather-sum of
width 192. Shapes are the script's; on the CPU they are cut to ``SMALL``.
Given ``microbench_gather``'s results (``shared``), the three sections that
repeat its own take its numbers instead of running again.

    python -m gnn_ecommerce_tpu_torch.probes.microbench_gather2 [--out x.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ._timing import Probe, cli
from .kernels import lane_gather_8x512
from .microbench_gather import TILE, gather, onehot_expand, scatter_add, segsum_sorted, sizes, to_items_like


# Sections that compute what microbench_gather's sections of the same keys
# do, on inputs of the same shapes and distributions.
SHARED = ("to_items_like", "segsum_sorted_items", "scatter_rand_small")


def main(device="cuda", *, reps: int = 4, shared: dict | None = None) -> dict:
    """Run the nine sections on ``device``; returns the script's keys.
    ``shared``, results of ``microbench_gather.main`` on the same device,
    fills the ``SHARED`` keys instead of measuring them again."""
    probe = Probe(device, reps)
    dev, res = probe.device, probe.results
    shared = {k: {**shared[k], "same_as": f"microbench_gather.{k}"} for k in SHARED if k in (shared or {})}

    def section(name, fn):
        if name in shared:
            res[name] = shared[name]
        else:
            probe.section(name, fn)
    s = sizes(dev)
    n_arcs, n_users, n_items = s["E"], s["NU"], s["NI"]
    res["shapes"] = s
    rng = np.random.default_rng(0)
    src_rand_np = rng.integers(0, n_users, n_arcs).astype(np.int32)
    item_rand_np = rng.integers(0, n_items, n_arcs).astype(np.int32)
    item_lengths = torch.from_numpy(np.bincount(item_rand_np, minlength=n_items)).to(dev)
    user_lengths = torch.from_numpy(np.bincount(src_rand_np, minlength=n_users)).to(dev)
    w = torch.from_numpy(rng.random(n_arcs).astype(np.float32)).to(dev)
    src_rand = torch.from_numpy(src_rand_np).to(dev)
    item_rand = torch.from_numpy(item_rand_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rec(name, fn, rows=n_arcs, row_bytes=None, **extra):
        ms = probe.time(fn)
        probe.record(name, ms, rows, None if row_bytes is None else rows * row_bytes, **extra)

    def t_to_items():
        U80 = torch.randn(n_users, 80, generator=gen, device=dev)
        rec("to_items_like", lambda: to_items_like(U80, src_rand, item_lengths, w), row_bytes=320)
    section("to_items_like", t_to_items)

    def t_segsum():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("segsum_sorted_items", lambda: segsum_sorted(M, item_lengths), row_bytes=320)
    section("segsum_sorted_items", t_segsum)

    def t_segsum_u():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("segsum_sorted_users", lambda: segsum_sorted(M, user_lengths), row_bytes=320)
    probe.section("segsum_sorted_users", t_segsum_u)

    def t_scat_small():
        M = torch.randn(n_arcs, 80, generator=gen, device=dev)
        rec("scatter_rand_small", lambda: scatter_add(M, item_rand, n_items), row_bytes=320)
    section("scatter_rand_small", t_scat_small)

    def t_lane_xla():
        Tt = torch.randn(80, n_items, generator=gen, device=dev, dtype=torch.bfloat16)
        rec("lane_gather_xla_small_bf16", lambda: torch.index_select(Tt, 1, item_rand),
            row_bytes=160)
    probe.section("lane_gather_xla_small_bf16", t_lane_xla)

    def t_pallas_lane():
        n_tiles = n_arcs // TILE
        idx2d = item_rand[: n_tiles * TILE].reshape(n_tiles * 8, TILE // 8)
        tab = torch.randn(80, n_items, generator=gen, device=dev, dtype=torch.bfloat16)
        exact = torch.equal(
            lane_gather_8x512(tab, idx2d), torch.index_select(tab, 1, idx2d.reshape(-1))
        )
        assert exact, "lane_gather_8x512 differs from index_select"
        rec("pallas_lane_gather_small", lambda: lane_gather_8x512(tab, idx2d),
            rows=n_tiles * TILE, row_bytes=160, exact=exact)
    probe.section("pallas_lane_gather_small", t_pallas_lane)

    def t_onehot():
        C, T = 128, 512
        n_tiles = n_arcs // T
        loc = torch.from_numpy(rng.integers(0, C, (n_tiles, T)).astype(np.int32)).to(dev)
        chunks = torch.randn(n_tiles, C, 80, generator=gen, device=dev, dtype=torch.bfloat16)
        rec("onehot_expand_c128", lambda: onehot_expand(loc, chunks, C), rows=n_tiles * T)
    probe.section("onehot_expand_c128", t_onehot)

    def t_gather_out_bf16():
        U80 = torch.randn(n_users, 80, generator=gen, device=dev)
        rec("gather_rand_big_f32_out_bf16", lambda: gather(U80, src_rand).to(torch.bfloat16),
            row_bytes=320)
    probe.section("gather_rand_big_f32_out_bf16", t_gather_out_bf16)

    def t_ell():
        width = 192  # mean item degree about 186 at this scale
        idx = torch.from_numpy(rng.integers(0, n_users, (n_items, width)).astype(np.int32)).to(dev)
        U80 = torch.randn(n_users, 80, generator=gen, device=dev)
        rec("ell_gather_sum_w192",
            lambda: gather(U80, idx.reshape(-1)).reshape(n_items, width, 80).sum(1),
            rows=n_items * width, row_bytes=320)
    probe.section("ell_gather_sum_w192", t_ell)
    return res


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
