"""Port of ``scripts/pallas_gather_probe.py``: the per-row gather (K4).

The script measured whether explicit per-row DMAs, K in flight, beat XLA's
arbitrary-row gather. Here the baseline is ``index_select`` and the kernel
is K4 (``csrc/row_gather.cu``), ``k_inflight`` rows in flight over index
blocks of ``chunk`` rows (4 KB rows by bulk-copy row DMAs, 256-byte rows by
16-byte lane loads):

- phase A, the production-shaped [1,639,358, 128] bf16 table and 10,156,032
  indices: the baseline (``xla_take_bf16_128``) and K4 on the same rows
  (``row_gather_bf16_128_k8_c1024``); the TPU could not gather these rows
  one by one (its DMA minimum is one 4 KB tile), the card can;
- phase B, the probe's [524,288, 8, 128] f32 tile-row table and 1,048,576
  indices: the baseline (``xla_take_tile_rows``), the script's correctness
  check of K4 on 1,024 indices, then K4 at ``k_inflight`` 4, 8 and 16 with
  chunk 1024, and 2048 at k 8 (``pallas_dma_k{k}_c{chunk}``).

Every K4 configuration is held to ``index_select`` on all its rows (equal
bytes) before it is timed.

On the CPU it runs the script's CPU shapes.

    python -m gnn_ecommerce_tpu_torch.probes.pallas_gather_probe [--out x.json]
"""
from __future__ import annotations

import sys
import time

import torch

from ._timing import Probe, cli
from .kernels import row_gather

N_ROWS = 1_639_358
N_GATHER = 10_157_407
D = 128
TILE_ROW = (8, 128)  # one f32 (8, 128) tile, 4 KB
# Phase B's K4 configurations, (k_inflight, chunk), in the script's order.
CONFIGS = ((4, 1024), (8, 1024), (8, 2048), (16, 1024))


def shapes(device: torch.device) -> dict:
    """The script's shapes: its chip shapes on the card, its CPU shapes on
    the CPU."""
    if device.type == "cuda":
        return {"n_rows": N_ROWS, "n_gather": N_GATHER - (N_GATHER % 2048),
                "n_rows_t": 512 * 1024, "n_gather_t": 1024 * 1024}
    return {"n_rows": 4096, "n_gather": 8192, "n_rows_t": 1024, "n_gather_t": 4096}


def check_exact(table, idx, k: int, chunk: int) -> None:
    """K4 at ``(k, chunk)`` gives ``index_select``'s bytes on every row."""
    got = row_gather(table, idx, k_inflight=k, chunk=chunk)
    if not torch.equal(got, torch.index_select(table, 0, idx)):
        raise AssertionError(f"row_gather k_inflight={k} chunk={chunk} differs from index_select")


def main(device="cuda", *, reps: int = 3) -> dict:
    """Run phases A and B on ``device``; returns the script's keys."""
    probe = Probe(device, reps)
    dev, res = probe.device, probe.results
    s = shapes(dev)
    res.update({"n_rows": s["n_rows"], "n_gather": s["n_gather"], "dim": D})
    gen = torch.Generator(device=dev).manual_seed(0)

    def record(name, ms, n, row_bytes, **extra):
        probe.record(name, ms, n, n * row_bytes, s=ms / 1e3, **extra)

    def phase_a():
        table = torch.randn(s["n_rows"], D, generator=gen, device=dev, dtype=torch.bfloat16)
        idx = torch.randint(0, s["n_rows"], (s["n_gather"],), generator=gen, device=dev,
                            dtype=torch.int32)
        record("xla_take_bf16_128", probe.time(lambda: torch.index_select(table, 0, idx)),
               s["n_gather"], D * 2)
        check_exact(table, idx, 8, 1024)
        ms = probe.time(lambda: row_gather(table, idx, k_inflight=8, chunk=1024))
        record("row_gather_bf16_128_k8_c1024", ms, s["n_gather"], D * 2, exact=True)

    probe.section("phase_a", phase_a)

    def phase_b():
        table_t = torch.randn(s["n_rows_t"], *TILE_ROW, generator=gen, device=dev)
        idx_t = torch.randint(0, s["n_rows_t"], (s["n_gather_t"],), generator=gen, device=dev,
                              dtype=torch.int32)
        n, row_bytes = s["n_gather_t"], 4096
        take_ms = probe.time(lambda: torch.index_select(table_t, 0, idx_t))
        record("xla_take_tile_rows", take_ms, n, row_bytes)

        small_idx = idx_t[:1024]
        got = row_gather(table_t, small_idx, k_inflight=4, chunk=1024)
        assert torch.equal(got, torch.index_select(table_t, 0, small_idx))
        res["per_row_kernel_correct"] = True

        for k, chunk in CONFIGS:
            label = f"pallas_dma_k{k}_c{chunk}"

            def one(k=k, chunk=chunk):
                t0 = time.perf_counter()
                check_exact(table_t, idx_t, k, chunk)
                first_call_s = time.perf_counter() - t0
                ms = probe.time(lambda: row_gather(table_t, idx_t, k_inflight=k, chunk=chunk))
                record(label, ms, n, row_bytes, first_call_s=first_call_s,
                       vs_take=take_ms / ms, exact=True)

            probe.section(label, one)

    probe.section("phase_b", phase_b)
    res["note"] = (
        "The TPU's minimum HBM unit per DMA was one (8, 128) f32 tile (4 KB), "
        "which forced the [N, 8, 128] table; Hopper gathers any 16-byte-aligned "
        "row at its own size, so phase A gathers the 256-byte rows directly."
    )
    return res


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
