"""The probes' shared timer, section runner and command line.

One timer for all four probes (each script had its own ``timeit``): warmup
calls, then the median of ``reps`` timed calls, by CUDA events on the card
and by the host clock on the CPU. Rates are recorded under the scripts' own
keys: ``ms``, ``Mrows_s``, ``ns_per_row`` and, where the bytes are known,
``GBps``. A failed section raises (the scripts' guard, which recorded the
error and went on, is not kept), so a CLI run with a failure exits non-zero
with its traceback and prints no JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch

from ..device import resolve_device
from ..ops._kernels import launch_counts


def time_ms(fn, device: torch.device, reps: int = 4, warmup: int = 1) -> float:
    """Median ms of ``reps`` calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rate(ms: float, rows: int, nbytes: int | None = None) -> dict:
    """A timing's rates: rows per second and per row, bytes per second."""
    out = {"ms": ms, "Mrows_s": rows / ms / 1e3, "ns_per_row": ms * 1e6 / rows}
    if nbytes is not None:
        out["GBps"] = nbytes / ms / 1e6
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Probe:
    """One probe run: its results dict, with ``results["launches"]`` giving
    each section's kernel launches (``"<stem>.<mode>": n``, the non-zero
    ones)."""

    def __init__(self, device, reps: int):
        self.device = resolve_device(device)
        self.reps = reps
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.results: dict = {"device": name, "launches": {}}

    def time(self, fn) -> float:
        return time_ms(fn, self.device, reps=self.reps)

    def record(self, name: str, ms: float, rows: int, nbytes: int | None = None, **extra) -> None:
        self.results[name] = {**rate(ms, rows, nbytes), **extra}
        log(f"{name}: {ms:.3f} ms -> {rows / ms / 1e3:.1f} M rows/s")

    def section(self, name: str, fn) -> None:
        """Run one measurement; a failure raises."""
        t0, before = time.perf_counter(), launch_counts()
        try:
            fn()
            log(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
        finally:
            self.results["launches"][name] = {
                k: n - before[k] for k, n in launch_counts().items() if n != before[k]
            }
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


def cli(main, doc: str, argv=None) -> int:
    """``python -m ...probes.<name> [--device cuda] [--reps N] [--out x.json]``:
    prints the results as one JSON line; a failed section raises."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (tiny shapes)")
    ap.add_argument("--reps", type=int, default=4, help="timed calls per measurement")
    ap.add_argument("--out", help="also write the JSON to this path")
    args = ap.parse_args(argv)
    results = main(device=args.device, reps=args.reps)
    text = json.dumps(results)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0
