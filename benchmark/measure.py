"""Timing by CUDA events and the reading of a profiler trace.

``time_ms`` times a call alone on the card. ``Trace`` wraps one
``torch.profiler`` window (one a process: the profiler has returned no
kernel in a second profile of one process on this card) and reads from its
raw events, without building the profiler's own tables:

- ``busy_s``: the union of the intervals in which a device operation ran;
- ``device_ops``: device seconds by operation name, the heaviest first;
- ``idle_gaps``: the longest gaps between device operations, each named by
  the innermost host operation running at its middle, seconds summed by
  name.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

# Gaps shorter than this are launch latency, not idle time worth a name.
GAP_MIN_S = 10e-6
# The longest gaps that are named (naming is a search per gap).
GAPS_NAMED = 20_000


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``reps`` calls of ``fn`` on the card after
    ``warmup`` calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of ``[starts, ends)`` (any order)."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


class Trace:
    """One profiled window: ``with Trace() as t: ...``, then ``t.summary()``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.window_s = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def _events(self):
        """(device names, starts, ends; host names, starts, ends), ns."""
        from torch.autograd import DeviceType

        dev, host = ([], [], []), ([], [], [])
        for e in self._prof.profiler.kineto_results.events():
            side = dev if e.device_type() == DeviceType.CUDA else host
            side[0].append(e.name())
            side[1].append(e.start_ns())
            side[2].append(e.start_ns() + e.duration_ns())
        as_arrays = lambda t: (t[0], np.asarray(t[1], np.int64), np.asarray(t[2], np.int64))
        return as_arrays(dev), as_arrays(host)

    def summary(self, top: int = 10) -> dict:
        """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (at most
        ``top`` entries each, ``[name, seconds]``)."""
        (d_names, d_start, d_end), (h_names, h_start, h_end) = self._events()
        busy_s = 0.0
        ops, gaps_named = {}, {}
        if len(d_start):
            for name, dur in zip(d_names, (d_end - d_start)):
                ops[name] = ops.get(name, 0.0) + dur / 1e9
            u_start, u_end = _union(d_start, d_end)
            busy_s = float((u_end - u_start).sum()) / 1e9
            gap_start, gap_end = u_end[:-1], u_start[1:]
            keep = (gap_end - gap_start) >= GAP_MIN_S * 1e9
            gap_start, gap_end = gap_start[keep], gap_end[keep]
            longest = np.argsort(gap_start - gap_end, kind="stable")[:GAPS_NAMED]
            order = np.argsort(h_start, kind="stable")
            hs, he = h_start[order], h_end[order]
            names = [h_names[k] for k in order]
            for g in longest:
                mid = (gap_start[g] + gap_end[g]) // 2
                k = int(np.searchsorted(hs, mid, side="right")) - 1
                label = "host: no operation"
                # The innermost running operation: the latest to start
                # among those still running at the middle of the gap.
                for j in range(k, max(k - 256, -1), -1):
                    if he[j] >= mid:
                        label = names[j]
                        break
                gaps_named[label] = gaps_named.get(label, 0.0) + (gap_end[g] - gap_start[g]) / 1e9
        rank = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {
            "busy_s": busy_s,
            "window_s": self.window_s,
            "device_ops": rank(ops),
            "idle_gaps": rank(gaps_named),
        }


def idle_pct(summary: dict | None) -> float | None:
    """The device's idle share of a traced window, 100 x (1 - busy /
    window); None without a trace or with no device operation in it."""
    if not summary or not summary.get("busy_s") or not summary.get("window_s"):
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
