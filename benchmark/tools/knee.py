"""The serve mix's knee: the highest rate the service sustains.

    python3 benchmark/tools/knee.py --workload cosmetics-d90-l5.serve --seed 1 \
        --rates 100,200,300 [--seconds 10]

One set-up of the cell, then one open-loop window at each rate, each from a
load generator of its own. A rate is sustained when no request fails, the
backlog does not grow through the window (the median latency of its last
third within ``GROWTH`` of its first third's, or ``SLACK_MS`` above) and the
last answer comes within ``DRAIN_S`` of the window's end. The generator's
lateness is printed, not judged: on the card's shared host both processes
stall together now and then, and a stall is no backlog. One JSON line a
rate, then the knee: the highest rate sustained with every lower rate of
the sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GROWTH = 1.5
SLACK_MS = 2.0
DRAIN_S = 1.0


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True, help="requests/s, comma-separated, ascending")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.root, args.workload, args.seed, args.seconds, False, args.device)
    d = cell.driver
    st = d.build(cell)
    knee = last_ok = None
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            reqs = d.run_load(cell, d.start_load(cell, st, rate, args.seconds, 1.0))
            s = d.latency_summary(reqs, cell.mix["timeout_s"])
            due = np.array([r[0] for r in reqs])
            lat = np.array([r[2] - r[0] for r in reqs]) * 1e3
            late = np.array([r[1] - r[0] for r in reqs]) * 1e3
            head, tail = due < args.seconds / 3, due >= 2 * args.seconds / 3
            grows = lambda x, q: np.quantile(x[tail], q) > max(GROWTH * np.quantile(x[head], q),
                                                              np.quantile(x[head], q) + SLACK_MS)
            drain = max(r[2] for r in reqs) - args.seconds
            ok = s["failed"] == 0 and not grows(lat, 0.5) and drain <= DRAIN_S
            knee = rate if ok and knee == last_ok else knee
            last_ok = rate if ok else None
            print(json.dumps({"rate_per_s": rate, "sustained": bool(ok), **s,
                              "median_first_third_ms": float(np.median(lat[head])),
                              "median_last_third_ms": float(np.median(lat[tail])),
                              "late_p99_first_third_ms": float(np.quantile(late[head], 0.99)),
                              "late_p99_last_third_ms": float(np.quantile(late[tail], 0.99)), "drain_s": drain,
                              "answered_per_s": sum(r[3] == 200 for r in reqs) / args.seconds}), flush=True)
    finally:
        d.release(cell, st)
    print(json.dumps({"knee_per_s": knee, "four_fifths": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
