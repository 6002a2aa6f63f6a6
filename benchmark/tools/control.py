"""Readings of the controls and planted faults that the limits are set from.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1,2,3 [--seconds S] [--device cuda]

For each seed it calls the cell's driver's ``controls(cell)``, which makes
the cell's inputs as a run does and puts in the program's place the
control, the reference computed one precision below the one the
configuration states (``reference/precision.py``: fp8 below bf16
training, TF32 below f32 serving), and the driver's planted faults (for
training: half the batch left out, the mean taken over the rest; users
drawn by purchase instead of uniformly). Each is judged by the cell's own
check against the f32 reference, and one JSON line a seed and kind prints
its numbers beside the cell's limits. The program itself is not built, so
a seed costs the inputs and the reference alone.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0, help="the window a run's requests span")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.find_cell(args.root, args.workload, seed, args.seconds, False, args.device)
        for kind, nums in cell.driver.controls(cell).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, "numbers": nums,
                              "limits": cell.mix["limits"], "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
