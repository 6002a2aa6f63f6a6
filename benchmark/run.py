"""One run of one benchmark cell of ``gnn_ecommerce_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The run makes the cell's inputs and tables
from ``--seed``, builds the program through its public entry points, warms
the cell's shapes, measures for ``--seconds``, checks what the window
produced against the plain reference, and prints one JSON line as the last
line of stdout (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` the per-layer metrics and a ``breakdown``;
``checks`` last: each number compared beside its limit, which are also the
last lines of stderr). It exits non-zero, printing no result, without a
CUDA card, or when JAX or the JAX package was loaded.

Build and kernel caches stay inside the checkout, at fixed paths:
``gnn_ecommerce_tpu_torch/_build/`` (the program's own) and
``benchmark/_cache/`` (Triton, torch extensions).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.find_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, "cuda")
    import torch

    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"needs {need} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = harness.run_cell(cell, T_START)
    foreign = harness.foreign_modules()
    if foreign:
        harness.log(f"loaded modules that the run must not load: {foreign}")
        return 4
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
