"""Event-log → weighted-edge CSV (same flags as ``gnn_ecommerce_tpu/cli/preprocess.py``).

Reads an event CSV with ``user_id, item_id, event_type`` columns, applies
the weight-map / clamp / cap pipeline (``data/events.py``), and writes the
``user_id,item_id,weight`` CSV the trainer consumes.

    python -m gnn_ecommerce_tpu_torch.cli.preprocess --events events.csv \
        -o u_i_weight.csv --scheme v1
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data.events import Events, events_to_edges, read_csv
from .config import WEIGHT_SCHEMES


def _count_lines(path: str) -> int:
    n_lines = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            n_lines += chunk.count(b"\n")
    return n_lines


def load_events(
    path: str, user_col: str = "user_id", item_col: str = "item_id"
) -> Events:
    """Load an event CSV through the native multithreaded reader (integer
    ids), falling back to the ``csv`` module.

    The native reader drops rows whose id fields don't parse as integers
    (string ids, quoted embedded newlines). A drop of more than 0.1% of
    the file's lines routes the whole load to the fallback, which keeps
    every row (ids that are not all integers stay strings); a smaller drop
    is reported on stderr."""
    from .. import native

    try:
        u, i, t = native.read_events_csv(path, user_col, item_col)
        n_rows = max(_count_lines(path) - 1, 1)
        if len(u) < 0.999 * n_rows:
            raise ValueError(
                f"native reader kept {len(u)}/{n_rows} rows; "
                "non-integer ids or quoted newlines"
            )
        if len(u) < n_rows:
            print(
                f"{path}: dropped {n_rows - len(u)} of {n_rows} rows whose ids "
                "are not integers", file=sys.stderr,
            )
        return Events(u, i, t)
    except (RuntimeError, ValueError) as e:
        print(f"{path}: {e}; reading it with the csv module", file=sys.stderr)
    cols = read_csv(path)
    cols = {
        {user_col: "user_id", item_col: "item_id"}.get(name, name): col
        for name, col in cols.items()
    }
    missing = {"user_id", "item_id", "event_type"} - set(cols)
    if missing:
        sys.exit(f"events CSV missing columns: {sorted(missing)}")
    return Events(cols["user_id"], cols["item_id"], cols["event_type"].astype(str))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--events", required=True, help="event CSV (user_id,item_id,event_type)")
    ap.add_argument("-o", "--output", required=True, help="output weighted-edge CSV")
    ap.add_argument(
        "--scheme", default="v1", choices=sorted(WEIGHT_SCHEMES),
        help="event-type weight scheme",
    )
    ap.add_argument("--user-col", default="user_id", help="user id column name")
    ap.add_argument(
        "--item-col", default="item_id",
        help="item id column name (the reference raw dump calls it product_id)",
    )
    args = ap.parse_args(argv)

    events = load_events(args.events, args.user_col, args.item_col)
    edges = events_to_edges(events, WEIGHT_SCHEMES[args.scheme])
    edges.to_csv(args.output)
    print(
        f"{len(events)} events -> {len(edges)} weighted edges "
        f"({len(np.unique(edges.user_id))} users x {len(np.unique(edges.item_id))} items) "
        f"-> {args.output}"
    )


if __name__ == "__main__":
    main()
