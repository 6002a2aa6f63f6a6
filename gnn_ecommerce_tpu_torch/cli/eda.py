"""EDA CLI: dataset statistics, the event projection and a profiling report.

Counterpart of ``gnn_ecommerce_tpu/cli/eda.py``, with its flags. It reads
the raw event CSV with the port's reader, keeping every column (typed as
pandas types them, ``data/frame.py:read_frame``), and writes the headline
statistics as JSON (``data/eda.py:event_stats``), the
``user_item_event.csv`` projection (pandas' ``to_csv`` bytes) and a
self-contained HTML profile (``data/profile.py``). Host work only: it takes
no ``--device``.

    python -m gnn_ecommerce_tpu_torch.cli.eda --events raw.csv --item-col product_id \\
        --stats stats.json --report report.html --out-events user_item_event.csv
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..data.eda import event_stats
from ..data.events import Events
from ..data.frame import Frame, read_frame
from ..data.profile import profile_report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--events", required=True, help="raw event CSV")
    ap.add_argument("--user-col", default="user_id")
    ap.add_argument(
        "--item-col", default="item_id",
        help="item id column (the reference raw dump calls it product_id)",
    )
    ap.add_argument("--stats", help="write headline statistics JSON here")
    ap.add_argument("--out-events", help="write the user_item_event.csv projection")
    ap.add_argument("--report", help="write a self-contained HTML profile here")
    args = ap.parse_args(argv)

    raw = read_frame(args.events)
    rename = {args.user_col: "user_id", args.item_col: "item_id"}
    frame = Frame({rename.get(c, c): raw[c] for c in raw.columns})
    missing = {"user_id", "item_id", "event_type"} - set(frame.columns)
    if missing:
        sys.exit(f"events CSV missing columns: {sorted(missing)}")
    event_type = frame["event_type"]
    events = Events(
        frame["user_id"], frame["item_id"],
        np.asarray(["" if t is None else str(t) for t in event_type.tolist()]),
    )
    stats = event_stats(events)
    print(json.dumps(stats, indent=1))
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1)
    if args.out_events:
        Frame({c: frame[c] for c in ("user_id", "item_id", "event_type")}).to_csv(args.out_events)
        print(f"wrote {args.out_events}", file=sys.stderr)
    if args.report:
        with open(args.report, "w") as f:
            f.write(profile_report(frame, title="Event-log profile", headline=stats))
        print(f"wrote {args.report}", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
