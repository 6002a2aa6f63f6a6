"""The serving runs' shared command line.

    python -m gnn_ecommerce_tpu_torch.runs.<name> -d DATA_DIR -c CKPT_DIR
        [--checkpoint-name LightGCN_best] [--device cuda] [--out x.json]

Loads the prepared artifact and the checkpoint into a
:class:`RecommenderService` on ``--device`` (``cuda`` by default; the CPU
only when asked: without a card the load raises), times that load, runs the
run and prints its result as one JSON line (progress goes to stderr).
"""
from __future__ import annotations

import argparse
import json
import time

from ..device import resolve_device
from ..serve import RecommenderService
from ..train.checkpoint import BEST_NAME
from ._load import log


def cli(doc: str, argv, run) -> int:
    """Parse ``argv``, load the service, ``run(svc, load_s, args)`` and
    print (and with ``--out`` write) its JSON line."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("-d", "--data-dir", required=True, help="prepared artifact directory")
    ap.add_argument("-c", "--checkpoint-dir", required=True)
    ap.add_argument("--checkpoint-name", default=BEST_NAME, help="the version served first")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    svc = RecommenderService.from_artifacts(
        args.data_dir, args.checkpoint_dir, args.checkpoint_name, device=dev
    )
    load_s = time.perf_counter() - t0
    log(f"service up in {load_s:.1f} s on {dev} ({svc.prepared.n_users}x{svc.prepared.n_items}, "
        f"dim {svc.cfg.embedding_dim})")
    text = json.dumps(run(svc, load_s, args))
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


def checkpoint_of(args) -> str:
    return f"{args.checkpoint_dir}/{args.checkpoint_name}"
