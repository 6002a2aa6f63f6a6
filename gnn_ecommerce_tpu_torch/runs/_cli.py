"""The runs' shared command line.

The serving runs:

    python -m gnn_ecommerce_tpu_torch.runs.<name> -d DATA_DIR -c CKPT_DIR
        [--checkpoint-name LightGCN_best] [--device cuda] [--out x.json]

load the prepared artifact and the checkpoint into a
:class:`RecommenderService` on ``--device`` (``cuda`` by default; the CPU
only when asked: without a card the load raises), time that load, run the
run and print its result as one JSON line (progress goes to stderr).

The quality runs take ``--device`` and ``--out`` from
:func:`quality_parser`, and those that write checkpoints or files
``--work`` too (a directory for what the run writes besides ``--out``: a
temporary one by default, removed at the end); they count the kernels'
launches of their run with :func:`launches_since`, hold their line to
their bars (``bars.hold``) and print it through :func:`emit`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

from ..device import resolve_device
from ..ops._kernels import launch_counts
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
    return emit(run(svc, load_s, args), args.out)


def emit(result: dict, out: str | None) -> int:
    """Print ``result`` as one JSON line (and write it to ``out``)."""
    text = json.dumps(result)
    print(text, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return 0


def quality_parser(doc: str, work: bool = False) -> argparse.ArgumentParser:
    """The quality runs' parser: ``--device``, ``--out`` and, with
    ``work``, ``--work``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="also write the JSON line to this path")
    if work:
        ap.add_argument("--work", help="directory for checkpoints and files (default: a temporary one)")
    return ap


@contextlib.contextmanager
def work_dir(path: str | None):
    """``path`` (made if missing), or a temporary directory removed at the end."""
    if path:
        os.makedirs(path, exist_ok=True)
        yield path
        return
    with tempfile.TemporaryDirectory(prefix="quality_run_") as tmp:
        yield tmp


def checkpoint_of(args) -> str:
    return f"{args.checkpoint_dir}/{args.checkpoint_name}"


@contextlib.contextmanager
def launches_since():
    """A dict that holds, once the block ends, the kernels' launches made in
    it: each ``ops._kernels.launch_counts`` key whose count moved."""
    before = launch_counts()
    out: dict = {}
    yield out
    out.update({k: n - before[k] for k, n in launch_counts().items() if n != before[k]})
