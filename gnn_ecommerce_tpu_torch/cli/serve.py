"""Serving CLI of the PyTorch port (same flags as ``gnn_ecommerce_tpu/cli/serve.py``).

    python -m gnn_ecommerce_tpu_torch.cli.serve -d data/prepared -c model-checkpoints -p 8080

Then:

    curl -X POST http://localhost:8080/v1/models/lightgcn_recommender:predict \
        -H 'Content-Type: application/json' -d '[0]'

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from ..serve.batching import BatchingRecommender
from ..serve.server import serve_forever
from ..serve.service import RecommenderService
from ..train.checkpoint import BEST_NAME


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-d", "--data-dir", required=True, help="prepared artifact dir")
    ap.add_argument("-c", "--checkpoint-dir", required=True)
    ap.add_argument("--checkpoint-name", default=BEST_NAME)
    ap.add_argument("-p", "--port", type=int, default=8080)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("-k", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--quantized", action="store_true",
        help="serve int8-quantized embeddings (per-row absmax; int8 scores, f32 rescale)",
    )
    ap.add_argument(
        "--no-batching", action="store_true",
        help="disable cross-request batching (default: coalesce concurrent "
             "requests into one service call per linger window)",
    )
    ap.add_argument(
        "--batch-delay-ms", type=float, default=4.0,
        help="batching linger window (TorchServe maxBatchDelay analog)",
    )
    ap.add_argument(
        "--batch-solo-min", type=int, default=32,
        help="requests with at least this many users bypass the batcher",
    )
    ap.add_argument(
        "--batch-workers", type=int, default=2,
        help="initial batcher dispatch-worker pool size (resizable at "
             "runtime via PUT /v1/models/<name>?workers=N)",
    )
    args = ap.parse_args(argv)

    print("loading artifacts + propagating embeddings ...")
    service = RecommenderService.from_artifacts(
        args.data_dir, args.checkpoint_dir, args.checkpoint_name, k=args.k,
        quantized=args.quantized, device=args.device,
    )
    if not args.no_batching:
        service = BatchingRecommender(
            service, max_wait_s=args.batch_delay_ms / 1e3,
            solo_min=args.batch_solo_min, parallelism=args.batch_workers,
        )
    print(f"ready ({service.stats()})")
    serve_forever(service, args.host, args.port)


if __name__ == "__main__":
    main()
