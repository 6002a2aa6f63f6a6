"""Port of ``scripts/bprmf_full_r5.py``: the BPR-MF baseline on the
full-scale corpus (``full_corpus_r3``), which is LightGCN with no
propagation layer (``BPRMF_FULL_r5.json``).

The training is the LightGCN run's (BPR objective, sampler, Adam, dim 90,
20 epochs of the reference's 235 batches) at ``n_layers=0``: the final
embedding is the table itself (layer weights ``uniform_alphas(0) = [1]``),
on the layered path (``fast_bipartite="off"``), with only the end-of-run
checkpoint (into ``--work``). The sampler draws from torch generators, not
from JAX's PRNG (a deliberate difference).

The line has the script's keys plus ``EXTRA_KEYS`` (the card, the
kernels' launches and the quality bars, ``bars.bprmf_full_r5``: a missed
bar raises); ``comparators_same_corpus`` are the TPU's numbers that the
script wrote.

    python -m gnn_ecommerce_tpu_torch.runs.bprmf_full_r5 [-d DATA_DIR] [--work DIR]
        [--device cuda] [--out x.json]

``-d`` reuses a saved artifact (``full_corpus_r3 -o DATA_DIR``) in place of
building the corpus.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

from ..data.prepare import PreparedData
from ..device import resolve_device
from ..train.driver import TrainConfig, train
from . import _load, bars, full_corpus_r3
from ._cli import emit, launches_since, quality_parser, work_dir

CONFIG = TrainConfig(
    latent_dim=90,
    n_layers=0,
    lr=0.005,
    decay=1e-4,
    batch_size=1024,
    epochs=20,
    k=20,
    seed=42,
    batches_per_epoch=None,  # the reference formula: 235
    fast_bipartite="off",
    checkpoint_every=0,
    async_saves=True,
)
CHECKPOINT_SUBDIR = "bprmf_r5"
TPU_COMPARATORS = {
    "lightgcn_val_recall@20": 0.3244,
    "lightgcn_test_recall@20": 0.3185,
    "popularity_val_recall@20": 0.0344,
    "svd_mse_full_ranking_val_recall@20": 0.00066,
    "weighted_2hop_skyline_val_recall@20": 0.178,
}
EXTRA_KEYS = {"device", "launches", "bars"}


def config(work: str, epochs: int | None = None) -> TrainConfig:
    """The script's configuration (at ``epochs``, where given), its
    checkpoints under ``work``."""
    return dataclasses.replace(
        CONFIG, epochs=epochs or CONFIG.epochs, checkpoint_dir=os.path.join(work, CHECKPOINT_SUBDIR)
    )


def run(prepared: PreparedData, cfg: TrainConfig, etl_s: float = 0.0, device="cuda") -> dict:
    """Train BPR-MF; the script's keys (without the card)."""
    t_all = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = train(prepared, cfg, device=device)
    train_s = time.perf_counter() - t_all
    return {
        "benchmark": "bprmf_full_r5",
        "model": (
            "BPR-MF = LightGCN n_layers=0 (models/lightgcn.py): the LightGCN run's objective, "
            "sampler, optimizer, dim and epochs, no graph propagation"
        ),
        "dataset": "synthetic cosmetics-scale (full_corpus_r3, no egress)",
        "quality": {
            "best_epoch": result.best_epoch,
            "best_val_recall@20": result.best_val_recall,
            "best_val_precision@20": result.best_val_precision,
            "test_recall@20": result.test_recall,
            "test_precision@20": result.test_precision,
            "val_recall_curve": [h["val_recall"] for h in result.history],
        },
        "comparators_same_corpus": dict(TPU_COMPARATORS),
        "timings_s": {"etl": etl_s, "train": train_s, "total": etl_s + time.perf_counter() - t_all},
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__, work=True)
    ap.add_argument("-d", "--data-dir", help="a saved artifact of full_corpus_r3 (default: build it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prepared, _, etl_s = full_corpus_r3.prepared_of(args.data_dir)
    with work_dir(args.work) as work, launches_since() as launches:
        result = run(prepared, config(work), etl_s, dev)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["bprmf_full_r5"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
