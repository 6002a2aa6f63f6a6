"""Port of ``scripts/train_full_r5b.py``: the main configuration trained on
the full-scale corpus (``full_corpus_r3``) at the reference's shipped
hyperparameters (``TRAIN_FULL_r5b.json``).

``TrainConfig``: dim 90, 5 layers, lr 0.005, decay 1e-4, batch 1024, 20
epochs of the reference's 235 batches, the bf16 fast path with a
16,384-user head, a save every epoch behind the training (async, duty 0.5),
checkpoints under ``--work``. K1 in bf16 and its cast run in every step
and every eval forward.

``--seed`` sets ``TrainConfig.seed`` alone (the init and the sampler): the
corpus stays ``full_corpus_r3``'s (seed 42), which ``cli.train --seed``
would change with it. ``-d`` reuses a saved artifact; without it the corpus
is built.

The line has the script's keys plus ``EXTRA_KEYS``: the card, the seed, the
artifact's hash (``full_corpus_r3.prepared_sha256``: the artifact the run
trained on, saved or not), the kernels' launches and the quality bars
(``bars.train_full_r5b``, at any seed: a missed bar raises).

    python -m gnn_ecommerce_tpu_torch.runs.train_full_r5b [-d DATA_DIR] [--seed 42] [--work DIR]
        [--device cuda] [--out x.json]
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

from ..data.prepare import PreparedData
from ..device import resolve_device
from ..eval.baselines import popularity_recall_at_k
from ..train.driver import TrainConfig, train
from . import _load, bars, full_corpus_r3
from ._cli import emit, launches_since, quality_parser, work_dir

REFERENCE_HOURS = 24.0  # the reference's training time
CONFIG = TrainConfig(
    latent_dim=90,
    n_layers=5,
    lr=0.005,
    decay=1e-4,
    batch_size=1024,
    epochs=20,
    k=20,
    seed=42,
    batches_per_epoch=None,  # the reference formula: 235
    fast_bipartite="bf16",
    heavy_users=16384,
    checkpoint_every=1,
    async_saves=True,
)
CHECKPOINT_SUBDIR = "full_r5b"
EXTRA_KEYS = {"device", "seed", "artifact_sha256", "launches", "bars"}


def config(work: str, seed: int, epochs: int | None = None) -> TrainConfig:
    """The script's configuration at ``seed`` (and at ``epochs``, where
    given), its checkpoints under ``work``."""
    return dataclasses.replace(
        CONFIG, seed=seed, epochs=epochs or CONFIG.epochs,
        checkpoint_dir=os.path.join(work, CHECKPOINT_SUBDIR),
    )


def run(prepared: PreparedData, cfg: TrainConfig, n_edges: int | None = None,
        etl_s: float = 0.0, device="cuda") -> dict:
    """The popularity baseline, then the training; the script's keys
    (without the card)."""
    t_all = time.perf_counter()
    pop = popularity_recall_at_k(prepared, k=20)
    _load.log(f"popularity baseline val R@20 = {pop:.5f}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = train(prepared, cfg, device=device)
    train_s = time.perf_counter() - t0
    total_s = etl_s + time.perf_counter() - t_all
    return {
        "workload": {
            "graph": f"{prepared.n_users}x{prepared.n_items}",
            "unique_edges": n_edges,
            "train_edges": int(len(prepared.edge_user)),
            "epochs": cfg.epochs,
            "batches_per_epoch": int(len(prepared.edge_user) // (cfg.batch_size * 40)),
            "batch_size": cfg.batch_size,
            "dim": cfg.latent_dim,
            "layers": cfg.n_layers,
            "config": (
                f"reference hparams dim {cfg.latent_dim}/{cfg.n_layers} layers; fast_bipartite="
                f"{cfg.fast_bipartite}, heavy_users={cfg.heavy_users}, async saves every epoch"
            ),
            "dataset": "deterministic clustered synthetic (full_corpus_r3: seed 42; 768 "
                       "co-clusters, affinity 0.85, item_skew 0.9)",
        },
        "measured": {
            "etl_s": round(etl_s, 1),
            "train_wall_s": round(train_s, 1),
            "total_wall_s": round(total_s, 1),
            "train_wall_hours": round(train_s / 3600, 4),
            "reference_hours": REFERENCE_HOURS,
            "speedup_vs_reference": round(REFERENCE_HOURS * 3600 / train_s, 1),
        },
        "quality": {
            "best_epoch": result.best_epoch,
            "best_val_precision": result.best_val_precision,
            "best_val_recall": result.best_val_recall,
            "test_precision": result.test_precision,
            "test_recall": result.test_recall,
            "val_recall_curve": [h["val_recall"] for h in result.history],
            "bpr_loss_curve": [h["bpr_loss"] for h in result.history],
            "popularity_baseline_val_recall_at_20": pop,
            "beats_popularity": bool(result.best_val_recall > pop),
        },
        "per_epoch": [
            {k: h[k] for k in ("epoch", "bpr_loss", "val_recall", "train_s", "epoch_s", "eval_s")}
            for h in result.history
        ],
        "seed": cfg.seed,
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__, work=True)
    ap.add_argument("-d", "--data-dir", help="a saved artifact of full_corpus_r3 (default: build it)")
    ap.add_argument("--seed", type=int, default=CONFIG.seed, help="TrainConfig.seed (not the corpus's)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prepared, n_edges, etl_s = full_corpus_r3.prepared_of(args.data_dir)
    digest = full_corpus_r3.prepared_sha256(prepared)
    with work_dir(args.work) as work, launches_since() as launches:
        result = run(prepared, config(work, args.seed), n_edges, etl_s, dev)
    line = {**result, "device": _load.card(dev), "artifact_sha256": digest, "launches": launches}
    return emit(bars.hold(line, bars.BARS["train_full_r5b"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
