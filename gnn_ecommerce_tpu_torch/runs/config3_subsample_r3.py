"""Port of ``scripts/config3_subsample_r3.py``, BASELINE config 3: LightGCN
on the 1/10-scale clustered corpus (both axes of ``full_corpus_r3``
scaled by 10, the same cluster structure) on one card
(``scripts/config3_subsample_r3.json``).

The corpus is the JAX package's bit for bit (``CORPUS``: 163,936 users,
5,457 items, 2,069,284 events, 1,015,741 pairs, 77 clusters, affinity
0.85, item skew 0.9, seed 42, split with seed 42); the popularity baseline
is ``popularity_recall_at_k``; the training is ``TrainConfig(dim 80, 4
layers, lr 0.005, decay 1e-4, batch 1024, 20 epochs, seed 42)`` with the
reference's batches an epoch, on the layered path (``fast_bipartite=
"off"``, the JAX default), only the end-of-run checkpoint (into
``--work``). The sampler draws from torch generators, not from JAX's PRNG
(a deliberate difference). The line has the script's keys plus
``EXTRA_KEYS`` (the card, the kernels' launches and the quality bars,
``bars.config3_subsample_r3``: a missed bar raises).

    python -m gnn_ecommerce_tpu_torch.runs.config3_subsample_r3 [--work DIR] [--device cuda]
        [--out x.json]
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

from ..data.events import EVENT_TYPE_WEIGHTS_V1, events_to_edges
from ..data.prepare import PreparedData, prepare_splits, split_edges
from ..data.synthetic import synthetic_events
from ..device import resolve_device
from ..eval.baselines import popularity_recall_at_k
from ..train.driver import TrainConfig, train
from . import _load, bars
from ._cli import emit, launches_since, quality_parser, work_dir

CORPUS = dict(
    n_users=163_936, n_items=5_457, n_events=2_069_284, seed=42,
    n_pairs=1_015_741, n_clusters=77, affinity=0.85, item_skew=0.9,
)
CONFIG = TrainConfig(
    latent_dim=80, n_layers=4, lr=0.005, decay=1e-4, batch_size=1024,
    epochs=20, k=20, seed=42, batches_per_epoch=None, checkpoint_every=0,
)
CHECKPOINT_SUBDIR = "config3_r3"
EXTRA_KEYS = {"device", "launches", "bars"}


def build_splits():
    """(train, val, test) edges of the corpus."""
    edges = events_to_edges(synthetic_events(**CORPUS), EVENT_TYPE_WEIGHTS_V1)
    return split_edges(edges, seed=42)


def config(work: str, epochs: int | None = None) -> TrainConfig:
    """The script's configuration (at ``epochs``, where given), its
    checkpoint under ``work``."""
    return dataclasses.replace(
        CONFIG, epochs=epochs or CONFIG.epochs, checkpoint_dir=os.path.join(work, CHECKPOINT_SUBDIR)
    )


def run(prepared: PreparedData, cfg: TrainConfig, etl_s: float = 0.0, device="cuda") -> dict:
    """The popularity baseline, then the training; the script's keys
    (without the card)."""
    t_all = time.perf_counter()
    pop = popularity_recall_at_k(prepared, k=20)
    _load.log(f"popularity R@20 {pop:.5f}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = train(prepared, cfg, device=device)
    train_s = time.perf_counter() - t0
    return {
        "config": "BASELINE config 3: cosmetics 10% subsample, single card",
        "graph": f"{prepared.n_users}x{prepared.n_items}, {len(prepared.edge_user)} train edges",
        "epochs": cfg.epochs,
        "batches_per_epoch": len(prepared.edge_user) // (cfg.batch_size * 40),
        "train_wall_s": round(train_s, 1),
        "total_wall_s": round(etl_s + time.perf_counter() - t_all, 1),
        "best_epoch": result.best_epoch,
        "best_val_recall_at_20": round(result.best_val_recall, 5),
        "test_recall_at_20": round(result.test_recall, 5),
        "popularity_baseline_val_recall_at_20": round(pop, 5),
        "beats_popularity": bool(result.best_val_recall > pop),
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__, work=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    prepared = prepare_splits(*build_splits())
    etl_s = time.perf_counter() - t0
    with work_dir(args.work) as work, launches_since() as launches:
        result = run(prepared, config(work), etl_s, dev)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["config3_subsample_r3"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
