"""Port of ``scripts/movielens_bench.py``, BASELINE config 2: Recall@20 of
LightGCN against the SVD baseline on the ML-100K-shaped synthetic corpus
(``MOVIELENS_r3.json``, ``MOVIELENS_r4.json``).

Three measurements on the same splits, as the script's:

1. the SVD's 5-fold CV with surprise-parity threshold P/R@10
   (``cli.svd.run_cv``);
2. the SVD as a top-20 ranker on LightGCN's split (fitted on the train
   ratings, every unseen item ranked), packed as
   ``[p | 1 | b_u] · [q | mu + b_i | 1]`` through ``build_eval_batch`` and
   ``evaluate``;
3. LightGCN (dim 64, 3 layers, 30 epochs of 40 batches of 1024, lr 0.01)
   through ``train``.

The corpus (``synthetic_movielens(seed=42)``) is written into ``--work`` as
``ml100k_synth_u.data`` (the bytes of the repo's fixture) and read back by
``load_movielens``; checkpoints go under ``--work`` too. The SVD's and the
sampler's draws come from torch generators, not from JAX's PRNG (a
deliberate difference). The line has the script's keys plus
``EXTRA_KEYS`` (the card, the kernels' launches and the quality bars,
``bars.movielens_bench``: a missed bar raises).

    python -m gnn_ecommerce_tpu_torch.runs.movielens_bench [--epochs 30] [--dim 64] [--layers 3]
        [--work DIR] [--device cuda] [--out x.json]
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from ..cli.svd import run_cv
from ..data.movielens import load_movielens, synthetic_movielens
from ..data.prepare import PreparedData, prepare_splits, split_edges
from ..device import resolve_device
from ..eval.evaluate import build_eval_batch, evaluate
from ..models.svd import SVDConfig, fit_svd
from ..train.driver import TrainConfig, train
from . import _load, bars
from ._cli import emit, launches_since, quality_parser, work_dir

RATINGS_FILE = "ml100k_synth_u.data"
EPOCHS, DIM, LAYERS = 30, 64, 3
EXTRA_KEYS = {"device", "launches", "bars"}


def write_ratings(path: str) -> None:
    """``synthetic_movielens(seed=42)`` as ``u.data``: tab-separated user,
    item, rating, no header (the repo's fixture, byte for byte)."""
    r = synthetic_movielens(seed=42)
    rows = np.stack([r["user_id"], r["item_id"], r["rating"]], axis=1)
    np.savetxt(path, rows, fmt="%d", delimiter="\t")


def ranker_embedding(params: dict) -> torch.Tensor:
    """``[p | 1 | b_u]`` over ``[q | mu + b_i | 1]``: a row product is the
    SVD's ``predict``."""
    b_u, b_i = params["b_u"][:, None], params["b_i"][:, None]
    return torch.cat([
        torch.cat([params["p"], torch.ones_like(b_u), b_u], 1),
        torch.cat([params["q"], params["mu"] + b_i, torch.ones_like(b_i)], 1),
    ]).float()


def svd_ranker(prepared: PreparedData, tr, device) -> dict:
    """Measurement 2: the SVD fitted on ``tr``, ranking every item for the
    val and the test users."""
    u_all = np.searchsorted(prepared.user_classes, tr.user_id)
    i_all = np.searchsorted(prepared.item_classes, tr.item_id)
    params = fit_svd(
        u_all, i_all, np.asarray(tr.weight, np.float32), prepared.n_users, prepared.n_items,
        SVDConfig(seed=42), device=device,
    )
    emb = ranker_embedding(params)
    scores = {}
    for name, split in (("val", prepared.val), ("test", prepared.test)):
        with torch.no_grad():
            p, r, _, _, _ = evaluate(emb, build_eval_batch(split, emb.device), prepared.n_users, k=20)
        scores[name] = {"precision": p, "recall": r}
    return scores


def run(work: str, device="cuda", epochs: int = EPOCHS, dim: int = DIM, layers: int = LAYERS) -> dict:
    """The three measurements; the script's keys (without the card)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, RATINGS_FILE)
    write_ratings(path)
    edges = load_movielens(path)
    _load.log(f"corpus: {len(edges)} edges, {len(np.unique(edges.user_id))} users x "
              f"{len(np.unique(edges.item_id))} items")
    svd_cv = run_cv(edges, folds=5, k=10, device=dev)
    tr, va, te = split_edges(edges, seed=42, test_size=0.2)
    prepared = prepare_splits(tr, va, te)
    svd_scores = svd_ranker(prepared, tr, dev)
    cfg = TrainConfig(
        latent_dim=dim, n_layers=layers, epochs=epochs, batch_size=1024, batches_per_epoch=40,
        lr=0.01, checkpoint_dir=os.path.join(work, "ml100k"), checkpoint_every=0, seed=42,
    )
    with contextlib.redirect_stdout(sys.stderr):
        result = train(prepared, cfg, verbose=False, device=dev)
    _load.log(f"SVD CV {svd_cv['precision_mean']:.4f}/{svd_cv['recall_mean']:.4f}; ranker "
              f"{svd_scores}; LightGCN val R@20 {result.best_val_recall:.4f} test "
              f"{result.test_recall:.4f}")
    return {
        "dataset": "synthetic ML-100K-shaped corpus (deterministic, seed 42; NOT real MovieLens)",
        "n_edges": int(len(edges)),
        "n_users": int(prepared.n_users),
        "n_items": int(prepared.n_items),
        "svd_cv_reference_protocol": {
            "k": 10,
            "precision_mean": svd_cv["precision_mean"],
            "recall_mean": svd_cv["recall_mean"],
            "reference_floor_real_cosmetics": {"P@10": 0.1543, "R@10": 0.1270},
        },
        "same_split_top20": {
            "svd_ranker": svd_scores,
            "lightgcn": {
                "best_epoch": result.best_epoch,
                "val": {"precision": result.best_val_precision, "recall": result.best_val_recall},
                "test": {"precision": result.test_precision, "recall": result.test_recall},
            },
        },
        "lightgcn_beats_svd_val": bool(result.best_val_recall > svd_scores["val"]["recall"]),
        "lightgcn_beats_svd_test": bool(result.test_recall > svd_scores["test"]["recall"]),
        "config": {"dim": dim, "layers": layers, "epochs": epochs},
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__, work=True)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--layers", type=int, default=LAYERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with work_dir(args.work) as work, launches_since() as launches:
        result = run(work, dev, args.epochs, args.dim, args.layers)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["movielens_bench"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
