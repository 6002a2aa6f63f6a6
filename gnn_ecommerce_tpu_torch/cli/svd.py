"""SVD baseline CLI (same flags as ``gnn_ecommerce_tpu/cli/svd.py``, plus
``--device``).

K-fold cross-validated biased-MF baseline over a weighted edge list, with
surprise-parity threshold Precision/Recall@K.

    python -m gnn_ecommerce_tpu_torch.cli.svd --edges u_i_weight.csv
    python -m gnn_ecommerce_tpu_torch.cli.svd --movielens u.data --folds 3 -k 10

The folds are the JAX CLI's: one ``np.random.default_rng(seed)``
permutation of the edge rows, cut into ``folds`` equal runs. Runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.events import Edges, read_csv
from ..device import resolve_device
from ..models.svd import SVDConfig, fit_svd, precision_recall_at_k


def cv_folds(n: int, folds: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(train rows, test rows) of each fold over ``n`` edge rows."""
    perm = np.random.default_rng(seed).permutation(n)
    bounds = np.linspace(0, n, folds + 1).astype(np.int64)
    return [
        (np.concatenate([perm[: bounds[f]], perm[bounds[f + 1] :]]), perm[bounds[f] : bounds[f + 1]])
        for f in range(folds)
    ]


def run_cv(
    edges: Edges,
    folds: int = 5,
    k: int = 10,
    cfg: SVDConfig | None = None,
    rel_threshold: float = 1.0,
    est_threshold: float = 0.5,
    device: str | torch.device = "cuda",
) -> dict:
    """K-fold CV over edge rows (surprise's ``cross_validate``); ids are
    densified first. Returns per-fold and mean P/R@K."""
    cfg = cfg or SVDConfig()
    dev = resolve_device(device)
    users, u_idx = np.unique(edges.user_id, return_inverse=True)
    items, i_idx = np.unique(edges.item_id, return_inverse=True)
    w = np.asarray(edges.weight, np.float32)
    precs, recs = [], []
    for train, test in cv_folds(len(w), folds, cfg.seed):
        params = fit_svd(
            u_idx[train], i_idx[train], w[train], len(users), len(items), cfg, device=dev
        )
        p, r = precision_recall_at_k(
            params, u_idx[test], i_idx[test], w[test], k=k,
            rel_threshold=rel_threshold, est_threshold=est_threshold,
        )
        precs.append(p)
        recs.append(r)
    return {
        "k": k,
        "folds": folds,
        "precision_per_fold": precs,
        "recall_per_fold": recs,
        "precision_mean": float(np.mean(precs)),
        "recall_mean": float(np.mean(recs)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--edges", help="weighted-edge CSV (user_id,item_id,weight)")
    src.add_argument("--movielens", help="MovieLens ratings file")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--factors", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", help="write results JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.movielens:
        from ..data.movielens import load_movielens

        edges = load_movielens(args.movielens)
    else:
        cols = read_csv(args.edges)
        missing = {"user_id", "item_id", "weight"} - set(cols)
        if missing:
            raise SystemExit(f"edges CSV missing columns: {sorted(missing)}")
        edges = Edges(cols["user_id"], cols["item_id"], cols["weight"])
    cfg = SVDConfig(n_factors=args.factors, n_epochs=args.epochs)
    result = run_cv(edges, folds=args.folds, k=args.k, cfg=cfg, device=dev)
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
