"""Port of ``scripts/svd_full_r5.py``: the biased-MF SVD baseline on the
full-scale corpus (``full_corpus_r3``), fitted on the train split the
LightGCN run trains on (``SVD_FULL_r5.json``).

Two metrics, as the script's:

1. surprise-parity threshold P/R@10 over each user's own held-out edges
   (``precision_recall_at_k``, relevant at weight >= 1.0, recommended at an
   estimate >= 0.5), on the val and test edge lists
   (``full_corpus_r3.heldout_edges``);
2. full-ranking P/R@20 under the LightGCN protocol (every item scored per
   eval user, train purchases masked, ``evaluate_bucketed`` over
   ``build_eval_buckets(split, width_floor=256)``), the score
   ``b_u + b_i + p_u·q_i`` packed as ``[p | b_u | 1] · [q | 1 | b_i]`` (mu
   does not change a ranking).

The line has the script's keys plus ``EXTRA_KEYS``: the card, the
kernels' launches, the generator and the quality bars (``bars.svd_full_r5``;
a missed bar raises). The fit draws its init and its permutations from a
torch generator seeded by ``seed``, not from JAX's PRNG (a deliberate
difference). ``comparators_same_corpus`` are the TPU's numbers that the
script wrote.

    python -m gnn_ecommerce_tpu_torch.runs.svd_full_r5 [-d DATA_DIR] [--device cuda] [--out x.json]

``-d`` reuses a corpus that ``full_corpus_r3 -o DATA_DIR`` saved, its
held-out edges included, in place of building it.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..data.events import Edges
from ..data.prepare import PreparedData, prepare_splits
from ..device import resolve_device
from ..eval.evaluate import build_eval_buckets, evaluate_bucketed
from ..models.svd import SVDConfig, fit_svd, precision_recall_at_k
from . import _load, bars, full_corpus_r3
from ._cli import emit, launches_since, quality_parser

CONFIG = SVDConfig(n_factors=100, n_epochs=20, batch_size=65536, seed=42)
PARITY_K, RANK_K = 10, 20
REL_THRESHOLD, EST_THRESHOLD = 1.0, 0.5
WIDTH_FLOOR = 256
TPU_COMPARATORS = {
    "lightgcn_val_recall@20": 0.3244,
    "lightgcn_test_recall@20": 0.3185,
    "popularity_val_recall@20": 0.0344,
    "weighted_2hop_skyline_val_recall@20": 0.178,
}
EXTRA_KEYS = {"device", "launches", "generator", "bars"}
GENERATOR = "init and per-epoch permutations from a torch generator seeded by seed (not JAX's PRNG)"


def fit_train_split(prepared: PreparedData, cfg: SVDConfig, device) -> dict:
    """The SVD fitted on the train split (local item ids)."""
    return fit_svd(
        np.asarray(prepared.edge_user, np.int64),
        np.asarray(prepared.edge_item_node, np.int64) - prepared.n_users,
        np.asarray(prepared.edge_weight, np.float32),
        prepared.n_users, prepared.n_items, cfg, device=device,
    )


def parity(params: dict, heldout: dict[str, Edges]) -> dict:
    """Metric 1 on each held-out edge list."""
    out = {}
    for name, e in heldout.items():
        p10, r10 = precision_recall_at_k(
            params, e.user_id, e.item_id, np.asarray(e.weight, np.float32), k=PARITY_K,
            rel_threshold=REL_THRESHOLD, est_threshold=EST_THRESHOLD,
        )
        out[name] = {"precision@10": p10, "recall@10": r10, "edges": int(len(e))}
    return out


def ranking_embedding(params: dict) -> torch.Tensor:
    """``[p | b_u | 1]`` over ``[q | 1 | b_i]``: a row product is
    ``p_u·q_i + b_u + b_i``."""
    ones_u = torch.ones_like(params["b_u"])[:, None]
    ones_i = torch.ones_like(params["b_i"])[:, None]
    return torch.cat([
        torch.cat([params["p"], params["b_u"][:, None], ones_u], 1),
        torch.cat([params["q"], ones_i, params["b_i"][:, None]], 1),
    ]).float()


def full_ranking(params: dict, prepared: PreparedData) -> dict:
    """Metric 2 on the val and test splits."""
    emb = ranking_embedding(params)
    out = {}
    for name, split in (("val", prepared.val), ("test", prepared.test)):
        buckets = build_eval_buckets(split, width_floor=WIDTH_FLOOR, device=emb.device)
        with torch.no_grad():
            p20, r20 = evaluate_bucketed(emb, buckets, prepared.n_users, k=RANK_K)
        out[name] = {"precision@20": p20, "recall@20": r20, "users": int(len(split.user_ids))}
    return out


def run(
    prepared: PreparedData,
    heldout: dict[str, Edges],
    etl_s: float = 0.0,
    cfg: SVDConfig = CONFIG,
    device="cuda",
) -> dict:
    """Fit, then both metrics; the script's keys (without the card)."""
    t_all = time.perf_counter()
    dev = resolve_device(device)
    t0 = time.perf_counter()
    params = fit_train_split(prepared, cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    _load.log(f"fit: {len(prepared.edge_user)} edges, {cfg.n_epochs} epochs ({fit_s:.1f} s)")
    t0 = time.perf_counter()
    par = parity(params, heldout)
    parity_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = full_ranking(params, prepared)
    rank_s = time.perf_counter() - t0
    _load.log(f"parity {par}; full ranking {full}")
    return {
        "benchmark": "svd_full_r5",
        "dataset": "synthetic cosmetics-scale (full_corpus_r3, no egress)",
        "model": "biased-MF (models/svd.py), Adam, same objective as surprise SVD",
        "config": {
            "n_factors": cfg.n_factors,
            "n_epochs": cfg.n_epochs,
            "batch_size": cfg.batch_size,
            "train_edges": int(len(prepared.edge_user)),
            "n_users": int(prepared.n_users),
            "n_items": int(prepared.n_items),
        },
        "surprise_parity": {
            **par,
            "protocol": (
                "threshold P/R@10 over each user's own held-out edges; deviation from the "
                "reference notebook: train/val/test split instead of 5-fold CV"
            ),
            "reference_real_data": {"precision@10": 0.1543, "recall@10": 0.1270},
        },
        "full_ranking": {
            **full,
            "protocol": (
                "LightGCN eval protocol: all items scored per eval user, train purchases "
                "masked -inf, Recall@20 (eval/evaluate.evaluate_bucketed)"
            ),
            "comparators_same_corpus": dict(TPU_COMPARATORS),
        },
        "timings_s": {
            "etl": etl_s,
            "fit": fit_s,
            "surprise_parity_eval": parity_s,
            "full_ranking_eval": rank_s,
            "total": etl_s + time.perf_counter() - t_all,
        },
        "generator": GENERATOR,
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__)
    ap.add_argument("-d", "--data-dir", help="a saved corpus of full_corpus_r3 (default: build it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.data_dir:
        prepared, _ = full_corpus_r3.load_corpus(args.data_dir)
        heldout = full_corpus_r3.load_heldout(args.data_dir)
    else:
        tr, va, te, _ = full_corpus_r3.build_splits()
        heldout = full_corpus_r3.heldout_edges(tr, va, te)
        prepared = prepare_splits(tr, va, te)
        del tr, va, te
    etl_s = time.perf_counter() - t0
    with launches_since() as launches:
        result = run(prepared, heldout, etl_s, CONFIG, dev)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["svd_full_r5"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
