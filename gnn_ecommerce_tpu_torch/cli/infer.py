"""Offline inference CLI (same flags as ``gnn_ecommerce_tpu/cli/infer.py``,
plus ``--device``).

    python -m gnn_ecommerce_tpu_torch.cli.infer -d data/prepared -c model-checkpoints

Loads the prepared-data artifact and a checkpoint, propagates once through
the layered ``get_embedding`` in f32, evaluates P/R@K over the val ∪ test
purchase users, and writes into ``--out``:

    metrics_K{K}.csv   per-user MARK table and its means
    hit_df.csv         per-(user, hit) shortest paths, flagged when longer
                       than 3 hops

the bytes that the JAX CLI writes for the same embedding. Runs on ``cuda``
unless ``--device cpu`` is given. The propagation is the layered one, not
the service's fast forward: the fast forward's f32 item-item operator takes
longer to build than one layered propagation takes.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..convert import params_to_torch
from ..data.artifacts import load_prepared
from ..data.prepare import CsrList, EvalSplit
from ..device import resolve_device
from ..eval.evaluate import build_eval_batch, evaluate
from ..eval.metrics import mark_frame
from ..explain.paths import build_adjacency, hit_paths_frame
from ..graph.build import build_graph
from ..models.lightgcn import get_embedding
from ..train.checkpoint import BEST_NAME, find_leaf, load_checkpoint, model_config


def _pairs(split: EvalSplit, csr: CsrList) -> tuple[np.ndarray, np.ndarray]:
    return np.repeat(split.user_ids, csr.lengths()), np.asarray(csr.values, np.int64)


def _unique_pairs(users: np.ndarray, items: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (user, item) pairs, sorted by (user, item)."""
    order = np.lexsort((items, users))
    users, items = users[order], items[order]
    keep = np.ones(len(users), dtype=bool)
    keep[1:] = (users[1:] != users[:-1]) | (items[1:] != items[:-1])
    return users[keep], items[keep]


def combined_eval_split(prepared) -> EvalSplit:
    """val ∪ test users with merged truth and mask lists: the truth is the
    union of both splits' truth pairs, the mask the union of their train
    masks restricted to the truth's users; each user's items ascending."""
    parts = [(_pairs(s, s.truth), _pairs(s, s.train_mask)) for s in (prepared.val, prepared.test)]
    truth_u, truth_i = _unique_pairs(*(np.concatenate(c) for c in zip(*(t for t, _ in parts))))
    mask_u, mask_i = _unique_pairs(*(np.concatenate(c) for c in zip(*(m for _, m in parts))))
    users = np.unique(truth_u)

    def to_csr(u: np.ndarray, i: np.ndarray) -> CsrList:
        keep = np.isin(u, users)
        slots = np.searchsorted(users, u[keep])
        indptr = np.zeros(len(users) + 1, np.int64)
        np.add.at(indptr, slots + 1, 1)
        return CsrList(np.cumsum(indptr), i[keep].astype(np.int64))

    return EvalSplit(
        user_ids=users.astype(np.int64),
        truth=to_csr(truth_u, truth_i),
        train_mask=to_csr(mask_u, mask_i),
    )


@dataclasses.dataclass
class InferResult:
    """What one run computed: the means, the table sizes, the seconds of
    each stage, and the propagated embedding it ranked with."""

    n_users: int
    precision: float
    recall: float
    hit_paths: int
    longer_than_3: int
    seconds: dict
    final_emb: torch.Tensor


def main(argv=None) -> InferResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-d", "--data-dir", required=True, help="prepared artifact dir")
    ap.add_argument("-c", "--checkpoint-dir", required=True)
    ap.add_argument("--checkpoint-name", default=BEST_NAME)
    ap.add_argument("-k", type=int, default=20)
    ap.add_argument("--out", default="model-recommendations")
    ap.add_argument(
        "--no-paths", action="store_true", help="skip shortest-path explainability"
    )
    ap.add_argument(
        "--max-path-users", type=int, default=0,
        help="cap the number of hit users BFS-explained (0 = all; at full "
        "scale each user is one CSR BFS over ~20M arcs)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seconds = {}
    t0 = time.perf_counter()
    prepared = load_prepared(args.data_dir)
    leaves, meta = load_checkpoint(args.checkpoint_dir, args.checkpoint_name)
    cfg = model_config(meta, prepared.n_users + prepared.n_items)
    params = params_to_torch({"embedding": find_leaf(leaves, meta, "embedding")}, dev)
    graph = build_graph(
        prepared.edge_user,
        prepared.edge_item_node,
        prepared.edge_weight,
        prepared.n_users,
        prepared.n_items,
        items_offset=True,
        device=dev,
    )
    seconds["load"] = time.perf_counter() - t0
    print(f"propagating {cfg.num_layers} layers over {graph.num_edges} edges ...")
    t0 = time.perf_counter()
    with torch.no_grad():
        final_emb = get_embedding(params, graph, cfg)
    if final_emb.is_cuda:
        torch.cuda.synchronize(dev)
    seconds["propagate"] = time.perf_counter() - t0
    del graph

    t0 = time.perf_counter()
    split = combined_eval_split(prepared)
    batch = build_eval_batch(split, dev)
    with torch.no_grad():
        precision, recall, per_recall, per_precision, topk_idx = evaluate(
            final_emb, batch, prepared.n_users, k=args.k
        )
    seconds["eval"] = time.perf_counter() - t0
    print(f"{len(split.user_ids)} eval users: P@{args.k} {precision:.6f}, "
          f"R@{args.k} {recall:.6f}")

    os.makedirs(args.out, exist_ok=True)
    truth_lists = [split.truth.row(i) for i in range(len(split.user_ids))]
    frame = mark_frame(split.user_ids, truth_lists, topk_idx, per_recall, per_precision)
    metrics_path = os.path.join(args.out, f"metrics_K{args.k}.csv")
    frame.to_csv(metrics_path)
    print(f"per-user metrics -> {metrics_path}")

    n_paths = n_long = 0
    if not args.no_paths:
        t0 = time.perf_counter()
        adj = build_adjacency(
            prepared.edge_user, prepared.edge_item_node, prepared.n_users, prepared.n_items
        )
        path_users = split.user_ids
        path_topk = topk_idx
        path_truth = truth_lists
        if args.max_path_users > 0:
            hit_rows = np.flatnonzero(np.asarray(per_recall) > 0)[: args.max_path_users]
            path_users = split.user_ids[hit_rows]
            path_topk = np.asarray(topk_idx)[hit_rows]
            path_truth = [truth_lists[i] for i in hit_rows]
            print(f"explaining the first {len(hit_rows)} hit users")
        hit_df = hit_paths_frame(
            adj, path_users, path_topk, [set(map(int, t)) for t in path_truth]
        )
        hit_path = os.path.join(args.out, "hit_df.csv")
        hit_df.to_csv(hit_path)
        n_paths = len(hit_df)
        n_long = int(hit_df["longer_than_3"].sum())
        seconds["explain"] = time.perf_counter() - t0
        print(f"{n_paths} hit paths ({n_long} longer than 3 hops) -> {hit_path}")
    print("seconds: " + " ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return InferResult(
        n_users=len(split.user_ids), precision=precision, recall=recall,
        hit_paths=n_paths, longer_than_3=n_long, seconds=seconds, final_emb=final_emb,
    )


if __name__ == "__main__":
    main()
