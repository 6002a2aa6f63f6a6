"""Port of ``scripts/skyline_full_r3.py``: the weighted 2-hop co-occurrence
skyline on the full-scale corpus (``full_corpus_r3``), val Recall@20
(``scripts/skyline_full_r3.json``).

For each chunk of val users the score of every item is
``S = (R_w[chunk] · R_wᵀ) · R_w``, ``R_w`` the [users, items] matrix of
train edge weights; the user's train purchases are masked to -inf, the
top 20 taken, and the recall over the user's val purchases averaged over
all val users, as the script's loop does. Here both products run on the
card with ``R_w`` in CSR on the left (``torch.sparse.mm``:
``uuᵀ = R_w · Xᵀ``, then ``Sᵀ = R_wᵀ · uuᵀ`` for the dense chunk ``X``),
and the mask, the top 20 and the recall are taken for the whole chunk at
once.

The f32 sums run in another order than scipy's, and ``torch.topk`` and
``np.argpartition`` choose differently among items tied at the 20th
score, so a user's recall can differ where the 20th and the 21st scores
are equal: ``tied_users`` counts those users (an ``EXTRA_KEYS`` key, with
the chunk's users, the card, the kernels' launches and the quality bar,
``bars.skyline_full_r3``: a missed bar raises). :func:`skyline_scipy` is
the script's own arithmetic on the host, user by user, to hold the card's
against.

    python -m gnn_ecommerce_tpu_torch.runs.skyline_full_r3 [-d DATA_DIR] [--device cuda] [--out x.json]
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..data.prepare import CsrList, EvalSplit, PreparedData
from ..device import resolve_device
from . import _load, bars, full_corpus_r3
from ._cli import emit, launches_since, quality_parser

K = 20
# Val users a chunk: the [n_users, CHUNK] f32 intermediate takes 6.4 GB at
# the full corpus's 1,552,888 users (the script's host loop took 128).
CHUNK = 1024
TPU_LIGHTGCN, TPU_POPULARITY = 0.3163, 0.03443
EXTRA_KEYS = {"device", "launches", "tied_users", "chunk_users", "bars"}


@dataclasses.dataclass
class Skyline:
    recall: np.ndarray  # [val users] f64, each user's Recall@K
    tied: np.ndarray  # [val users] bool, the K-th and (K+1)-th scores equal

    @property
    def value(self) -> float:
        return float(np.mean(self.recall))


def weight_matrices(prepared: PreparedData, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``R_w`` [users, items] and ``R_wᵀ``, f32 CSR on ``device``."""
    u = torch.as_tensor(prepared.edge_user, dtype=torch.int64)
    i = torch.as_tensor(prepared.edge_item_node - prepared.n_users, dtype=torch.int64)
    w = torch.as_tensor(prepared.edge_weight, dtype=torch.float32)
    shape = (prepared.n_users, prepared.n_items)
    coo = torch.sparse_coo_tensor(torch.stack([u, i]), w, shape, check_invariants=False).coalesce()
    r = coo.to_sparse_csr().to(device)
    rt = coo.transpose(0, 1).coalesce().to_sparse_csr().to(device)
    return r, rt


def _rows(csr: CsrList, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    """(row in the chunk, value) of rows ``lo:hi`` of ``csr``."""
    start, end = csr.indptr[lo], csr.indptr[hi]
    return np.repeat(np.arange(hi - lo), np.diff(csr.indptr[lo : hi + 1])), csr.values[start:end]


def skyline(prepared: PreparedData, split: EvalSplit | None = None, device="cuda",
            chunk: int = CHUNK, k: int = K) -> Skyline:
    """Each ``split`` (default val) user's Recall@k of the 2-hop skyline."""
    dev = resolve_device(device)
    split = prepared.val if split is None else split
    r, rt = weight_matrices(prepared, dev)
    # Each user's row of R_w, to scatter a chunk of users into a dense X.
    order = np.argsort(prepared.edge_user, kind="stable")
    user_ptr = np.searchsorted(prepared.edge_user[order], np.arange(prepared.n_users + 1))
    items = (prepared.edge_item_node - prepared.n_users)[order]
    weights = prepared.edge_weight[order].astype(np.float32)
    n = len(split.user_ids)
    recall, tied = np.zeros(n), np.zeros(n, bool)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ids = split.user_ids[lo:hi]
        lens = user_ptr[ids + 1] - user_ptr[ids]
        arcs = np.repeat(user_ptr[ids], lens) + (
            np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
        )
        x = torch.zeros(hi - lo, prepared.n_items, device=dev)
        x[torch.as_tensor(np.repeat(np.arange(hi - lo), lens), device=dev),
          torch.as_tensor(items[arcs], device=dev)] = torch.as_tensor(weights[arcs], device=dev)
        uu_t = torch.sparse.mm(r, x.t().contiguous())  # [users, chunk]
        del x
        s = torch.sparse.mm(rt, uu_t).t()  # [chunk, items]
        del uu_t
        mr, mi = _rows(split.train_mask, lo, hi)
        s[torch.as_tensor(mr, device=dev), torch.as_tensor(mi, device=dev)] = -torch.inf
        vals, top = torch.topk(s, k + 1, dim=1)
        del s
        tr, ti = _rows(split.truth, lo, hi)
        truth = torch.zeros(hi - lo, prepared.n_items, dtype=torch.bool, device=dev)
        truth[torch.as_tensor(tr, device=dev), torch.as_tensor(ti, device=dev)] = True
        hits = truth.gather(1, top[:, :k]).sum(1).cpu().numpy()
        n_truth = np.diff(split.truth.indptr[lo : hi + 1])
        recall[lo:hi] = hits / np.maximum(1, n_truth)
        tied[lo:hi] = (vals[:, k - 1] == vals[:, k]).cpu().numpy()
    return Skyline(recall, tied)


def skyline_scipy(prepared: PreparedData, split: EvalSplit | None = None, k: int = K) -> np.ndarray:
    """Each ``split`` (default val) user's Recall@k by the script's
    arithmetic on the host: scipy products over chunks of 128 users, the
    mask and ``np.argpartition`` row by row."""
    import scipy.sparse as sp

    split = prepared.val if split is None else split
    nu, ni = prepared.n_users, prepared.n_items
    rw = sp.csr_matrix((prepared.edge_weight.astype(np.float32),
                        (prepared.edge_user, prepared.edge_item_node - nu)), shape=(nu, ni))
    rwt = rw.T.tocsr()
    recs = []
    for lo in range(0, len(split.user_ids), 128):
        chunk = split.user_ids[lo : lo + 128]
        s_all = np.asarray(np.asarray(rw[chunk].toarray() @ rwt) @ rw)
        for r in range(len(chunk)):
            s = s_all[r]
            m = split.train_mask.row(lo + r)
            if len(m):
                s[m] = -np.inf
            top = np.argpartition(s, -k)[-k:]
            t = split.truth.row(lo + r)
            recs.append(len(np.intersect1d(top, t)) / max(1, len(t)))
    return np.array(recs)


def run(prepared: PreparedData, device="cuda") -> dict:
    """The skyline over the val users; the script's keys plus
    ``tied_users`` and ``chunk_users`` (without the card)."""
    t0 = time.perf_counter()
    sky = skyline(prepared, device=device)
    if resolve_device(device).type == "cuda":
        torch.cuda.synchronize()
    return {
        "metric": "weighted 2-hop co-occurrence skyline, val Recall@20",
        "value": round(sky.value, 5),
        "n_val_users": len(sky.recall),
        "lightgcn_trained_val_recall_at_20": TPU_LIGHTGCN,
        "popularity_baseline": TPU_POPULARITY,
        "wall_s": round(time.perf_counter() - t0, 1),
        "tied_users": int(sky.tied.sum()),
        "chunk_users": CHUNK,
    }


def main(argv=None) -> int:
    ap = quality_parser(__doc__)
    ap.add_argument("-d", "--data-dir", help="a saved artifact of full_corpus_r3 (default: build it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prepared, _, _ = full_corpus_r3.prepared_of(args.data_dir)
    with launches_since() as launches:
        result = run(prepared, dev)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["skyline_full_r3"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
