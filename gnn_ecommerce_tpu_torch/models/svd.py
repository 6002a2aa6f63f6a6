"""SVD matrix-factorization baseline (the reference's SVD notebook).

Counterpart of ``gnn_ecommerce_tpu/models/svd.py``: biased matrix
factorization ``r̂_ui = μ + b_u + b_i + p_u·q_i`` fitted to the edge
weights by minibatched MSE plus L2, with Adam, and surprise's threshold
Precision/Recall@K.

The fit keeps the JAX package's math:
- the objective is the batch MSE over valid rows plus ``reg`` times the
  four batch means (b_u², b_i², |p_u|², |q_i|²) over all ``batch_size`` rows,
  the padding rows (user 0, item 0) included;
- μ starts at the mean rating, the biases at 0, p and q at
  ``N(0, init_std²)``;
- Adam (``train/step.py:Adam``, optax's update) is dense over every row each
  step, as optax updates the whole pytree: a row that no batch touches
  still moves by its moments;
- each epoch shuffles the padded edge list by one permutation, then runs
  its batches in order.

The draws differ: the init and the per-epoch permutation (``torch.randperm``
on the device) come from one generator seeded by ``cfg.seed``, not from
JAX's PRNG. :func:`svd_epoch` takes the permutation, so a caller can feed
one.

Metric parity (surprise ``precision_recall_at_k``): for each user only that
user's TEST edges are ranked by estimate; relevant = true weight ≥
``rel_threshold``; recommended = estimate ≥ ``est_threshold`` among the
top-K by estimate; precision and recall over those sets, averaged over
users.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..train.step import Adam, AdamState


@dataclasses.dataclass
class SVDConfig:
    n_factors: int = 100        # surprise default
    n_epochs: int = 20          # surprise default
    lr: float = 0.02            # Adam step size
    reg: float = 0.02           # surprise default reg_all
    init_std: float = 0.1       # surprise default init_std_dev
    batch_size: int = 8192
    seed: int = 0


def init_svd(
    generator: torch.Generator,
    n_users: int,
    n_items: int,
    cfg: SVDConfig,
    device: str | torch.device | None = None,
) -> dict:
    """Zero μ and biases; p, q from ``N(0, init_std²)`` drawn on the
    generator's device (the default ``device``)."""
    dev = torch.device(device if device is not None else generator.device)
    gdev = generator.device

    def normal(rows: int) -> torch.Tensor:
        x = torch.randn(rows, cfg.n_factors, generator=generator, device=gdev)
        return (cfg.init_std * x).to(dev)

    p = normal(n_users)
    q = normal(n_items)
    return {
        "mu": torch.zeros((), device=dev),
        "b_u": torch.zeros(n_users, device=dev),
        "b_i": torch.zeros(n_items, device=dev),
        "p": p,
        "q": q,
    }


def predict(params: dict, users, items) -> torch.Tensor:
    return (
        params["mu"]
        + params["b_u"][users]
        + params["b_i"][items]
        + (params["p"][users] * params["q"][items]).sum(-1)
    )


def svd_loss(params: dict, u, i, r, valid, reg: float) -> torch.Tensor:
    """Batch MSE over the valid rows plus ``reg`` times the four batch
    means over every row."""
    err = (predict(params, u, i) - r) ** 2
    mse = (err * valid).sum() / valid.sum().clamp(min=1)
    l2 = reg * (
        (params["b_u"][u] ** 2).mean()
        + (params["b_i"][i] ** 2).mean()
        + (params["p"][u] ** 2).sum(-1).mean()
        + (params["q"][i] ** 2).sum(-1).mean()
    )
    return mse + l2


def svd_epoch(
    params: dict,
    opt: Adam,
    opt_state: AdamState,
    perm: torch.Tensor,
    data: tuple,
    batch_size: int,
    reg: float,
) -> None:
    """One epoch in place: the padded arrays ``data = (u, i, r, valid)``
    taken in the order ``perm``, then ``len(perm) // batch_size`` Adam steps
    over consecutive batches."""
    u, i, r, valid = (x[perm] for x in data)
    names = list(params)
    for lo in range(0, len(perm), batch_size):
        hi = lo + batch_size
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        with torch.enable_grad():
            loss = svd_loss(leaves, u[lo:hi], i[lo:hi], r[lo:hi], valid[lo:hi], reg)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        opt.update(dict(zip(names, grads)), opt_state, params)


def pad_edges(users, items, ratings, batch_size: int, device) -> tuple[tuple, int]:
    """The edge arrays padded to whole batches (user 0, item 0, rating 0,
    valid 0), on ``device``: ((u, i, r, valid), batch size)."""
    n = len(users)
    bsz = min(batch_size, n)
    pad = -(-n // bsz) * bsz - n
    arrays = (
        np.pad(np.asarray(users), (0, pad)).astype(np.int64),
        np.pad(np.asarray(items), (0, pad)).astype(np.int64),
        np.pad(np.asarray(ratings), (0, pad)).astype(np.float32),
        np.pad(np.ones(n, np.float32), (0, pad)),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays), bsz


def fit_svd(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    cfg: SVDConfig = SVDConfig(),
    device: str | torch.device = "cuda",
) -> dict:
    """Fit biased MF by minibatched MSE + L2 with Adam, shuffled per
    epoch, μ initialized to the mean rating. The edge arrays go to the
    device once; each epoch's shuffle is a permutation drawn there."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = init_svd(gen, n_users, n_items, cfg)
    params["mu"] = torch.tensor(float(np.mean(ratings)), dtype=torch.float32, device=dev)
    opt = Adam(cfg.lr)
    opt_state = opt.init(params)
    data, bsz = pad_edges(users, items, ratings, cfg.batch_size, dev)
    n_rows = len(data[0])
    for _ in range(cfg.n_epochs):
        perm = torch.randperm(n_rows, generator=gen, device=dev)
        svd_epoch(params, opt, opt_state, perm, data, bsz, cfg.reg)
    return params


def precision_recall_at_k(
    params: dict,
    test_users: np.ndarray,
    test_items: np.ndarray,
    test_ratings: np.ndarray,
    k: int = 10,
    rel_threshold: float = 1.0,
    est_threshold: float = 0.5,
) -> tuple[float, float]:
    """surprise ``precision_recall_at_k`` semantics over the test edge list:
    per user, rank ONLY their test items. The per-user counts are taken in
    one pass over the sorted edges; each user's precision and recall are
    the same divisions as the JAX package's loop, averaged the same way."""
    test_users = np.asarray(test_users)
    dev = params["p"].device
    with torch.no_grad():
        est = predict(
            params,
            torch.as_tensor(test_users, dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(test_items), dtype=torch.int64, device=dev),
        )
    est = est.cpu().numpy()
    order = np.lexsort((-est, test_users))
    u_s, est_s, rel_s = test_users[order], est[order], np.asarray(test_ratings)[order]
    uniq, start = np.unique(u_s, return_index=True)
    group = np.repeat(np.arange(len(uniq)), np.diff(np.append(start, len(u_s))))
    rank = np.arange(len(u_s)) - start[group]  # position in the est-descending run
    rel = rel_s >= rel_threshold
    rec = (est_s >= est_threshold) & (rank < k)
    n_rel = np.bincount(group, weights=rel, minlength=len(uniq)).astype(np.int64)
    n_rec = np.bincount(group, weights=rec, minlength=len(uniq)).astype(np.int64)
    n_both = np.bincount(group, weights=rel & rec, minlength=len(uniq)).astype(np.int64)
    precisions = [b / r if r else 0.0 for b, r in zip(n_both.tolist(), n_rec.tolist())]
    recalls = [b / r if r else 0.0 for b, r in zip(n_both.tolist(), n_rel.tolist())]
    return float(np.mean(precisions)), float(np.mean(recalls))
