"""Inputs of a run, made from ``--seed``: the graph, the sampler's arrays, the
tables and the request streams.

The graph generator is ``gnn_ecommerce_tpu_torch/bench.py:synthetic_edges``
(itself root ``bench.py``'s), copied so that a change to the program cannot
change the yardstick, seeded from the run's seed instead of 0 and drawn in
bulk on the card (numpy took 37-45 s of each run's set-up there): a
cosmetics-shop-scale synthetic graph with Zipf users (0.75) and items (1.0),
48 planted co-clusters that keep 70% of the draws, weights 1.0 (a purchase,
~20%) or uniform in [0.01, 0.5), and 2.5% of the purchases held out. Every
seed gives a graph of the same size (the unique edges are cut to
``n_edges``); only which edges varies.

Nothing here imports the program: the adapters that hand these arrays to the
program's own types live in the drivers.
"""
from __future__ import annotations

import numpy as np
import torch

# Independent streams of one run, spawned from its seed in this order.
STREAMS = ("graph", "table", "table_b", "sampler", "traffic", "warm")


def streams(seed: int) -> dict:
    """One ``SeedSequence`` child per stream of ``STREAMS``; any whole
    number, however large, is a valid seed."""
    children = np.random.SeedSequence(int(seed)).spawn(len(STREAMS))
    return dict(zip(STREAMS, children))


def torch_seed(seq: np.random.SeedSequence) -> int:
    """A 63-bit seed for a ``torch.Generator`` from one stream."""
    return int(seq.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def skewed_ids(gen, n: int, size: int, a: float) -> torch.Tensor:
    """Zipf-ish ids: the inverse CDF of rank weights ``rank**-a`` at
    ``size`` uniform draws."""
    cdf = torch.arange(1, n + 1, dtype=torch.float64, device=gen.device).pow(-a).cumsum(0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, dtype=torch.float64, generator=gen, device=gen.device)
    return torch.searchsorted(cdf, u).clamp_(0, n - 1)


def synthetic_edges(gen, n_users: int, n_items: int, n_edges: int, holdout_share: float = 0.025,
                    n_clusters: int = 48, in_cluster: float = 0.7, purchase_share: float = 0.2):
    """The graph's edges and the held-out purchases from the
    ``torch.Generator`` ``gen``, made on its device and returned as numpy
    arrays: ``((u, i, w), (held_u, held_i))``, local item ids, ``w`` f32.
    The steps are ``bench.py:synthetic_edges``'s, drawn in bulk on the
    device instead of by numpy on the host."""
    dev = gen.device
    rand = lambda n, **kw: torch.rand(n, generator=gen, device=dev, **kw)
    over = int(n_edges * 1.35)
    u = skewed_ids(gen, n_users, over, 0.75)
    i = skewed_ids(gen, n_items, over, 1.0)
    user_cluster = torch.randint(0, n_clusters, (n_users,), generator=gen, device=dev)
    item_cluster = torch.randint(0, n_clusters, (n_items,), generator=gen, device=dev)
    order = torch.argsort(item_cluster, stable=True)
    cluster_start = torch.searchsorted(item_cluster[order], torch.arange(n_clusters + 1, device=dev))
    in_cl = rand(over) < in_cluster
    ev_cluster = user_cluster[u[in_cl]]
    size = cluster_start[ev_cluster + 1] - cluster_start[ev_cluster]
    ok = size > 0
    ranks = torch.minimum((size[ok] * rand(int(ok.sum()), dtype=torch.float64) ** 2).long(), size[ok] - 1)
    i[torch.nonzero(in_cl).squeeze(1)[ok]] = order[cluster_start[ev_cluster[ok]] + ranks]
    shift = max(1, int(n_items - 1).bit_length())
    key = torch.unique(u * (1 << shift) + i)
    key = key[torch.randperm(len(key), generator=gen, device=dev)][:n_edges]
    u, i = key >> shift, key & ((1 << shift) - 1)
    w = torch.where(rand(len(u)) < purchase_share, torch.ones((), device=dev),
                    0.01 + 0.49 * rand(len(u)))
    purch = torch.nonzero(w == 1.0).squeeze(1)
    held = purch[torch.randperm(len(purch), generator=gen, device=dev)[:int(holdout_share * len(purch))]]
    keep = torch.ones(len(u), dtype=torch.bool, device=dev)
    keep[held] = False
    host = lambda t: t.cpu().numpy()
    return (host(u[keep]), host(i[keep]), host(w[keep]).astype(np.float32)), (host(u[held]), host(i[held]))


def graph_edges(config: dict, seed: int, device="cpu"):
    """``synthetic_edges`` at the configuration's graph shape, drawn on
    ``device`` (a seed gives the same graph on the same kind of device)."""
    g = config["graph"]
    gen = torch.Generator(device=torch.device(device)).manual_seed(torch_seed(streams(seed)["graph"]))
    return synthetic_edges(gen, g["n_users"], g["n_items"], g["n_edges"], g["holdout_share"])


def purchase_rows(u, i, w, n_users: int):
    """The purchases (weight 1.0) as per-user rows: ``(pos_users, indptr,
    pi_s)``, the positives of ``pos_users[k]`` being
    ``pi_s[indptr[k]:indptr[k+1]]``, node ids (items offset by
    ``n_users``), ascending. Copied from the program's
    ``bench.py:purchase_sampler``."""
    purch = w == 1.0
    pu, pi = u[purch], i[purch] + n_users
    pos_users = np.unique(pu)
    slot = np.searchsorted(pos_users, pu)
    order = np.lexsort((pi, slot))
    slot_s, pi_s = slot[order], pi[order]
    indptr = np.zeros(len(pos_users) + 1, np.int64)
    np.add.at(indptr, slot_s + 1, 1)
    return pos_users, np.cumsum(indptr), pi_s


def xavier_table(seq: np.random.SeedSequence, n_nodes: int, dim: int, device) -> torch.Tensor:
    """The [n_nodes, dim] f32 embedding table, Xavier-uniform (bound
    ``sqrt(6 / (n_nodes + dim))``), drawn on ``device`` by one call of a
    generator seeded from ``seq``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(torch_seed(seq))
    bound = (6.0 / (n_nodes + dim)) ** 0.5
    return torch.empty(n_nodes, dim, dtype=torch.float32, device=dev).uniform_(-bound, bound, generator=gen)


def request_stream(rng, n_requests: int, seconds: float, sizes, user_weight: np.ndarray):
    """An open loop's requests over ``[0, seconds)``: ``(due, ids)``, ``due``
    ascending seconds (``n_requests`` uniform arrivals sorted: a Poisson
    process given its count), ``ids`` one int64 array a request. ``sizes``
    is ``[[users, share], ...]``; every stream of the same count holds the
    same sizes, in another order. Users are drawn with probability
    ``user_weight / user_weight.sum()``, with replacement."""
    due = np.sort(rng.random(n_requests) * seconds)
    counts = [int(round(share * n_requests)) for _, share in sizes]
    counts[0] += n_requests - sum(counts)
    per = rng.permutation(np.repeat([int(s) for s, _ in sizes], counts))
    flat = rng.choice(len(user_weight), size=int(per.sum()), p=user_weight / user_weight.sum())
    return due, np.split(flat.astype(np.int64), np.cumsum(per)[:-1])
