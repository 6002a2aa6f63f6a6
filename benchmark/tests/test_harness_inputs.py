"""The copied generator and the request streams: the same seed gives the same
inputs, another seed other inputs of the same size."""
import numpy as np
import torch

from benchmark import inputs

CONFIG = {"graph": {"n_users": 3000, "n_items": 400, "n_edges": 20000, "holdout_share": 0.025}}
BIG = 2**31 + 12345


def test_graph_repeats_per_seed():
    (u1, i1, w1), (hu1, hi1) = inputs.graph_edges(CONFIG, BIG)
    (u2, i2, w2), (hu2, hi2) = inputs.graph_edges(CONFIG, BIG)
    for a, b in ((u1, u2), (i1, i2), (w1, w2), (hu1, hu2), (hi1, hi2)):
        np.testing.assert_array_equal(a, b)


def test_other_seed_same_size():
    """Where the draws hold more unique edges than the shape asks for (as at
    full scale), every seed gives exactly ``n_edges``."""
    sparse = {"graph": {**CONFIG["graph"], "n_edges": 2000}}
    (u1, _, w1), held1 = inputs.graph_edges(sparse, 1)
    (u2, _, _), held2 = inputs.graph_edges(sparse, 2)
    assert len(u1) + len(held1[0]) == len(u2) + len(held2[0]) == 2000
    assert not np.array_equal(u1[:100], u2[:100])
    assert set(np.unique(w1[w1 < 1])).isdisjoint({1.0}) and (w1 == 1.0).mean() > 0.1


def test_generator_draws_the_programs_distributions():
    """``bench.py:synthetic_edges``'s shape: about a fifth of the edges are
    purchases, 2.5% of them held out, degrees skewed towards the first ids,
    edges unique."""
    (u, i, w), (hu, _) = inputs.graph_edges(CONFIG, 5)
    buys = int((w == 1.0).sum()) + len(hu)
    assert 0.17 < buys / (len(u) + len(hu)) < 0.23
    assert len(hu) == int(0.025 * buys)
    assert ((w > 0.01) & (w < 0.5) | (w == 1.0)).all()
    deg = np.bincount(u, minlength=3000)
    assert deg[:30].mean() > 5 * deg.mean()
    keys = u * 400 + i
    assert len(np.unique(keys)) == len(keys)


def test_tables_repeat_and_differ():
    seeds = inputs.streams(BIG)
    a = inputs.xavier_table(seeds["table"], 100, 8, "cpu")
    b = inputs.xavier_table(inputs.streams(BIG)["table"], 100, 8, "cpu")
    c = inputs.xavier_table(seeds["table_b"], 100, 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= (6 / 108) ** 0.5


def test_request_stream_same_sizes_other_order():
    weight = np.arange(1, 51, dtype=np.float64)
    sizes = [[1, 0.9], [64, 0.1]]
    d1, ids1 = inputs.request_stream(np.random.default_rng(1), 200, 10.0, sizes, weight)
    _, ids2 = inputs.request_stream(np.random.default_rng(2), 200, 10.0, sizes, weight)
    assert sorted(map(len, ids1)) == sorted(map(len, ids2))
    assert [len(x) for x in ids1] != [len(x) for x in ids2]
    assert sum(len(x) == 64 for x in ids1) == 20
    assert np.all(np.diff(d1) >= 0) and 0 <= d1[0] and d1[-1] < 10.0
    flat = np.concatenate(ids1)
    assert flat.min() >= 0 and flat.max() < 50


def test_purchase_rows():
    u = np.array([2, 0, 2, 1, 0])
    i = np.array([1, 3, 0, 2, 1])
    w = np.array([1.0, 1.0, 1.0, 0.3, 0.2], np.float32)
    users, indptr, items = inputs.purchase_rows(u, i, w, n_users=3)
    np.testing.assert_array_equal(users, [0, 2])
    np.testing.assert_array_equal(indptr, [0, 1, 3])
    np.testing.assert_array_equal(items, [3 + 3, 0 + 3, 1 + 3])
