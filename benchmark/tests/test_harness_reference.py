"""The plain reference and the judge against hand-written tiny cases."""
import math

import numpy as np
import pytest
import torch

from benchmark.reference import judge
from benchmark.reference import lightgcn as ref
from benchmark.reference.precision import FP8, TF32, round_tf32

# Two users, two items; edges (user, item, weight).
U, I, W = np.array([0, 0, 1]), np.array([0, 1, 1]), np.array([1.0, 0.5, 1.0], np.float32)


def dense_adjacency():
    """Â by hand: degrees u0 1.5, u1 1, i0 1, i1 1.5; nodes u0, u1, i0, i1."""
    a = np.zeros((4, 4))
    for u, i, w, du, di in ((0, 0, 1.0, 1.5, 1.0), (0, 1, 0.5, 1.5, 1.5), (1, 1, 1.0, 1.0, 1.5)):
        a[u, 2 + i] = a[2 + i, u] = w / math.sqrt(du * di)
    return a


def test_adjacency_and_final_embedding_by_hand():
    adj = ref.Adjacency(U, I, W, 2, 2, "cpu")
    np.testing.assert_allclose(adj.A.to_dense().numpy(), dense_adjacency(), rtol=1e-6)
    e = np.arange(8, dtype=np.float32).reshape(4, 2) / 10
    a = dense_adjacency()
    want = sum(np.linalg.matrix_power(a, l) @ e for l in range(4)) / 4
    got = ref.final_embedding(adj, torch.tensor(e), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bpr_loss_and_gradient_by_hand():
    adj = ref.Adjacency(U, I, W, 2, 2, "cpu")
    e = torch.tensor([[0.1, -0.2], [0.3, 0.05], [-0.1, 0.4], [0.2, 0.2]], dtype=torch.float64)
    users, pos, neg = torch.tensor([0, 1]), torch.tensor([2, 3]), torch.tensor([3, 2])
    a = torch.tensor(dense_adjacency())

    def hand(x, keep=2):
        o = (x + a @ x) / 2
        u, p, n = users[:keep], pos[:keep], neg[:keep]
        sc = (o[u] * o[p]).sum(1) - (o[u] * o[n]).sum(1)
        q = x[u].pow(2).sum() + x[p].pow(2).sum() + x[n].pow(2).sum()
        return float(-torch.log(torch.sigmoid(sc)).mean() + 0.01 * 0.5 * q / keep)

    leaf = e.float().requires_grad_()
    loss = ref.bpr_loss(adj, leaf, 1, users, pos, neg, decay=0.01)
    assert float(loss) == pytest.approx(hand(e), rel=1e-6)
    (g,) = torch.autograd.grad(loss, [leaf])
    fd = torch.zeros_like(e)
    for k in range(4):
        for j in range(2):
            d = torch.zeros_like(e)
            d[k, j] = 1e-6
            fd[k, j] = (hand(e + d) - hand(e - d)) / 2e-6
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-4, atol=1e-7)
    # keep=1: the first triple alone, the mean over it.
    one = ref.bpr_loss(adj, e.float(), 1, users, pos, neg, 0.01, keep=1)
    assert float(one) == pytest.approx(hand(e, keep=1), rel=1e-6)


def test_adam_by_hand():
    p = torch.tensor([1.0, -2.0], dtype=torch.float64)
    opt = ref.Adam(0.1)
    g = torch.tensor([0.5, 1e-9], dtype=torch.float64)
    opt.step(p, g)
    # Step 1: m̂ = g, v̂ = g², so the update is lr · g / (|g| + eps).
    np.testing.assert_allclose(p.numpy(), [1.0 - 0.1 * 0.5 / (0.5 + 1e-8), -2.0 - 0.1 * 1e-9 / (1e-9 + 1e-8)])
    opt.step(p, g)
    m = 0.9 * 0.1 * g + 0.1 * g
    v = 0.999 * 0.001 * g * g + 0.001 * g * g
    upd = (m / (1 - 0.81)) / ((v / (1 - 0.999**2)).sqrt() + 1e-8)
    np.testing.assert_allclose(p.numpy(), [1.0 - 0.1 * 0.5 / (0.5 + 1e-8) - 0.1 * float(upd[0]),
                                           -2.0 - 0.1 * 1e-9 / (1e-9 + 1e-8) - 0.1 * float(upd[1])])


def test_follow_steps_records_what_is_compared():
    adj = ref.Adjacency(U, I, W, 2, 2, "cpu")
    e = torch.full((4, 2), 0.1)
    b = (torch.tensor([0]), torch.tensor([2]), torch.tensor([3]))
    r = ref.follow_steps(adj, e, 2, [b, b], lr=0.01, decay=0.0)
    assert len(r["losses"]) == 2 and all(0 < x < 1 for x in r["losses"])
    assert r["grad_norm"] > 0 and r["change_norm"] > 0


def test_precisions():
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, 3.0])
    np.testing.assert_array_equal(round_tf32(x).numpy(), [1.0, 1.0 + 2**-10, 3.0])
    y = torch.tensor([448.0, 1.0, 0.3])
    assert float(FP8.weights(y)[0]) == 448.0 and float(FP8.weights(y)[2]) != pytest.approx(0.3, rel=1e-3)
    np.testing.assert_array_equal(TF32.gradients(x).numpy(), round_tf32(x).numpy())


def test_gaps():
    assert judge.norm_gap(1.1, 1.0) == pytest.approx(0.1)
    assert judge.norm_gap(0.0, 0.0) == 0.0
    ref_e = torch.ones(4, 2)
    emb = ref_e.clone()
    emb[3] += torch.tensor([0.3, 0.4])
    assert judge.row_gap(emb, ref_e, block=3) == pytest.approx(0.5 / math.sqrt(2), rel=1e-6)


def test_score_gap_and_bad_rows():
    # One user (node 0) against items with scores 4, 3, 2, 1, 0 (item 0 bought).
    final = torch.tensor([[1.0], [4.0], [3.0], [2.0], [1.0], [0.0]])
    n_users = 1
    purchases = (np.array([0, 1]), np.array([0]))
    scores = np.array([3.0, 2.0, 1.0, 0.0])  # allowed items 1..4
    sigma = scores.std()
    users = np.array([0, 0, 0, 0])
    served = np.array([[1, 2], [1, 3], [0, 1], [1, 1]])
    gap, bad = judge.score_gap(final, n_users, users, served, purchases, k=2)
    assert bad == 2  # a bought item; a repeated item
    assert gap == pytest.approx((2.0 - 1.0) / sigma, rel=1e-6)


def test_bad_triples():
    purchases = (np.array([0, 2, 2, 3]), np.array([0, 1, 1]))  # user 0: items 0, 1; user 1: none; user 2: 1
    n_users, n_items = 3, 3
    users = np.array([0, 0, 1, 2, 0])
    pos = np.array([3, 4, 3, 4, 5])    # node ids: items 0, 1, 0, 1, 2
    neg = np.array([5, 3, 4, 5, 5])
    # ok; negative bought; user without purchases; ok; positive not bought.
    assert judge.bad_triples(users, pos, neg, purchases, n_users, n_items) == 3


def test_sampler_z_by_hand():
    # User 0 bought items 0 and 1, user 1 item 1, user 2 nothing; node ids
    # put items at 3 + local. Purchase counts: items 1, 2, 0; users 2, 1.
    purchases = (np.array([0, 2, 3, 3]), np.array([0, 1, 1]))
    node = lambda items: [3 + x for x in items]
    # The four triples in BPR's proportions: every mean is its expectation.
    exact = judge.sampler_z([0, 0, 1, 1], node([0, 1, 1, 1]), node([2, 2, 0, 2]), purchases, 3, 3)
    assert exact == pytest.approx(0.0, abs=1e-9)
    # User 0, item 0, item 2 twice: the user's mean lies one standard
    # deviation off (z = sqrt 2), the positive's (ln 2 where ln 2 once in four,
    # ln 3 three times) sqrt 3 of them (z = sqrt 6), the negative's 1/sqrt 3.
    lopsided = judge.sampler_z([0, 0], node([0, 0]), node([2, 2]), purchases, 3, 3)
    assert lopsided == pytest.approx(math.sqrt(6), rel=1e-9)
