"""DGCF in the port (``models/dgcf.py``, ``ops/routing.py`` and the driver's
``model="dgcf"``) against the plain reference ``tests/dgcf_reference.py``, on
the CPU at a small seeded size: 400 users, 60 items, about 2,800 edges
(5,670 arcs), d 16, K 4 intents, T 2 iterations, L 1 layer, f32 rows (the
kernel's plain version).

Tolerances: both sides compute in f32 and differ only in the order of their
sums (the degrees and each row's messages summed by ``segment_reduce`` in
the port, by ``index_add`` in the reference; the layer mean), so values
agree to a few f32 ulps of their scale: ``ATOL`` on values of scale 0.1–1,
``RTOL`` on losses, ``GRAD_RTOL`` of the gradient's largest element (its
sums run over a few hundred arcs through the softmax and both
normalizations). Each planted fault moves what it breaks by at least a
hundred times its bound here (``test_planted_faults_fail``).
"""
import pathlib

import numpy as np
import pytest
import torch

import dgcf_reference as R
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models import dgcf
from gnn_ecommerce_tpu_torch.ops import routing
from gnn_ecommerce_tpu_torch.serve.service import RecommenderService
from gnn_ecommerce_tpu_torch.train import checkpoint as tckpt
from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns
from torch_port_case import normal, small_arcs

torch.set_num_threads(1)

DATA = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "prepared")
D, K, T, L = 16, 4, 2, 1
DECAY, LR, COR_WEIGHT, COR_BATCH = 1e-4, 1e-3, 0.01, 24
# f32 values of scale 0.1-1 summed over up to a few hundred arcs: ~1e-7 apart.
ATOL = 2e-6
RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs()
    rg = routing.build_routing_graph(build_graph(u, i, w, n_u, n_i, device="cpu"))
    arcs = R.Arcs(u, i, n_u, n_i)
    table = torch.from_numpy(normal(5, (n_u + n_i, D)) * 0.1)
    # The port's arcs in the reference's (head, tail) order.
    to_ref = torch.argsort(rg.head.long() * rg.n_nodes + rg.src.long())
    return rg, arcs, table, to_ref


def batch(n_u, n_i, seed=7, b=32):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a) for a in (rng.integers(0, n_u, b), rng.integers(0, n_i, b) + n_u,
                                               rng.integers(0, n_i, b) + n_u))


def tiny_graph():
    """Users 0, 1 and items 2, 3 (node ids): edges u0-i2, u0-i3, u1-i2."""
    g = build_graph(np.array([0, 0, 1]), np.array([0, 1, 0]), np.ones(3, np.float32), 2, 2, device="cpu")
    return routing.build_routing_graph(g)


# ---------------------------------------------------------------------------
# The routing operations
# ---------------------------------------------------------------------------


def test_routing_graph_arcs_and_reverse():
    rg = tiny_graph()
    head, src = rg.head.long(), rg.src.long()
    assert torch.equal(rg.indptr, torch.tensor([0, 2, 3, 5, 6]))
    assert sorted(zip(head.tolist(), src.tolist())) == [(0, 2), (0, 3), (1, 2), (2, 0), (2, 1), (3, 0)]
    assert torch.equal(head[rg.rev], src) and torch.equal(src[rg.rev], head)
    assert torch.equal(rg.rev[rg.rev], torch.arange(rg.n_arcs))


def test_intent_spmm_and_sddmm_by_hand():
    """K 2 intents of 1 column: out[h, k] = Σ w[a, k]·x[t, k]; score[a, k] =
    p[h, k]·q[t, k]."""
    rg = tiny_graph()
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    w = torch.arange(1.0, 13.0).view(6, 2)
    head, src = rg.head.tolist(), rg.src.tolist()
    want = torch.zeros(4, 2)
    for a in range(6):
        want[head[a]] += w[a] * x[src[a]]
    torch.testing.assert_close(routing.intent_spmm(w, x, rg), want, rtol=0, atol=0)
    q = x.flip(0)
    score = routing.intent_sddmm(x, q, rg, 2)
    torch.testing.assert_close(score, torch.stack([x[head[a]] * q[src[a]] for a in range(6)]), rtol=0, atol=0)
    # Chunks of 2 columns: the dot product within each chunk.
    x4 = torch.arange(16.0).view(4, 4)
    got = routing.intent_sddmm(x4, x4, rg, 2)
    a = 0
    assert got[a, 0] == x4[head[a], :2] @ x4[src[a], :2] and got[a, 1] == x4[head[a], 2:] @ x4[src[a], 2:]


def test_intent_ops_gradcheck_f64(case):
    rg = tiny_graph()
    gen = torch.Generator().manual_seed(3)
    w = torch.rand(rg.n_arcs, 2, generator=gen, dtype=torch.float64, requires_grad=True)
    x = torch.randn(4, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    q = torch.randn(4, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda w_, x_: routing.intent_spmm(w_, x_, rg), (w, x))
    assert torch.autograd.gradcheck(lambda p_, q_: routing.intent_sddmm(p_, q_, rg, 2), (x, q))
    # And on the small graph, K 4 of 4 columns.
    rg = case[0]
    w = torch.rand(rg.n_arcs, 4, generator=gen, dtype=torch.float64, requires_grad=True)
    x = torch.randn(rg.n_nodes, 16, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda w_, x_: routing.intent_spmm(w_, x_, rg), (w, x), fast_mode=True)
    assert torch.autograd.gradcheck(lambda p_, q_: routing.intent_sddmm(p_, q_, rg, 4), (x, x.detach().clone()
                                                                                         .requires_grad_()),
                                    fast_mode=True)


def test_first_iteration_is_lightgcn_per_chunk(case):
    """From A = 1 every arc's S is 1/K, every intent's degree a node's arc
    count over K, and each chunk of f is LightGCN's unweighted propagation
    D^-½ A D^-½ x of that chunk."""
    rg, arcs, table, _ = case
    f, s, _ = dgcf.routing_iteration(table, torch.ones(rg.n_arcs, K), rg, K, None, score=False)
    torch.testing.assert_close(s, torch.full_like(s, 1 / K))
    n = rg.n_nodes
    adj = torch.zeros(n, n).index_put_((rg.head.long(), rg.src.long()), torch.ones(rg.n_arcs))
    deg = adj.sum(1)
    dinv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    want = (dinv[:, None] * adj * dinv[None, :]) @ table
    np.testing.assert_allclose(f.numpy(), want.numpy(), atol=ATOL)


def test_intent_plan_covers_every_arc_once():
    """Items cover every arc once; rows longer than the split are cut into
    full segments (the last shorter), listed first, their partial rows
    consecutive; the whole rows follow, longest first."""
    lens = np.array([0, 3, 17, 4, 9, 0, 1, 40, 8])
    indptr = np.concatenate([[0], np.cumsum(lens)])
    plan = routing.build_intent_plan(indptr, torch.zeros(int(indptr[-1]), dtype=torch.int32), split=8)
    arc0, n, dest = plan.item_arc.numpy(), plan.item_n.numpy(), plan.item_dest.numpy()
    covered = np.zeros(indptr[-1], int)
    for a, m in zip(arc0, n):
        covered[a:a + m] += 1
    assert (covered == 1).all()
    assert plan.n_split_rows == 3 and plan.comb_row.tolist() == [2, 4, 7]
    assert plan.comb_ptr.tolist() == [0, 3, 5, 10] and plan.n_partial == 10
    segs = dest < 0
    assert segs[:10].all() and not segs[10:].any()
    assert (-dest[:10] - 1).tolist() == list(range(10)) and (n[:10] <= 8).all()
    assert sorted(dest[10:].tolist()) == [0, 1, 3, 5, 6, 8]
    assert (np.diff(n[10:]) <= 0).all()


def test_intent_spmm_split_rows_emulated(case):
    """The kernel's order, emulated: each item's arcs summed in arc order,
    each split row's partials added in blocked slice order; within the f32
    summation bound of the plain version's sums."""
    rg, _, table, _ = case
    plan = routing.build_intent_plan(rg.indptr.numpy(), rg.src, split=16)
    w = torch.rand(rg.n_arcs, K, generator=torch.Generator().manual_seed(2))
    x = table.numpy()
    msgs = x[rg.src.numpy()].reshape(-1, K, D // K) * w.numpy()[:, :, None]
    out = np.zeros((rg.n_nodes, D), np.float32)
    partial = np.zeros((plan.n_partial, D), np.float32)
    for a, m, dst in zip(plan.item_arc.numpy(), plan.item_n.numpy(), plan.item_dest.numpy()):
        acc = np.zeros(D, np.float32)
        for arc in range(a, a + m):
            acc = acc + msgs[arc].reshape(-1)
        if dst >= 0:
            out[dst] = acc
        else:
            partial[-dst - 1] = acc
    slices = 256 // (D // 4)
    for r, lo, hi in zip(plan.comb_row.numpy(), plan.comb_ptr.numpy()[:-1], plan.comb_ptr.numpy()[1:]):
        per = -(-(hi - lo) // slices)
        tot = np.zeros(D, np.float32)
        for s in range(slices):
            part = np.zeros(D, np.float32)
            for p in range(lo + min(hi - lo, s * per), lo + min(hi - lo, (s + 1) * per)):
                part = part + partial[p]
            tot = tot + part
        out[r] = tot
    assert plan.n_split_rows > 0
    plain = routing.intent_spmm(w, table, rg).numpy()
    mag = routing.intent_spmm(w, table.abs(), rg).numpy()
    lens = np.diff(rg.indptr.numpy())[:, None]
    assert (np.abs(out - plain) <= 2 * (lens + 2) * 2.0**-24 * mag).all()


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_reference(case):
    rg, arcs, table, to_ref = case
    final, s = dgcf.dgcf_forward(table, rg, K, T, L)
    want, want_s = R.forward(arcs, table, K, T, L)
    np.testing.assert_allclose(final.numpy(), want.numpy(), atol=ATOL)
    np.testing.assert_allclose(s[to_ref].numpy(), want_s.numpy(), atol=ATOL)
    # Two layers of three iterations: A carries across layers.
    final, s = dgcf.dgcf_forward(table, rg, K, 3, 2)
    want, want_s = R.forward(arcs, table, K, 3, 2)
    np.testing.assert_allclose(final.numpy(), want.numpy(), atol=ATOL)
    np.testing.assert_allclose(s[to_ref].numpy(), want_s.numpy(), atol=10 * ATOL)


def test_bf16_rows_stay_near_f32(case):
    """bf16 gathered rows: f within bf16's 2^-8 relative rounding of each
    row's values, far from the f32 forward's agreement with the reference."""
    rg, arcs, table, _ = case
    f32, _ = dgcf.dgcf_forward(table, rg, K, T, L)
    bf16, _ = dgcf.dgcf_forward(table, rg, K, T, L, torch.bfloat16)
    gap = float((bf16 - f32).norm() / f32.norm())
    assert 1e-5 < gap < 2**-8


def test_cor_loss_by_hand_and_against_reference():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(40, 8, generator=gen)
    # A chunk against an affine image of itself: correlation 1.
    torch.testing.assert_close(dgcf.distance_correlation(x[:, :4], 2 * x[:, :4] + 1), torch.tensor(1.0),
                               atol=1e-4, rtol=0)
    got = dgcf.cor_loss(x, 4)
    parts = x.split(2, dim=1)
    want = sum(R.dcor(parts[k], parts[k + 1]) for k in range(3)) / 10
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    assert 0 < float(got) < 0.3  # independent normal chunks: far from 1


def test_cor_rows_are_distinct_and_replayable():
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    ids = dgcf.cor_rows(50, 20, 12, gen)
    assert len(set(ids[:12].tolist())) == 12 and ids[:12].max() < 50
    assert len(set(ids[12:].tolist())) == 12 and ids[12:].min() >= 50 and ids[12:].max() < 70
    again = torch.Generator()
    again.set_state(state)
    torch.testing.assert_close(dgcf.cor_rows(50, 20, 12, again), ids)
    assert dgcf.authors_cor_batch(1_639_358, 54_571, 10_106_621, 2000) == 324


def _port_step(case, users, pos, neg, seed):
    rg, _, table, _ = case
    gen = torch.Generator().manual_seed(seed)
    loss_fn = dgcf.make_dgcf_loss_fn(K, T, L, DECAY, COR_WEIGHT, COR_BATCH, gen)
    leaf = table.clone().requires_grad_()
    loss, (bpr, reg, dropped) = loss_fn({"embedding": leaf}, rg, users, pos, neg)
    (grad,) = torch.autograd.grad(loss, [leaf])
    with torch.no_grad():
        _, routed = dgcf.dgcf_forward(table, rg, K, T, L)
    return loss, bpr, reg, dropped, grad, routed


def test_loss_and_first_gradient_match_reference(case):
    rg, arcs, table, to_ref = case
    users, pos, neg = batch(rg.n_users, rg.n_items)
    loss, bpr, reg, dropped, grad, routed = _port_step(case, users, pos, neg, 21)
    leaf = table.clone().requires_grad_()
    r_loss, r_bpr, r_reg, r_cor, r_s = R.dgcf_loss(arcs, leaf, K, T, L, users, pos, neg, DECAY, COR_WEIGHT,
                                                   COR_BATCH, torch.Generator().manual_seed(21))
    (r_grad,) = torch.autograd.grad(r_loss, [leaf])
    assert int(dropped) == 0
    for got, want in ((loss, r_loss), (bpr, r_bpr), (reg, r_reg)):
        np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=RTOL)
    # The cor term is the loss less BPR and the L2: the loss's rounding.
    np.testing.assert_allclose(float((loss - bpr - reg).detach()), float(r_cor), atol=RTOL * float(r_loss))
    np.testing.assert_allclose(grad.numpy(), r_grad.numpy(), atol=GRAD_RTOL * float(r_grad.abs().max()))
    np.testing.assert_allclose(routed[to_ref].numpy(), r_s.detach().numpy(), atol=ATOL)


FAULTS = {
    "one_iteration": dict(T=1),
    "softmax_over_arcs": dict(softmax_over="arcs"),
    "no_tanh": dict(tanh=False),
    "unrouted_degrees": dict(unrouted_degrees=True),
    "no_cor": dict(cor_weight=0.0),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail(case, fault):
    """Each planted fault, in the reference's place, fails the comparison the
    port passes: the last S, the cor term or the gradient moves by at least
    a hundred times its bound."""
    rg, arcs, table, to_ref = case
    users, pos, neg = batch(rg.n_users, rg.n_items)
    loss, bpr, reg, _, grad, routed = _port_step(case, users, pos, neg, 21)
    kw = dict(FAULTS[fault])
    t = kw.pop("T", T)
    cw = kw.pop("cor_weight", COR_WEIGHT)
    leaf = table.clone().requires_grad_()
    f_loss, _, _, f_cor, f_s = R.dgcf_loss(arcs, leaf, K, t, L, users, pos, neg, DECAY, cw, COR_BATCH,
                                           torch.Generator().manual_seed(21), **kw)
    (f_grad,) = torch.autograd.grad(f_loss, [leaf])
    s_gap = float((routed[to_ref] - f_s.detach()).abs().max()) / ATOL
    cor_gap = abs(float((loss - bpr - reg).detach()) - float(f_cor)) / (RTOL * float(loss.detach()))
    grad_gap = float((grad - f_grad).abs().max()) / (GRAD_RTOL * float(f_grad.abs().max()))
    assert max(s_gap, cor_gap, grad_gap) > 100, (s_gap, cor_gap, grad_gap)


def test_one_adam_step_through_make_train_fns(case):
    rg, arcs, table, _ = case
    users, pos, neg = batch(rg.n_users, rg.n_items)
    gen = torch.Generator().manual_seed(31)
    state = gen.get_state()
    loss_fn = dgcf.make_dgcf_loss_fn(K, T, L, DECAY, COR_WEIGHT, COR_BATCH, gen)
    optimizer = Adam(LR)
    train_step, _ = make_train_fns(None, optimizer, len(users), DECAY, loss_fn=loss_fn)
    params = {"embedding": table.clone()}
    opt_state = optimizer.init(params)
    params, opt_state, m = train_step.on_batch(params, opt_state, rg, users, pos, neg)
    ref = R.follow_steps(arcs, table, K, T, L, [(users, pos, neg)], [state], LR, DECAY, COR_WEIGHT, COR_BATCH)
    np.testing.assert_allclose(float(m["loss"]), ref["losses"][0], rtol=RTOL)
    np.testing.assert_allclose(m["loss"] - m["bpr_loss"] - m["reg_loss"], ref["cor"][0], atol=RTOL * m["loss"])
    # Adam's first step moves each element by lr·g / (|g| + 1e-8): about
    # lr·sign(g), but for gradients near 1e-8 a change of 1e-9 in g moves
    # it by a tenth of lr. Those (nodes that only the routing and cor touch)
    # are held to Adam's bound alone.
    firm = ref["grad"].abs() > 1e-6
    np.testing.assert_allclose(params["embedding"][firm].numpy(), ref["table"][firm].numpy(), atol=1e-3 * LR)
    assert float((params["embedding"] - table).abs().max()) <= LR * (1 + 1e-5)
    assert float((params["embedding"] - table).abs().max()) > 0.5 * LR


# ---------------------------------------------------------------------------
# The driver, the CLI, the service
# ---------------------------------------------------------------------------


def test_driver_trains_dgcf_and_service_refuses_its_checkpoint(tmp_path):
    prepared = load_prepared(DATA)
    base = dict(latent_dim=D, n_layers=L, epochs=1, batch_size=256, batches_per_epoch=2,
                checkpoint_dir=str(tmp_path), model="dgcf", async_saves=False)
    with pytest.raises(ValueError, match="dgcf"):
        train(prepared, TrainConfig(**base), verbose=False, device="cpu")
    result = train(prepared, TrainConfig(**base, fast_bipartite="bf16"), verbose=False, device="cpu")
    (rec,) = result.history
    assert np.isfinite(rec["cor_loss"]) and rec["cor_loss"] > 0 and np.isfinite(rec["val_recall"])
    _, meta = tckpt.load_checkpoint(str(tmp_path), tckpt.LAST_NAME)
    hp = meta["hyperparams"]
    assert (hp["model"], hp["n_factors"], hp["n_iterations"], hp["cor_weight"]) == ("dgcf", 4, 2, 0.01)
    with pytest.raises(ValueError, match="DGCF checkpoint"):
        RecommenderService.from_artifacts(DATA, str(tmp_path), tckpt.LAST_NAME, device="cpu")


def test_train_cli_trains_dgcf(tmp_path, monkeypatch):
    from gnn_ecommerce_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(tmp_path)
    train_cli.main(["--synthetic", "--synthetic-users", "150", "--synthetic-items", "40",
                    "--synthetic-events", "3000", "-e", "1", "--dim", "8", "--layers", "1",
                    "--fast", "f32", "--model", "dgcf", "--dgcf-factors", "2", "--dgcf-iterations", "3",
                    "--cor-weight", "0.05", "--device", "cpu"])
    _, meta = tckpt.load_checkpoint("model-checkpoints", tckpt.LAST_NAME)
    hp = meta["hyperparams"]
    assert (hp["model"], hp["n_factors"], hp["n_iterations"], hp["cor_weight"]) == ("dgcf", 2, 3, 0.05)
