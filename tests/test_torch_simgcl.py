"""SimGCL in the port (``models/simgcl.py`` and the driver's ``model="simgcl"``)
against the plain reference ``tests/simgcl_reference.py``, on the CPU at a
small seeded size: 400 users, 60 items, about 3,000 weighted edges, d 8, L 3,
the f32 fast plans.

Tolerances: both sides compute in f32 and differ only in the order of their
sums (the plans' segment sums and the head's GEMM against a sparse product),
so values agree to a few f32 ulps of their scale; each bound below is about
a hundred times that. A sign that rounding could flip would move a noise
element by 2ε/√d, far outside every bound; none is near zero at these seeds.
"""
import pathlib

import numpy as np
import pytest
import torch

import simgcl_reference as R
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models import simgcl
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops.bipartite import build_fast_bipartite, fast_get_embedding
from gnn_ecommerce_tpu_torch.serve.service import RecommenderService
from gnn_ecommerce_tpu_torch.train import checkpoint as tckpt
from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns
from torch_port_case import normal, small_arcs

torch.set_num_threads(1)

DATA = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "prepared")
D, L = 8, 3
EPS, TEMP, CL_WEIGHT, DECAY, LR = 0.1, 0.2, 0.5, 1e-4, 1e-3
# f32 values of scale ~0.1 summed over a few dozen arcs: ~1e-8 apart.
ATOL = 1e-6


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs()
    graph = build_graph(u, i, w, n_u, n_i, device="cpu")
    fbs = {heavy: build_fast_bipartite(graph, fast_ops=True, heavy_users=heavy, device="cpu") for heavy in (0, 50)}
    adj = R.Adjacency(u, i, w, n_u, n_i)
    table = torch.from_numpy(normal(5, (n_u + n_i, D)) * 0.1)
    return fbs, adj, table, n_u, n_i


def batch(n_u, n_i):
    """A batch of 16 triples with planted duplicate users and positives."""
    rng = np.random.default_rng(7)
    users = rng.integers(0, n_u, 16)
    users[[3, 9, 12]] = users[0]
    pos = rng.integers(0, n_i, 16) + n_u
    pos[[5, 6]] = pos[1]
    neg = rng.integers(0, n_i, 16) + n_u
    return tuple(torch.as_tensor(a) for a in (users, pos, neg))


def generator(seed):
    return torch.Generator().manual_seed(seed)


def replay(gen_state):
    g = torch.Generator()
    g.set_state(gen_state)
    return g


@pytest.mark.parametrize("heavy", [0, 50])
def test_perturbed_view_given_the_same_generator_state(case, heavy):
    fbs, adj, table, n_u, n_i = case
    g = generator(11)
    state = g.get_state()
    ids_u, ids_i = torch.tensor([0, 7, 7, 399, 123]), torch.tensor([59, 0, 31, 31])
    rows_u, rows_i = simgcl.perturbed_view(table, fbs[heavy], L, EPS, g, ids_u, ids_i)
    g_ref = replay(state)
    ref = R.perturbed_embedding(adj, table, L, EPS, g_ref)
    np.testing.assert_allclose(rows_u.numpy(), ref[ids_u].numpy(), atol=ATOL)
    np.testing.assert_allclose(rows_i.numpy(), ref[n_u + ids_i].numpy(), atol=ATOL)
    # Both drew L tables of [N, D], so their generators agree afterwards.
    assert torch.equal(g.get_state(), g_ref.get_state())


def test_noise_rows_have_length_eps_and_follow_the_sign():
    x = torch.tensor([[1.0, -2.0, 0.0, 3.0], [-1.0, -1.0, 2.0, 0.5]])
    noise = simgcl.noise_draw(2, 4, generator(3), EPS, "cpu")
    np.testing.assert_allclose(noise.norm(dim=1).numpy(), [EPS, EPS], rtol=1e-6)
    out = simgcl.noise_add(x, noise)
    np.testing.assert_array_equal((out - x).sign().numpy(), x.sign().numpy())


@pytest.mark.parametrize("ids", [
    [4, 1, 9, 2, 0, 7],  # no duplicates
    [5, 3, 5, 9, 3, 3, 1, 8],  # planted duplicates
    [6, 6, 6, 6, 2],  # one id four times
])
def test_info_nce_over_unique_rows(ids):
    v1 = torch.from_numpy(normal(1, (10, D))).requires_grad_()
    v2 = torch.from_numpy(normal(2, (10, D))).requires_grad_()
    ids = torch.tensor(ids)
    s, first = simgcl.first_of_runs(ids)
    got = simgcl.info_nce_unique(v1[s], v2[s], first, TEMP)
    uniq = torch.unique(ids)
    assert torch.equal(s[first], uniq)
    want = R.info_nce(v1[uniq], v2[uniq], TEMP)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-6)
    for a, b in zip(torch.autograd.grad(got, [v1, v2]), torch.autograd.grad(want, [v1, v2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("heavy", [0, 50])
def test_joint_loss_and_its_gradient(case, heavy):
    fbs, adj, table, n_u, n_i = case
    users, pos, neg = batch(n_u, n_i)
    cfg = LightGCNConfig(table.shape[0], D, L, alpha=simgcl.simgcl_alphas(L))
    g = generator(21)
    state = g.get_state()
    loss_fn = simgcl.make_simgcl_loss_fn(cfg, DECAY, CL_WEIGHT, EPS, TEMP, 4096, g)
    leaf = table.clone().requires_grad_()
    loss, (bpr, reg, dropped) = loss_fn({"embedding": leaf}, fbs[heavy], users, pos, neg)
    (grad,) = torch.autograd.grad(loss, [leaf])
    ref_leaf = table.clone().requires_grad_()
    r_loss, r_bpr, r_reg, r_cl = R.simgcl_loss(adj, ref_leaf, L, users, pos, neg, DECAY, CL_WEIGHT, EPS, TEMP,
                                               replay(state))
    (r_grad,) = torch.autograd.grad(r_loss, [ref_leaf], retain_graph=True)
    assert int(dropped) == 0
    for got, want in ((loss, r_loss), (bpr, r_bpr), (reg, r_reg), (loss - bpr - reg, r_cl)):
        np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-5)
    scale = float(r_grad.abs().max())
    np.testing.assert_allclose(grad.numpy(), r_grad.numpy(), atol=1e-5 * scale)
    # The contrastive term is most of the gradient here: without it the
    # gradient is another one.
    assert float((grad - torch.autograd.grad(r_bpr + r_reg, [ref_leaf])[0]).norm()) > 0.5 * float(grad.norm())


def test_clean_view_leaves_layer_zero_out(case):
    fbs, adj, table, n_u, n_i = case
    assert simgcl.simgcl_alphas(3) == (0.0, 1 / 3, 1 / 3, 1 / 3)
    cfg = LightGCNConfig(table.shape[0], D, L, alpha=simgcl.simgcl_alphas(L))
    got = fast_get_embedding({"embedding": table}, fbs[50], L, alpha=cfg.alphas())
    want = R.clean_embedding(adj, table, L)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    uniform = fast_get_embedding({"embedding": table}, fbs[50], L)
    assert float((uniform - want).abs().max()) > 100 * ATOL


def test_one_adam_step(case):
    fbs, adj, table, n_u, n_i = case
    users, pos, neg = batch(n_u, n_i)
    cfg = LightGCNConfig(table.shape[0], D, L, alpha=simgcl.simgcl_alphas(L))
    g = generator(31)
    state = g.get_state()
    loss_fn = simgcl.make_simgcl_loss_fn(cfg, DECAY, CL_WEIGHT, EPS, TEMP, 4096, g)
    optimizer = Adam(LR)
    train_step, _ = make_train_fns(cfg, optimizer, 16, DECAY, loss_fn=loss_fn)
    params = {"embedding": table.clone()}
    opt_state = optimizer.init(params)
    params, opt_state, m = train_step.on_batch(params, opt_state, fbs[0], users, pos, neg)
    ref = R.follow_steps(adj, table, L, [(users, pos, neg)], [state], LR, DECAY, CL_WEIGHT, EPS, TEMP)
    np.testing.assert_allclose(float(m["loss"]), ref["losses"][0], rtol=1e-5)
    # Adam's first step moves each element by about lr·sign(g).
    np.testing.assert_allclose(params["embedding"].numpy(), ref["table"].numpy(), atol=1e-3 * LR)
    assert float((params["embedding"] - table).abs().max()) > 0.5 * LR


def test_driver_checkpoint_is_served_with_the_clean_view(tmp_path):
    prepared = load_prepared(DATA)
    base = dict(latent_dim=D, n_layers=L, epochs=1, batch_size=256, batches_per_epoch=2,
                checkpoint_dir=str(tmp_path), model="simgcl", async_saves=False)
    with pytest.raises(ValueError, match="simgcl"):
        train(prepared, TrainConfig(**base), verbose=False, device="cpu")
    result = train(prepared, TrainConfig(**base, fast_bipartite="f32"), verbose=False, device="cpu")
    (rec,) = result.history
    assert np.isfinite(rec["cl_loss"]) and rec["cl_loss"] > 0
    leaves, meta = tckpt.load_checkpoint(str(tmp_path), tckpt.LAST_NAME)
    hp = meta["hyperparams"]
    assert hp["model"] == "simgcl" and hp["layer_weights"] == [0.0, 1 / 3, 1 / 3, 1 / 3]
    n_u = prepared.n_users
    cfg = tckpt.model_config(meta, n_u + prepared.n_items)
    np.testing.assert_array_equal(cfg.alphas().numpy(), np.float32([0, 1 / 3, 1 / 3, 1 / 3]))
    svc = RecommenderService.from_artifacts(DATA, str(tmp_path), tckpt.LAST_NAME, device="cpu")
    emb = torch.from_numpy(tckpt.find_leaf(leaves, meta, "embedding"))
    svc.refresh({"embedding": emb})
    adj = R.Adjacency(prepared.edge_user, prepared.edge_item_node - n_u, prepared.edge_weight, n_u,
                      prepared.n_items)
    want = R.clean_embedding(adj, emb, L)
    np.testing.assert_allclose(svc.final_emb.numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()))


def test_train_cli_trains_simgcl(tmp_path, monkeypatch):
    from gnn_ecommerce_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(tmp_path)
    train_cli.main(["--synthetic", "--synthetic-users", "150", "--synthetic-items", "40",
                    "--synthetic-events", "3000", "-e", "1", "--dim", str(D), "--layers", str(L),
                    "--fast", "f32", "--model", "simgcl", "--device", "cpu"])
    _, meta = tckpt.load_checkpoint("model-checkpoints", tckpt.LAST_NAME)
    assert meta["hyperparams"]["model"] == "simgcl"
    assert meta["hyperparams"]["cl_weight"] == CL_WEIGHT
