"""The port's training step against the JAX package on the same numpy
inputs (CPU): losses, the sampler's rank→item map and its distribution, the
autograd pair of the fast sparse products, layered and fast-batched
gradients against ``jax.grad``, Adam against ``optax.adam``, and parameters
after a few steps on both paths."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import get_embedding as jax_get_embedding
from gnn_ecommerce_tpu.models import losses as jlosses
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.sampling.bpr import _rank_to_allowed_item as jax_rank_to_item
from gnn_ecommerce_tpu_torch.data.prepare import SamplerArrays
from gnn_ecommerce_tpu_torch.models import losses as tlosses
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.sampling import bpr as tbpr
from gnn_ecommerce_tpu_torch.train import step as tstep
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

DIM, LAYERS, BATCH, DECAY, LR = 12, 3, 64, 1e-4, 0.005


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- losses


def test_losses_match_jax():
    pos, neg = normal(0, (50,)), normal(1, (50,))
    emb = normal(2, (30, 7))
    ids = np.random.default_rng(3).integers(0, 30, (3, 50))  # with repeats
    np.testing.assert_allclose(
        float(tlosses.bpr_loss(_t(pos), _t(neg))),
        float(jlosses.bpr_loss(jnp.asarray(pos), jnp.asarray(neg))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(tlosses.bpr_loss_reference(_t(pos), _t(neg), _t(emb), 0.3)),
        float(jlosses.bpr_loss_reference(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(emb), 0.3)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(tlosses.reg_loss(_t(emb), *(_t(i) for i in ids), 1e-2)),
        float(jlosses.reg_loss(jnp.asarray(emb), *(jnp.asarray(i) for i in ids), 1e-2)),
        rtol=1e-6,
    )
    label = (normal(4, (50,)) > 0).astype(np.int32)
    np.testing.assert_allclose(
        float(tlosses.link_pred_loss(_t(pos), _t(label))),
        float(jlosses.link_pred_loss(jnp.asarray(pos), jnp.asarray(label))), rtol=1e-6,
    )


def test_reg_loss_counts_duplicate_ids_every_time():
    emb = torch.ones(4, 2)
    once = tlosses.reg_loss(emb, torch.tensor([0]), torch.tensor([1]), torch.tensor([2]), 1.0)
    twice = tlosses.reg_loss(emb, torch.tensor([0, 0]), torch.tensor([1, 1]), torch.tensor([2, 2]), 1.0)
    assert float(once) == float(twice) == 3.0


# ---------------------------------------------------------------- sampler


def _ignore_rows(n_users, n_items, seed=5):
    """Sorted node-space ignore rows; row 0 covers all items but one."""
    rng = np.random.default_rng(seed)
    rows = [np.delete(np.arange(n_items), 17)]
    rows += [np.sort(rng.choice(n_items, rng.integers(0, n_items // 2), replace=False)) for _ in range(40)]
    rows.append(np.empty(0, np.int64))
    indptr = np.append(0, np.cumsum([len(r) for r in rows]))
    return indptr, np.concatenate(rows).astype(np.int64) + n_users


def test_rank_to_allowed_item_matches_jax_and_brute_force():
    n_users, n_items = 100, 60
    indptr, flat = _ignore_rows(n_users, n_items)
    rng = np.random.default_rng(6)
    rows = rng.integers(0, len(indptr) - 1, 2000)
    lo, hi = indptr[rows], indptr[rows + 1]
    rank = (rng.random(2000) * (n_items - (hi - lo))).astype(np.int64)
    out = tbpr._rank_to_allowed_item(_t(flat), _t(lo), _t(hi), _t(rank), n_users).numpy()
    ref = np.asarray(jax_rank_to_item(
        jnp.asarray(flat, jnp.int32), jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32),
        jnp.asarray(rank, jnp.int32), n_users,
    ))
    np.testing.assert_array_equal(out, ref)
    for j in range(300):
        allowed = np.setdiff1d(np.arange(n_users, n_users + n_items), flat[lo[j] : hi[j]])
        assert out[j] == allowed[rank[j]]
    # The user whose ignore list leaves one item gets that item.
    assert set(out[rows == 0]) == {n_users + 17}


def _toy_sampler():
    # The toy case of tests/test_sampler.py: u2 may only get item 7.
    arrays = SamplerArrays(
        users=np.array([0, 1, 2]),
        pos_indptr=np.array([0, 1, 3, 4]),
        pos_flat=np.array([3, 4, 5, 6]),
        ign_indptr=np.array([0, 2, 4, 8]),
        ign_flat=np.array([3, 4, 4, 5, 3, 4, 5, 6]),
    )
    return tbpr.make_sampler_data(arrays, n_users=3, n_items=5, device="cpu")


def test_sampler_validity_and_uniformity():
    sd = _toy_sampler()
    g = torch.Generator().manual_seed(0)
    pos_sets, ign_sets = {0: {3}, 1: {4, 5}, 2: {6}}, {0: {3, 4}, 1: {4, 5}, 2: {3, 4, 5, 6}}
    users, pos, neg = (t.numpy() for t in tbpr.sample_batch(g, sd, 20_000))
    for u in range(3):
        sel = users == u
        assert set(pos[sel]) <= pos_sets[u]
        assert not set(neg[sel]) & ign_sets[u] and set(neg[sel]) <= set(range(3, 8))
    assert set(neg[users == 2]) == {7}
    # Uniform users, positives and allowed negatives: each share within 0.02
    # of its expectation (binomial s.d. at 20,000 draws is under 0.006).
    assert np.abs(np.bincount(users, minlength=3) / len(users) - 1 / 3).max() < 0.02
    p1 = pos[users == 1]
    assert abs((p1 == 4).mean() - 0.5) < 0.02
    n0 = neg[users == 0]
    for item in (5, 6, 7):
        assert abs((n0 == item).mean() - 1 / 3) < 0.02


def test_sampler_without_replacement_has_no_repeats():
    sd = _toy_sampler()
    for seed in range(5):
        users, _, _ = tbpr.sample_batch(torch.Generator().manual_seed(seed), sd, 3, replace=False)
        assert sorted(users.tolist()) == [0, 1, 2]


def test_sampler_is_seeded():
    sd = _toy_sampler()
    a = tbpr.sample_batch(torch.Generator().manual_seed(9), sd, 50)
    b = tbpr.sample_batch(torch.Generator().manual_seed(9), sd, 50)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- gradients


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs()
    jgraph, tgraph = graphs(u, i, w, n_u, n_i)
    emb = np.random.default_rng(0).uniform(-0.3, 0.3, (jgraph.num_nodes, DIM)).astype(np.float32)
    rng = np.random.default_rng(1)
    batches = [
        (rng.integers(0, n_u, BATCH), n_u + rng.integers(0, n_i, BATCH), n_u + rng.integers(0, n_i, BATCH))
        for _ in range(5)
    ]
    return jgraph, tgraph, emb, batches


def _fast_pair(jgraph, tgraph, mode, heavy):
    if mode == "f32":
        return (
            jbip.build_fast_bipartite(jgraph, fast_ops=True, heavy_users=heavy),
            tbip.build_fast_bipartite(tgraph, fast_ops=True, heavy_users=heavy, device="cpu"),
        )
    return (
        jbip.build_fast_bipartite(
            jgraph, dtype=jnp.bfloat16, fast_ops=True, msgs_dtype="bfloat16",
            heavy_users=heavy, heavy_dtype="bfloat16",
        ),
        tbip.build_fast_bipartite(
            tgraph, dtype=torch.bfloat16, fast_ops=True, msgs_dtype="bfloat16", heavy_users=heavy,
            heavy_dtype="bfloat16", device="cpu",
        ),
    )


def _jax_loss(path, jgraph, jfb):
    cfg = JaxConfig(jgraph.num_nodes, DIM, LAYERS)

    def loss(params, users, pos, neg):
        if path == "layered":
            out = jax_get_embedding(params, jgraph, cfg)
            u, p, n = out[users], out[pos], out[neg]
        else:
            u, p, n, _ = jbip.fast_batch_embeddings(
                params, jfb, LAYERS, users, pos, neg, edge_cap=8192
            )
        return jlosses.bpr_loss(jnp.sum(u * p, -1), jnp.sum(u * n, -1)) + jlosses.reg_loss(
            params["embedding"], users, pos, neg, DECAY
        )

    return loss


def _port_fns(path, tgraph, tfb, optimizer):
    cfg = LightGCNConfig(tgraph.num_nodes, DIM, LAYERS)
    if path == "layered":
        return tgraph, tstep.make_train_fns(cfg, optimizer, BATCH, DECAY)[0]
    step, _ = tstep.make_train_fns(
        cfg, optimizer, BATCH, DECAY,
        batch_embed_fn=lambda p, fb, u, po, ne: tbip.fast_batch_embeddings(
            p, fb, LAYERS, u, po, ne, edge_cap=8192
        ),
    )
    return tfb, step


class _RecordGrads:
    def update(self, grads, state, params):
        self.grads = grads


def _feed(monkeypatch, batches):
    it = iter([tuple(torch.from_numpy(b) for b in batch) for batch in batches])
    monkeypatch.setattr(tstep, "sample_batch", lambda *a, **k: next(it))


def test_fast_pair_vjps_are_transposes(case):
    """d/dx <g, fast_to_items(x)> = Â_ui g and d/dy <h, fast_to_users(y)> =
    Â_iu h, with the head on, against the JAX package's plain products."""
    jgraph, tgraph, _, _ = case
    jsplit = jbip.split_graph(jgraph)
    tfb = tbip.build_fast_bipartite(tgraph, fast_ops=True, heavy_users=50, device="cpu")
    x, g = normal(2, (jsplit.n_users, 8)), normal(3, (jsplit.n_items, 8))
    xt = _t(x).requires_grad_()
    (tbip.fast_to_items(xt, tfb.fops) * _t(g)).sum().backward()
    ref = np.asarray(jbip.to_users(jnp.asarray(g), jsplit))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=2e-5, atol=2e-5)
    y, h = normal(4, (jsplit.n_items, 8)), normal(5, (jsplit.n_users, 8))
    yt = _t(y).requires_grad_()
    (tbip.fast_to_users(yt, tfb.fops) * _t(h)).sum().backward()
    ref2 = np.asarray(jbip.to_items(jnp.asarray(h), jsplit))
    np.testing.assert_allclose(yt.grad.numpy(), ref2, rtol=2e-5, atol=2e-5)


def test_fast_batch_embeddings_match_jax(case):
    jgraph, tgraph, emb, batches = case
    jfb, tfb = _fast_pair(jgraph, tgraph, "f32", 50)
    users, pos, neg = batches[0]
    ref = jbip.fast_batch_embeddings(
        {"embedding": jnp.asarray(emb)}, jfb, LAYERS, jnp.asarray(users), jnp.asarray(pos),
        jnp.asarray(neg), edge_cap=8192,
    )
    out = tbip.fast_batch_embeddings(
        {"embedding": _t(emb)}, tfb, LAYERS, _t(users), _t(pos), _t(neg), edge_cap=8192
    )
    for o, r in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=3e-5, atol=3e-5)
    assert int(out[3]) == int(ref[3]) == 0
    # A capacity below the batch's arcs drops the rest and counts them.
    small = tbip.fast_batch_embeddings(
        {"embedding": _t(emb)}, tfb, LAYERS, _t(users), _t(pos), _t(neg), edge_cap=100
    )
    small_ref = jbip.fast_batch_embeddings(
        {"embedding": jnp.asarray(emb)}, jfb, LAYERS, jnp.asarray(users), jnp.asarray(pos),
        jnp.asarray(neg), edge_cap=100,
    )
    assert int(small[3]) == int(small_ref[3]) > 0
    np.testing.assert_allclose(small[0].numpy(), np.asarray(small_ref[0]), rtol=3e-5, atol=3e-5)


# (path, B_ii mode, head): f32 holds to summation order; bf16 adds the
# port's rounding of the B_ii cotangent to bf16 before its product (JAX
# multiplies the f32 cotangent), 2^-9 relative per element, so the bf16
# gradient is held in relative Frobenius norm.
GRAD_CASES = [
    ("layered", None, 0),
    ("fast", "f32", 0),
    ("fast", "f32", 50),
    ("fast", "bf16", 0),
    ("fast", "bf16", 50),
]


@pytest.mark.parametrize("path,mode,heavy", GRAD_CASES)
def test_gradients_match_jax_grad(case, monkeypatch, path, mode, heavy):
    jgraph, tgraph, emb, batches = case
    jfb, tfb = _fast_pair(jgraph, tgraph, mode, heavy) if path == "fast" else (None, None)
    users, pos, neg = batches[0]
    ref = np.asarray(jax.grad(_jax_loss(path, jgraph, jfb))(
        {"embedding": jnp.asarray(emb)}, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg)
    )["embedding"])
    rec = _RecordGrads()
    graph, step = _port_fns(path, tgraph, tfb, rec)
    _feed(monkeypatch, batches[:1])
    params = {"embedding": _t(emb)}
    _, _, metrics = step(params, None, graph, None, None)
    out = rec.grads["embedding"].numpy()
    assert float(metrics["dropped_arcs"]) == 0.0
    np.testing.assert_array_equal(params["embedding"].numpy(), emb)  # the recorder updates nothing
    if mode == "bf16":
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 2e-3
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def _assert_direction_divides_as_host(adam, state):
    """The step's direction is the host's f32 true divisions, bit for bit
    (the square root is torch's, which is not numpy's in the last bit)."""
    m = state.exp_avg["embedding"]
    v = state.exp_avg_sq["embedding"]
    bc1 = tstep._bias_correction(adam.b1, state.step)
    bc2 = tstep._bias_correction(adam.b2, state.step)
    got = tstep.adam_direction(m, v, bc1, bc2, adam.eps).numpy()
    m, v = m.numpy(), v.numpy()
    root = torch.from_numpy(v / np.float32(bc2)).sqrt().numpy()
    ref = (m / np.float32(bc1)) / (root + np.float32(adam.eps))
    np.testing.assert_array_equal(got, ref)


def test_adam_matches_optax_on_the_same_gradients():
    emb = normal(7, (40, 6))
    grads = [normal(8 + s, (40, 6)) * 10.0 ** (s - 2) for s in range(3)]
    grads[1][:5] = 0.0  # rows a step does not touch
    opt = optax.adam(LR)
    jp = {"embedding": jnp.asarray(emb)}
    jstate = opt.init(jp)
    adam = tstep.Adam(LR)
    tp = {"embedding": _t(emb)}
    tstate = adam.init(tp)
    for g in grads:
        upd, jstate = opt.update({"embedding": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        adam.update({"embedding": _t(g)}, tstate, tp)
        _assert_direction_divides_as_host(adam, tstate)
        # The same f32 update in another grouping of the bias corrections.
        np.testing.assert_allclose(tp["embedding"].numpy(), np.asarray(jp["embedding"]), rtol=1e-6, atol=1e-7)
    assert tstate.step == int(jstate[0].count) == 3
    # Moments: b1·m + (1-b1)·g rounds once more or less than optax's form.
    for mine, theirs in ((tstate.exp_avg, jstate[0].mu), (tstate.exp_avg_sq, jstate[0].nu)):
        ref = np.asarray(theirs["embedding"])
        np.testing.assert_allclose(mine["embedding"].numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("path,mode,heavy", [("layered", None, 0), ("fast", "f32", 50)])
def test_five_step_parameters_match_jax(case, monkeypatch, path, mode, heavy):
    """Five Adam steps on the same batches. Adam's first step is -lr·sign(g)
    for |g| >> eps, so an entry whose gradient cancels to ~eps may step
    differently in the two packages; such an entry can differ by up to
    about lr per step. The rest agree to f32 rounding: the parameter change
    is held to 1e-4 in relative Frobenius norm, and every entry within
    2·lr."""
    jgraph, tgraph, emb, batches = case
    jfb, tfb = _fast_pair(jgraph, tgraph, mode, heavy) if path == "fast" else (None, None)
    grad_fn = jax.grad(_jax_loss(path, jgraph, jfb))
    opt = optax.adam(LR)
    jp = {"embedding": jnp.asarray(emb)}
    jstate = opt.init(jp)
    for users, pos, neg in batches:
        g = grad_fn(jp, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg))
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    adam = tstep.Adam(LR)
    graph, step = _port_fns(path, tgraph, tfb, adam)
    _feed(monkeypatch, batches)
    tp = {"embedding": _t(emb)}
    state = adam.init(tp)
    for _ in batches:
        tp, state, _ = step(tp, state, graph, None, None)
    out, ref = tp["embedding"].numpy(), np.asarray(jp["embedding"])
    assert state.step == 5
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref - emb) < 1e-4
    assert np.abs(out - ref).max() <= 2 * LR
