"""The port's SVD baseline on the CPU against the JAX package's:
``predict`` on converted parameters, ``precision_recall_at_k`` on the same
parameters, one epoch fed the same permutation against a JAX epoch built
from JAX's ``predict`` and ``optax.adam``, the planted structure learned,
``run_cv``'s folds, and ``cli.svd`` on the committed MovieLens fixture.

Tolerances: ``predict`` rtol 1e-6; P/R@K exactly equal; one epoch rtol 1e-5
(atol 1e-7, for parameters near zero); the planted fit's RMSE below 0.6x
the mean predictor's, as ``tests/test_svd_and_eda.py``; folds exactly
equal; ``cli.svd``'s mean P/R@10 within 0.02 of JAX's (the inits and the
shuffles come from other generators)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.cli import svd as jax_svd_cli
from gnn_ecommerce_tpu.models import svd as jax_svd
from gnn_ecommerce_tpu_torch.cli import svd as svd_cli
from gnn_ecommerce_tpu_torch.convert import svd_params_to_torch
from gnn_ecommerce_tpu_torch.models import svd
from gnn_ecommerce_tpu_torch.train.step import Adam

torch.set_num_threads(1)

ML100K = "data/ml100k_synth_u.data"


@pytest.fixture(scope="module")
def planted():
    """Low-rank planted ratings: two user groups x two item groups (the
    case of tests/test_svd_and_eda.py)."""
    rng = np.random.default_rng(5)
    n_users, n_items, n_obs = 120, 60, 3000
    u = rng.integers(0, n_users, n_obs)
    i = rng.integers(0, n_items, n_obs)
    affinity = ((u < 60) == (i < 30)).astype(np.float64)
    r = np.clip(0.2 + 0.8 * affinity + rng.normal(0, 0.05, n_obs), 0, 1.2)
    return n_users, n_items, u, i, r.astype(np.float32)


@pytest.fixture(scope="module")
def jax_params(planted):
    n_users, n_items, u, i, r = planted
    cfg = jax_svd.SVDConfig(n_factors=8, n_epochs=6, batch_size=512)
    return jax_svd.fit_svd(u[:2400], i[:2400], r[:2400], n_users, n_items, cfg)


def test_predict_on_converted_params(planted, jax_params):
    _, _, u, i, _ = planted
    params = svd_params_to_torch(jax_params, "cpu")
    assert params["mu"].shape == () and params["p"].dtype == torch.float32
    got = svd.predict(params, torch.from_numpy(u), torch.from_numpy(i)).numpy()
    want = np.asarray(jax_svd.predict(jax_params, jnp.asarray(u), jnp.asarray(i)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(KeyError, match="exactly"):
        svd_params_to_torch({k: v for k, v in jax_params.items() if k != "mu"}, "cpu")


@pytest.mark.parametrize("k, rel, est", [(10, 1.0, 0.5), (3, 0.9, 0.5), (5, 0.5, 0.3)])
def test_precision_recall_at_k_matches_jax(planted, jax_params, k, rel, est):
    _, _, u, i, r = planted
    params = svd_params_to_torch(jax_params, "cpu")
    test = slice(2400, None)
    got = svd.precision_recall_at_k(params, u[test], i[test], r[test], k, rel, est)
    want = jax_svd.precision_recall_at_k(jax_params, u[test], i[test], r[test], k, rel, est)
    assert got == want


def test_precision_recall_semantics(monkeypatch):
    """The hand-checked surprise example of tests/test_svd_and_eda.py."""
    users = np.array([0, 0, 0, 1, 1])
    items = np.array([0, 1, 2, 0, 1])
    ratings = np.array([1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    ests = torch.tensor([0.9, 0.8, 0.1, 0.4, 0.6])
    monkeypatch.setattr(svd, "predict", lambda p, u, i: ests)
    precision, recall = svd.precision_recall_at_k(
        {"p": torch.zeros(1)}, users, items, ratings, k=2, rel_threshold=1.0, est_threshold=0.5
    )
    assert precision == pytest.approx((0.5 + 1.0) / 2)
    assert recall == pytest.approx(0.5)


def jax_epoch(params, opt_state, perm, data, bsz, reg, lr):
    """One epoch as JAX's fit_svd runs it (its loss, jax.grad, optax.adam),
    on a permutation given from outside."""
    opt = optax.adam(lr)

    def loss_fn(params, u, i, r, valid):
        err = (jax_svd.predict(params, u, i) - r) ** 2
        mse = jnp.sum(err * valid) / jnp.maximum(valid.sum(), 1)
        l2 = reg * (
            jnp.mean(params["b_u"][u] ** 2)
            + jnp.mean(params["b_i"][i] ** 2)
            + jnp.mean(jnp.sum(params["p"][u] ** 2, -1))
            + jnp.mean(jnp.sum(params["q"][i] ** 2, -1))
        )
        return mse + l2

    u, i, r, valid = (jnp.asarray(x)[perm] for x in data)
    for lo in range(0, len(perm), bsz):
        sl = slice(lo, lo + bsz)
        grads = jax.grad(loss_fn)(params, u[sl], i[sl], r[sl], valid[sl])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


@pytest.mark.parametrize("batch_size", [512, 5000])
def test_one_epoch_matches_jax_epoch(planted, batch_size):
    """Two epochs fed the same permutations: every parameter within rtol
    1e-5 of the JAX epoch's, untouched rows included (Adam is dense)."""
    n_users, n_items, u, i, r = planted
    cfg = svd.SVDConfig(n_factors=8, batch_size=batch_size, lr=0.02)
    rng = np.random.default_rng(batch_size)
    init = {
        "mu": np.float32(np.mean(r[:2400])),
        "b_u": np.zeros(n_users, np.float32),
        "b_i": np.zeros(n_items, np.float32),
        "p": (0.1 * rng.standard_normal((n_users, 8))).astype(np.float32),
        "q": (0.1 * rng.standard_normal((n_items, 8))).astype(np.float32),
    }
    data, bsz = svd.pad_edges(u[:2400], i[:2400], r[:2400], batch_size, "cpu")
    params = svd_params_to_torch(init, "cpu")
    opt = Adam(cfg.lr)
    state = opt.init(params)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = optax.adam(cfg.lr).init(j_params)
    j_data = tuple(x.numpy() for x in data)
    for epoch in range(2):
        perm = rng.permutation(len(data[0]))
        svd.svd_epoch(params, opt, state, torch.from_numpy(perm), data, bsz, cfg.reg)
        j_params, j_state = jax_epoch(j_params, j_state, perm, j_data, bsz, cfg.reg, cfg.lr)
    for name, want in j_params.items():
        np.testing.assert_allclose(params[name].numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert state.step == 2 * (len(data[0]) // bsz)


def test_adam_moves_rows_no_batch_touches():
    """A user seen only in the first batch still moves in the second step,
    by its moments, as optax's dense update moves it."""
    users, items = np.array([0, 1]), np.array([0, 0])
    data, bsz = svd.pad_edges(users, items, np.array([1.0, 0.0], np.float32), 1, "cpu")
    params = svd.init_svd(torch.Generator().manual_seed(0), 3, 1, svd.SVDConfig(n_factors=2))
    opt = Adam(0.1)
    state = opt.init(params)
    svd.svd_epoch(params, opt, state, torch.tensor([0]), data, bsz, 0.02)
    after_first = params["b_u"].clone()
    svd.svd_epoch(params, opt, state, torch.tensor([1]), data, bsz, 0.02)
    assert after_first[0] != 0 and params["b_u"][0] != after_first[0]
    assert params["b_u"][2] == 0  # never touched: zero gradient, zero moments


def test_svd_learns_planted_structure(planted):
    n_users, n_items, u, i, r = planted
    split = int(0.8 * len(u))
    cfg = svd.SVDConfig(n_factors=8, n_epochs=30, batch_size=512)
    params = svd.fit_svd(u[:split], i[:split], r[:split], n_users, n_items, cfg, device="cpu")
    est = svd.predict(params, torch.from_numpy(u[split:]), torch.from_numpy(i[split:])).numpy()
    truth = r[split:]
    rmse = float(np.sqrt(np.mean((est - truth) ** 2)))
    baseline = float(np.sqrt(np.mean((truth.mean() - truth) ** 2)))
    assert rmse < 0.6 * baseline, (rmse, baseline)
    again = svd.fit_svd(u[:split], i[:split], r[:split], n_users, n_items, cfg, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)  # one seed, one fit


@pytest.mark.parametrize("folds", [2, 5])
def test_run_cv_folds_match_jax(planted, monkeypatch, folds):
    """Both packages hand each fold the same train and test rows (after the
    same id densification)."""
    from gnn_ecommerce_tpu_torch.data.events import Edges
    import pandas as pd

    _, _, u, i, r = planted
    users = 1000 + 3 * u  # sparse ids, densified by both
    calls = {"port": [], "jax": []}

    def recorder(side):
        def fit(uu, ii, rr, n_u, n_i, cfg, **kw):
            calls[side].append(("fit", uu.copy(), ii.copy(), rr.copy(), n_u, n_i))
            return {}

        def pr(params, uu, ii, rr, k=10, **kw):
            calls[side].append(("test", uu.copy(), ii.copy(), rr.copy()))
            return 0.5, 0.25

        return fit, pr

    for side, mod in (("port", svd_cli), ("jax", jax_svd_cli)):
        fit, pr = recorder(side)
        monkeypatch.setattr(mod, "fit_svd", fit)
        monkeypatch.setattr(mod, "precision_recall_at_k", pr)
    got = svd_cli.run_cv(Edges(users, i, r), folds=folds, device="cpu")
    want = jax_svd_cli.run_cv(pd.DataFrame({"user_id": users, "item_id": i, "weight": r}), folds=folds)
    assert got == want
    assert len(calls["port"]) == len(calls["jax"]) == 2 * folds
    for a, b in zip(calls["port"], calls["jax"]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_svd_cli_within_002_of_jax(tmp_path, capsys):
    """``cli.svd --movielens`` on the MovieLens fixture: mean P@10 and R@10
    within 0.02 of JAX's, with the same folds."""
    flags = ["--movielens", ML100K, "--folds", "2", "--epochs", "5", "-k", "10", "--factors", "16"]
    jax_svd_cli.main([*flags, "--out", str(tmp_path / "jax.json")])
    got = svd_cli.main([*flags, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["folds"] == 2 and got["k"] == 10
    for key in ("precision_mean", "recall_mean"):
        assert abs(got[key] - want[key]) <= 0.02, (key, got[key], want[key])
    assert json.dumps(got, indent=1) in capsys.readouterr().out


def test_svd_cli_reads_an_edges_csv(planted, tmp_path):
    from gnn_ecommerce_tpu_torch.data.events import Edges

    _, _, u, i, r = planted
    Edges(u, i, r.astype(np.float64)).to_csv(str(tmp_path / "edges.csv"))
    got = svd_cli.main([
        "--edges", str(tmp_path / "edges.csv"), "--folds", "2", "--epochs", "10",
        "--factors", "8", "-k", "5", "--device", "cpu",
    ])
    assert got["folds"] == 2 and len(got["precision_per_fold"]) == 2
    (tmp_path / "bad.csv").write_text("user_id,item_id\n1,2\n")
    with pytest.raises(SystemExit, match="weight"):
        svd_cli.main(["--edges", str(tmp_path / "bad.csv"), "--device", "cpu"])


def test_svd_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, planted):
    n_users, n_items, u, i, r = planted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svd.fit_svd(u, i, r, n_users, n_items)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svd_cli.main(["--movielens", ML100K])
