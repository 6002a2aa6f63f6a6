"""The rest of the layered model API against the JAX package's, on the
shared small arcs: pair_scores, forward, predict_link, the chunked
propagation at several chunk counts, and the implementation registry."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.models import lightgcn as jax_lightgcn
from gnn_ecommerce_tpu_torch.convert import params_to_torch
from gnn_ecommerce_tpu_torch.models import lightgcn
from gnn_ecommerce_tpu_torch.ops import propagate
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)
# The JAX package's ops/__init__ exports the function `propagate` under the
# module's name.
jax_propagate = importlib.import_module("gnn_ecommerce_tpu.ops.propagate")


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs()
    jg, tg = graphs(u, i, w, n_u, n_i)
    jcfg = jax_lightgcn.LightGCNConfig(n_u + n_i, 16, 3)
    tcfg = lightgcn.LightGCNConfig(n_u + n_i, 16, 3)
    jparams = jax_lightgcn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_to_torch(jparams, device="cpu")
    rng = np.random.default_rng(5)
    pairs = np.stack([rng.integers(0, n_u, 300), n_u + rng.integers(0, n_i, 300)])
    return jg, tg, jcfg, tcfg, jparams, tparams, pairs


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(want).max()))


def test_pair_scores_match_jax(case):
    *_, pairs = case
    emb = normal(1, (460, 16))
    got = lightgcn.pair_scores(torch.from_numpy(emb), torch.from_numpy(pairs[0]), torch.from_numpy(pairs[1]))
    close(got, jax_lightgcn.pair_scores(jnp.asarray(emb), jnp.asarray(pairs[0]), jnp.asarray(pairs[1])))


def test_forward_matches_jax(case):
    jg, tg, jcfg, tcfg, jparams, tparams, pairs = case
    got = lightgcn.forward(tparams, tg, torch.from_numpy(pairs), tcfg)
    close(got, jax_lightgcn.forward(jparams, jg, jnp.asarray(pairs), jcfg))
    # Every graph arc as the labelled pairs, and another propagation.
    arcs = torch.stack([tg.src, tg.dst])
    got = lightgcn.forward(tparams, tg, arcs, tcfg, propagate_fn=propagate.propagate_segment_chunked)
    want = jax_lightgcn.forward(
        jparams, jg, jnp.stack([jg.src, jg.dst]), jcfg,
        propagate_fn=jax_propagate.propagate_segment_chunked,
    )
    close(got, want)


@pytest.mark.parametrize("prob", [True, False])
def test_predict_link_matches_jax(case, prob):
    jg, tg, jcfg, tcfg, jparams, tparams, pairs = case
    # Scale the table so that the scores straddle 0 and rounding matters.
    jparams = {"embedding": jparams["embedding"] * 40.0}
    tparams = {"embedding": tparams["embedding"] * 40.0}
    got = lightgcn.predict_link(tparams, tg, torch.from_numpy(pairs), tcfg, prob=prob)
    want = np.asarray(jax_lightgcn.predict_link(jparams, jg, jnp.asarray(pairs), jcfg, prob=prob))
    if prob:
        close(got, want)
    else:
        assert set(np.unique(want)) == {0.0, 1.0}
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_chunks", [1, 3, 8, 64])
def test_propagate_segment_chunked_matches_jax(case, num_chunks):
    jg, tg, *_ = case
    x = normal(2, (tg.num_nodes, 12))
    got = propagate.propagate_segment_chunked(tg, torch.from_numpy(x), num_chunks)
    close(got, jax_propagate.propagate_segment_chunked(jg, jnp.asarray(x), num_chunks))
    close(got, jax_propagate.propagate_segment(jg, jnp.asarray(x)))


def test_propagate_segment_chunked_gradient_matches_jax(case):
    jg, tg, *_ = case
    x, g = normal(3, (tg.num_nodes, 8)), normal(4, (tg.num_nodes, 8))
    xt = torch.from_numpy(x).requires_grad_()
    (propagate.propagate_segment_chunked(tg, xt, 5) * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda v: (jax_propagate.propagate_segment_chunked(jg, v, 5) * g).sum())(jnp.asarray(x))
    close(xt.grad, want)


@pytest.mark.parametrize("impl", ["segment", "segment_chunked"])
def test_propagate_registry_matches_jax(case, impl):
    jg, tg, *_ = case
    x = normal(5, (tg.num_nodes, 10))
    close(propagate.propagate(tg, torch.from_numpy(x), impl), jax_propagate.propagate(jg, jnp.asarray(x), impl))


def test_register_impl(case, monkeypatch):
    jg, tg, *_ = case
    monkeypatch.setattr(propagate, "_IMPLEMENTATIONS", dict(propagate._IMPLEMENTATIONS))
    propagate.register_impl("twice", lambda graph, x: 2.0 * propagate.propagate_segment(graph, x))
    x = normal(6, (tg.num_nodes, 4))
    got = propagate.propagate(tg, torch.from_numpy(x), impl="twice")
    close(got, 2.0 * np.asarray(jax_propagate.propagate_segment(jg, jnp.asarray(x))))
    with pytest.raises(KeyError):
        propagate.propagate(tg, torch.from_numpy(x), impl="missing")
