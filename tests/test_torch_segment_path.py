"""The port's plan-less fast bipartite path against the JAX package's, on the
same numpy arcs (tests/torch_port_case.py's small case, on the CPU):

- ``to_users`` / ``to_items`` (JAX's sorted segment sums, ``_seg_spmm``) and
  their VJPs, each the other direction, in f32 to 1e-6 (summation order
  only);
- ``fast_get_embedding`` and ``fast_batch_embeddings`` on
  ``FastBipartite(split, item_op)`` (``fops=None``): f32 B_ii to 1e-5; bf16
  B_ii to a relative Frobenius error of 2e-3, the bound of
  ``test_torch_train_step.py::test_gradients_match_jax_grad`` (a bf16
  rounding flipped by a summation order is 2^-8 relative in one element);
- ``build_fast_bipartite(graph)`` builds no plans in either package, and
  the plan-less and plan forwards agree;
- the segment sums give the same bytes on every call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

LAYERS, DIM, EDGE_CAP = 3, 12, 8192


@pytest.fixture(scope="module")
def case():
    jgraph, tgraph = graphs(*small_arcs())
    return jgraph, tgraph, jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("direction", ["to_users", "to_items"])
def test_segment_sums_match_jax(case, direction):
    _, _, jsplit, tsplit = case
    n_in = jsplit.n_items if direction == "to_users" else jsplit.n_users
    x = normal(1, (n_in, 8))
    ref = np.asarray(getattr(jbip, direction)(jnp.asarray(x), jsplit))
    out = getattr(tbip, direction)(_t(x), tsplit)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("direction", ["to_users", "to_items"])
def test_segment_sum_vjps_match_jax(case, direction):
    """d/dx <g, op(x)> in both packages: each op's VJP is the other op."""
    _, _, jsplit, tsplit = case
    n_in, n_out = (
        (jsplit.n_items, jsplit.n_users) if direction == "to_users" else (jsplit.n_users, jsplit.n_items)
    )
    x, g = normal(2, (n_in, 6)), normal(3, (n_out, 6))
    jop = getattr(jbip, direction)
    _, vjp = jax.vjp(lambda v: jop(v, jsplit), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _t(x).requires_grad_()
    (getattr(tbip, direction)(xt, tsplit) * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    other = "to_items" if direction == "to_users" else "to_users"
    np.testing.assert_array_equal(xt.grad.numpy(), getattr(tbip, other)(_t(g), tsplit).numpy())


def test_segment_sums_repeat_bytes(case):
    _, _, _, tsplit = case
    fb = tbip.FastBipartite(tsplit, torch.zeros(tsplit.n_items, tsplit.n_items))
    x = _t(normal(4, (tsplit.n_users, 5)))
    assert torch.equal(fb.to_items(x), fb.to_items(x))
    y = _t(normal(5, (tsplit.n_items, 5)))
    assert torch.equal(fb.to_users(y), fb.to_users(y))


def _pair(case, dtype: str):
    """(JAX FastBipartite(split, item_op), the port's) with fops None."""
    _, _, jsplit, tsplit = case
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jop = jbip.build_item_operator(jsplit, dtype=jdt)
    top = tbip.build_item_operator(tsplit, dtype=tdt, device="cpu")
    return jbip.FastBipartite(split=jsplit, item_op=jop), tbip.FastBipartite(tsplit, top)


def _close(out: np.ndarray, ref: np.ndarray, dtype: str) -> None:
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 2e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_get_embedding_without_plans_matches_jax(case, dtype):
    jgraph, _, _, _ = case
    jfb, tfb = _pair(case, dtype)
    assert jfb.fops is None and tfb.fops is None and tfb.item_csr is not None
    emb = normal(6, (jgraph.num_nodes, DIM)) * 0.1
    ref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)}, jfb, LAYERS))
    out = tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, LAYERS)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fast_batch_embeddings_without_plans_matches_jax(case, dtype):
    """The train step's batched forward and its gradient (to_items' VJP is
    to_users over every user) on fops=None."""
    jgraph, _, jsplit, _ = case
    jfb, tfb = _pair(case, dtype)
    rng = np.random.default_rng(7)
    users = rng.integers(0, jsplit.n_users, 64)
    pos = rng.integers(0, jsplit.n_items, 64) + jsplit.n_users
    neg = rng.integers(0, jsplit.n_items, 64) + jsplit.n_users
    emb = normal(8, (jgraph.num_nodes, DIM)) * 0.1

    def jloss(e):
        u, p, n, dropped = jbip.fast_batch_embeddings(
            {"embedding": e}, jfb, LAYERS, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg),
            edge_cap=EDGE_CAP,
        )
        return jnp.sum(u * (p - n)), (u, p, n, dropped)

    (_, (ju, jp, jn, jdrop)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(emb))
    e = _t(emb).requires_grad_()
    u, p, n, dropped = tbip.fast_batch_embeddings(
        {"embedding": e}, tfb, LAYERS, _t(users), _t(pos), _t(neg), edge_cap=EDGE_CAP,
    )
    (u * (p - n)).sum().backward()
    assert int(dropped) == int(jdrop) == 0
    for got, ref in ((u, ju), (p, jp), (n, jn)):
        _close(got.detach().numpy(), np.asarray(ref), dtype)
    _close(e.grad.numpy(), np.asarray(jgrad), dtype)


def test_build_fast_bipartite_defaults_to_no_plans(case):
    jgraph, tgraph, _, _ = case
    jfb = jbip.build_fast_bipartite(jgraph)
    tfb = tbip.build_fast_bipartite(tgraph, device="cpu")
    assert jfb.fops is None and tfb.fops is None
    emb = normal(9, (jgraph.num_nodes, DIM))
    ref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)}, jfb, LAYERS))
    out = tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, LAYERS).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # The plans path computes the same function.
    with_plans = tbip.build_fast_bipartite(tgraph, fast_ops=True, heavy_users=50, device="cpu")
    assert with_plans.fops is not None and with_plans.item_csr is None
    got = tbip.fast_get_embedding({"embedding": _t(emb)}, with_plans, LAYERS).numpy()
    np.testing.assert_allclose(got, out, rtol=1e-5, atol=1e-5 * np.abs(out).max())
