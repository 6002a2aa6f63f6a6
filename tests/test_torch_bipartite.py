"""The port's bipartite forward, layered model and weight conversion against
the JAX package on the same arcs and the same weights (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import get_embedding as jax_get_embedding
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu_torch.convert import params_to_numpy, params_to_torch
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, get_embedding, init_params, uniform_alphas
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    jgraph, tgraph = graphs(*small_arcs())
    return jgraph, tgraph, jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _params(graph, dim, seed=0):
    """The same numpy weights for both packages."""
    bound = (6.0 / (graph.num_nodes + dim)) ** 0.5
    emb = np.random.default_rng(seed).uniform(-bound, bound, (graph.num_nodes, dim))
    emb = emb.astype(np.float32)
    return {"embedding": jnp.asarray(emb)}, params_to_torch({"embedding": emb}, "cpu")


def test_split_graph_matches_jax(small):
    _, _, jsplit, tsplit = small
    for field in (
        "iu_src_item", "iu_dst_user", "iu_w", "iu_indptr",
        "ui_src_user", "ui_dst_item", "ui_w",
    ):
        np.testing.assert_array_equal(getattr(tsplit, field), np.asarray(getattr(jsplit, field)))
    assert (tsplit.n_users, tsplit.n_items) == (jsplit.n_users, jsplit.n_items)


@pytest.mark.parametrize("heavy,dtype", [(50, "float32"), (50, "bfloat16"), (10_000, "float32")])
def test_split_heavy_users_matches_jax(small, heavy, dtype):
    _, _, jsplit, tsplit = small
    jout = jbip.split_heavy_users(jsplit, heavy, dtype)
    tout = tbip.split_heavy_users(tsplit, heavy, dtype, device="cpu")
    j_hi, j_w = np.asarray(jout[0]), np.asarray(jout[1].astype(jnp.float32))
    np.testing.assert_array_equal(tout[0].numpy(), j_hi)
    np.testing.assert_array_equal(tout[1].float().numpy(), j_w)
    assert len(tout) == len(jout)
    for t_arr, j_arr in zip(tout[2:8], jout[2:8]):
        np.testing.assert_array_equal(np.asarray(t_arr), np.asarray(j_arr))
    for t_arr, j_arr in zip(tout[8], jout[8]):  # the head's host COO
        np.testing.assert_array_equal(t_arr, j_arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_item_operator_matches_jax(small, dtype):
    _, _, jsplit, tsplit = small
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(jbip.build_item_operator(jsplit, dtype=jdt).astype(jnp.float32))
    out = tbip.build_item_operator(tsplit, dtype=tdt, device="cpu")
    assert out.dtype == tdt
    # f32: summation order only. bf16: one f32 sum rounded once to bf16, so
    # an order change can flip the last bf16 bit (2^-8 relative).
    tol = 2e-5 if dtype == "float32" else 2**-8
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("layers,heavy", [(3, 0), (5, 0), (3, 50), (5, 50)])
def test_fast_get_embedding_f32_matches_jax(small, layers, heavy):
    jgraph, tgraph, jsplit, tsplit = small
    jfb = jbip.build_fast_bipartite(jgraph, fast_ops=True, heavy_users=heavy)
    tfb = tbip.build_fast_bipartite(tgraph, fast_ops=True, heavy_users=heavy, device="cpu")
    jp, tp = _params(jgraph, 12)
    ref = np.asarray(jbip.fast_get_embedding(jp, jfb, layers))
    out = tbip.fast_get_embedding(tp, tfb, layers)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("layers", [3, 5])
def test_fast_get_embedding_bf16_matches_jax(small, layers):
    """The main configuration's mode: bf16 B_ii, messages and head."""
    jgraph, tgraph, _, _ = small
    jfb = jbip.build_fast_bipartite(
        jgraph, dtype=jnp.bfloat16, fast_ops=True, msgs_dtype="bfloat16",
        heavy_users=50, heavy_dtype="bfloat16",
    )
    tfb = tbip.build_fast_bipartite(
        tgraph, dtype=torch.bfloat16, fast_ops=True, msgs_dtype="bfloat16", heavy_users=50,
        heavy_dtype="bfloat16", device="cpu",
    )
    jp, tp = _params(jgraph, 16, seed=1)
    ref = np.asarray(jbip.fast_get_embedding(jp, jfb, layers))
    out = tbip.fast_get_embedding(tp, tfb, layers).numpy()
    assert np.isfinite(out).all()
    # One flipped bf16 rounding in the chain is 2^-8 relative.
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2


@pytest.mark.parametrize("layers", [3, 5])
def test_layered_get_embedding_matches_jax(small, layers):
    jgraph, tgraph, _, _ = small
    jp, tp = _params(jgraph, 12, seed=2)
    ref = np.asarray(
        jax_get_embedding(jp, jgraph, JaxConfig(jgraph.num_nodes, 12, layers))
    )
    out = get_embedding(tp, tgraph, LightGCNConfig(tgraph.num_nodes, 12, layers))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layers", [3, 5])
def test_fast_forward_matches_layered_reference(small, layers):
    """What chip_smoke.py checks on the card: the service's fast f32
    forward (no head) against the port's layered get_embedding."""
    _, tgraph, _, _ = small
    cfg = LightGCNConfig(tgraph.num_nodes, 16, layers)
    params = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    tfb = tbip.build_fast_bipartite(tgraph, fast_ops=True, device="cpu")
    ref = get_embedding(params, tgraph, cfg)
    out = tbip.fast_get_embedding(params, tfb, layers, alpha=cfg.alphas())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * ref.abs().max().item())


def test_init_params_xavier_bound_and_seeded():
    cfg = LightGCNConfig(num_nodes=500, embedding_dim=12, num_layers=3)
    a = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")["embedding"]
    b = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")["embedding"]
    bound = (6.0 / (500 + 12)) ** 0.5
    assert a.shape == (500, 12) and a.dtype == torch.float32
    assert a.abs().max() <= bound and a.abs().max() > 0.9 * bound
    assert torch.equal(a, b)


def test_convert_roundtrip_unchanged():
    emb = jax.random.normal(jax.random.key(0), (37, 9), jnp.float32)
    tp = params_to_torch({"embedding": emb}, "cpu")
    assert tp["embedding"].dtype == torch.float32
    np.testing.assert_array_equal(tp["embedding"].numpy(), np.asarray(emb))
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["embedding"], np.asarray(emb))
    # The round trip feeds the JAX forward unchanged.
    graph, _ = graphs(*small_arcs(seed=4, n_u=30, n_i=7, e=80))
    cfg = JaxConfig(graph.num_nodes, 9, 2)
    jp = {"embedding": jax.random.normal(jax.random.key(1), (graph.num_nodes, 9))}
    again = {"embedding": jnp.asarray(params_to_numpy(params_to_torch(jp, "cpu"))["embedding"])}
    np.testing.assert_array_equal(
        np.asarray(jax_get_embedding(again, graph, cfg)),
        np.asarray(jax_get_embedding(jp, graph, cfg)),
    )


def test_resolve_device_sets_exact_f32_and_mm_f32_checks_it(monkeypatch):
    from gnn_ecommerce_tpu_torch.device import mm_f32, resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a = torch.ones(2, 3)
    with pytest.raises(RuntimeError, match="without TF32"):
        mm_f32(a, a.T)
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    torch.testing.assert_close(mm_f32(a, a.T), torch.full((2, 2), 3.0))


# --- B_ii's row-padded layout and the chain over it --------------------------

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def odd():
    """A port split with an odd item count, so that no row of B_ii is 16-byte
    aligned unless padded."""
    _, tgraph = graphs(*small_arcs(seed=5, n_i=61))
    return tbip.split_graph(tgraph)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_item_operator_is_a_view_of_row_padded_storage(odd, dtype):
    B = tbip.build_item_operator(odd, dtype=_TDT[dtype], device="cpu")
    n = odd.n_items
    assert B.shape == (n, n) and B.stride(1) == 1 and n % 2 == 1
    assert B.stride(0) == tbip.padded_cols(n, B.dtype)
    if dtype == "bfloat16":  # the tensor cores' operand: 16-byte rows, padding zero
        assert B.stride(0) * B.element_size() % 16 == 0 and B.stride(0) > n
        full = tbip._over_padding(B)
        assert full.shape == (n, B.stride(0)) and not full[:, n:].any()
    else:  # f32 GEMMs align themselves: the accumulator, contiguous
        assert B.is_contiguous()
    assert torch.equal(B, B.contiguous())


def _chain(B, layers, dim, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    E_u, E_i = (torch.randn(B.shape[0], dim, generator=g).requires_grad_(grad) for _ in range(2))
    alpha = uniform_alphas(layers, B.device)
    out_i, S_i = tbip.item_chain_core(E_u, E_i, lambda x: x, B, layers, alpha)
    assert out_i.shape == S_i.shape == (B.shape[0], dim)
    if not grad:
        return out_i, S_i
    return torch.autograd.grad((out_i * out_i).sum() + S_i.sum(), (E_u, E_i))


@pytest.mark.parametrize("layers", [3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_over_padded_operator_equals_contiguous(odd, dtype, layers):
    """Pairs of width 18 and singles of 9 get zero columns (to 24 and 16 in
    bf16); the padded operator gives the contiguous one's sums bit for bit."""
    B = tbip.build_item_operator(odd, dtype=_TDT[dtype], device="cpu")
    for got, want in zip(_chain(B, layers, 9), _chain(B.contiguous(), layers, 9)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_backward_over_padded_operator_equals_contiguous(odd, dtype):
    B = tbip.build_item_operator(odd, dtype=_TDT[dtype], device="cpu")
    for got, want in zip(_chain(B, 5, 9, grad=True), _chain(B.contiguous(), 5, 9, grad=True)):
        assert torch.equal(got, want)


def test_unaligned_counter_reads_zero_on_the_built_layout(odd):
    from gnn_ecommerce_tpu_torch import tracing

    def unaligned(B, layers):
        with tracing.recording():
            _chain(B, layers, 9)
        return tracing.report()["counters"].get("ops.item_chain.unaligned", 0)

    B = tbip.build_item_operator(odd, dtype=torch.bfloat16, device="cpu")
    f32 = tbip.build_item_operator(odd, dtype=torch.float32, device="cpu")
    assert unaligned(B, 5) == unaligned(B, 4) == unaligned(f32, 5) == 0
    assert unaligned(B.contiguous(), 5) == unaligned(B.contiguous(), 4) == 2


def test_product_over_the_padding_matches_the_logical_one(odd):
    """The card's form of ``item_op_mm`` (the rows read whole, against zero
    rows of x), and its gradient, against the logical [I, I] product."""
    from gnn_ecommerce_tpu_torch.device import mm_f32

    B = tbip.build_item_operator(odd, dtype=torch.bfloat16, device="cpu")
    full = tbip._over_padding(B)
    pad = full.shape[1] - B.shape[0]
    x = torch.randn(B.shape[0], 24, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16).requires_grad_(True)
    wide = mm_f32(full, torch.nn.functional.pad(x, (0, 0, 0, pad)))
    want = mm_f32(B, x)
    tol = dict(rtol=1e-6, atol=1e-6 * want.abs().max().item())
    torch.testing.assert_close(wide, want, **tol)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    (gw,), (gl,) = torch.autograd.grad(wide, x, g), torch.autograd.grad(want, x, g)
    assert torch.equal(gw, gl)
    # A band of rows (the mesh's ItemBand) widens the same way.
    band = tbip._over_padding(B[10:30])
    assert band.shape == (20, full.shape[1]) and torch.equal(band, full[10:30])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_band_copy_keeps_the_row_padding(odd, dtype):
    import dataclasses

    from gnn_ecommerce_tpu_torch.parallel.edge_partition_fast import ItemBand
    from gnn_ecommerce_tpu_torch.train.driver import _own_band

    @dataclasses.dataclass(frozen=True)
    class Layout:
        item_op: ItemBand

    B = tbip.build_item_operator(odd, dtype=_TDT[dtype], device="cpu")
    view = B[32:]
    own = _own_band(Layout(ItemBand(view, 32, B.shape[0], None))).item_op.rows
    assert torch.equal(own, view) and own.untyped_storage().data_ptr() != B.untyped_storage().data_ptr()
    assert own.stride() == B.stride() == (tbip.padded_cols(B.shape[0], B.dtype), 1)
    assert tbip._over_padding(own).shape == (view.shape[0], B.stride(0))
