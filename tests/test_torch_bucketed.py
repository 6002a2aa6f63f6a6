"""The port's src-bucketed to_items plan (``ops/spmm_fast.py``:
``BucketedSegReducePlan``, ``build_bucketed_segreduce_plan``,
``gather_segreduce_bucketed``, and the plain version of K1's accumulate
mode, ``segreduce_plain(prev=)``) against the JAX package's, on the same
numpy arcs, with JAX's Pallas kernel in interpret mode as its own tests run
it. The port runs on the CPU, where K1's wrapper takes its plain version.

Tolerances are those of ``tests/test_spmm_fast.py``: f32 at rtol/atol
2e-5 (the sums differ only in order), the bf16 forward with a 32-user head
within 3e-2 of max|ref| of the f32 layered reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import init_params as jax_init_params
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.ops import spmm_fast as jfast
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.ops import spmm_fast as tfast
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BUCKETS = (4, 8, 64)
HUB_ITEM = 7


@pytest.fixture(scope="module")
def small():
    jgraph, tgraph = graphs(*small_arcs())
    return jgraph, tgraph, jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _edge_arcs():
    """Dst-sorted arcs (src, dst, w, n_out, n_src) of ``small_arcs`` with
    edge cases: users 100-199 have no arc (a range with no arc for every
    bucket count here), and 100 more users, 400-499, each have one arc of
    weight 1, into item 7: a hub row, into which every arc of the last
    bucket goes with 8 or more buckets."""
    u, i, w, n_u, n_i = small_arcs()
    keep = (u < 100) | (u >= 200)
    u, i, w = u[keep], i[keep], w[keep]
    hub = np.arange(n_u, n_u + 100)
    u = np.concatenate([u, hub])
    i = np.concatenate([i, np.full(len(hub), HUB_ITEM)])
    w = np.concatenate([w, np.ones(len(hub), np.float32)])
    order = np.argsort(i, kind="stable")
    return u[order].astype(np.int32), i[order].astype(np.int32), w[order], n_i, n_u + len(hub)


def _ui(split):
    return split.ui_src_user, split.ui_dst_item, split.ui_w, split.n_items, split.n_users


@pytest.mark.parametrize("arcs", ["small", "edge_cases"])
@pytest.mark.parametrize("n_buckets", BUCKETS)
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_gather_segreduce_bucketed_matches_pallas(small, arcs, n_buckets, mode):
    """The port's bucketed reduce against JAX's (interpret mode) on the same
    arcs, in both modes: the same arithmetic (bf16 rows and bf16-rounded
    weights in bf16 mode), summed in another order."""
    src, dst, w, n_out, n_src = _ui(small[3]) if arcs == "small" else _edge_arcs()
    jdt, tdt = DTYPES[mode]
    x = normal(0, (n_src, 16))
    jplan = jfast.build_bucketed_segreduce_plan(
        np.asarray(src), np.asarray(dst), np.asarray(w), n_out, n_src, n_buckets=n_buckets
    )
    ref = jfast.gather_segreduce_bucketed(jnp.asarray(x), jplan, msgs_dtype=jdt, interpret=True)
    tplan = tfast.build_bucketed_segreduce_plan(src, dst, w, n_out, n_src, n_buckets, device="cpu")
    out = tfast.gather_segreduce_bucketed(torch.from_numpy(x), tplan, tdt)
    assert out.dtype == torch.float32 and out.shape == (n_out, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_buckets", BUCKETS)
def test_bucketed_plan_holds_jax_buckets(small, n_buckets):
    """JAX's equal source ranges, and in each bucket JAX's real (unpadded)
    arcs with local source ids, in JAX's order; no padding chunks."""
    src, dst, w, n_out, n_src = _edge_arcs()
    jplan = jfast.build_bucketed_segreduce_plan(src, dst, w, n_out, n_src, n_buckets=n_buckets)
    tplan = tfast.build_bucketed_segreduce_plan(src, dst, w, n_out, n_src, n_buckets, device="cpu")
    assert tplan.spans == jplan.spans and tplan.n_out == jplan.n_out == n_out
    assert len(tplan.buckets) == n_buckets
    for (lo, hi), tp, jp in zip(tplan.spans, tplan.buckets, jplan.buckets):
        gw = np.asarray(jp.gw)
        real = gw != 0
        np.testing.assert_array_equal(tp.src.numpy(), np.asarray(jp.gidx)[real])
        np.testing.assert_array_equal(tp.w.numpy(), gw[real])
        m = (src >= lo) & (src < hi)
        np.testing.assert_array_equal(tp.dst.numpy(), dst[m])
        assert tp.src.numel() == 0 or 0 <= int(tp.src.min()) and int(tp.src.max()) < hi - lo
        assert tp.chunk_ptr[-1] == int(m.sum())
    assert sum(int(m.src.numel()) for m in tplan.buckets) == len(src)
    if n_buckets >= 8:  # the last bucket holds only the hub's arcs
        assert set(tplan.buckets[-1].dst.tolist()) == {HUB_ITEM}


@pytest.mark.parametrize("n_buckets", [1, 4, 64, 1000])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_bucketed_equals_unbucketed(n_buckets, mode):
    """Against the unbucketed reduce (2e-5): more buckets than source rows
    (empty ranges, lo == hi), a range with no arc, the hub row; an output
    row that no bucket reaches stays zero."""
    src, dst, w, n_out, n_src = _edge_arcs()
    tdt = DTYPES[mode][1]
    x = torch.from_numpy(normal(1, (n_src, 12)))
    ref = tfast.gather_segreduce(x, tfast.build_segreduce_plan(src, dst, w, n_out, device="cpu"), tdt)
    plan = tfast.build_bucketed_segreduce_plan(src, dst, w, n_out + 3, n_src, n_buckets, device="cpu")
    if n_buckets > n_src:
        assert any(lo == hi for lo, hi in plan.spans)
    out = tfast.gather_segreduce_bucketed(x, plan, tdt)
    np.testing.assert_allclose(out[:n_out].numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    assert not out[n_out:].any()


@pytest.mark.parametrize("n_buckets", BUCKETS)
@pytest.mark.parametrize("layout", ["float32", "bf16 padded"])
def test_accumulate_order_on_packed_buckets(small, n_buckets, layout):
    """K1's accumulate mode over the packed bucket plans, in the kernel's
    order (``_kernel_order`` with ``prev``): each bucket's pass writes every
    row once, adds each row that has arcs in the bucket onto what the last
    pass left and leaves every other row's bits as they were; chained, the
    passes give the plain bucketed result (2e-5)."""
    from test_torch_spmm_fast import _geometry, _kernel_order

    src, dst, w, n_out, n_src = _ui(small[3])
    plan = tfast.build_bucketed_segreduce_plan(src, dst, w, n_out, n_src, n_buckets, device="cpu")
    assert any(p.n_packed for p in plan.buckets)  # 60 items: 8-50 arcs a bucket
    x = torch.from_numpy(normal(4, (n_src, 12)))
    table = x if layout == "float32" else tfast.bf16_rows(x)
    acc = np.zeros((n_out, 12), np.float32)
    for (lo, hi), p in zip(plan.spans, plan.buckets):
        sub = table[lo:hi]
        wp = p if sub.dtype == torch.float32 else dataclasses.replace(p, w=p.w.to(torch.bfloat16).float())
        got = _kernel_order(sub.float().numpy(), wp, *_geometry(sub), prev=acc)
        empty = p.row_chunks.numpy() == 0
        np.testing.assert_array_equal(got[empty].view(np.int32), acc[empty].view(np.int32))
        sums = tfast.segreduce_plain(sub, p).numpy()
        np.testing.assert_allclose(got[~empty], acc[~empty] + sums[~empty], rtol=1e-5, atol=1e-5)
        acc = got
    ref = tfast.gather_segreduce_bucketed(x, plan, table.dtype).numpy()
    np.testing.assert_allclose(acc, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_segreduce_plain_prev_is_prev_plus_sums(small, mode):
    """The accumulate mode's plain version: ``prev + segreduce_plain()``
    exactly; ``prev`` itself is left alone."""
    src, dst, w, n_out, n_src = _ui(small[3])
    tdt = DTYPES[mode][1]
    plan = tfast.build_segreduce_plan(src, dst, w, n_out, ch=16, device="cpu")
    table = torch.from_numpy(normal(2, (n_src, 10))).to(tdt)
    prev = torch.from_numpy(normal(3, (n_out, 10)))
    keep = prev.clone()
    out = tfast.segreduce_plain(table, plan, prev)
    assert torch.equal(out, prev + tfast.segreduce_plain(table, plan))
    assert torch.equal(prev, keep)


def test_fast_to_items_bucketed_forward_and_gradient_match_jax(small):
    """``build_fast_ops(src_buckets=4)``: the forward against JAX's and its
    gradient (still the ELL ``to_users``) against ``jax.grad``, 2e-5."""
    _, _, jsplit, tsplit = small
    jf = jbip.build_fast_ops(jsplit, src_buckets=4)
    tf = tbip.build_fast_ops(tsplit, src_buckets=4, device="cpu")
    assert isinstance(tf.items_plan, tfast.BucketedSegReducePlan) and len(tf.items_plan.buckets) == 4
    x = normal(6, (tsplit.n_users, 16))
    g = normal(7, (tsplit.n_items, 16))
    ref = jbip.fast_to_items(jnp.asarray(x), jf)
    jgrad = jax.grad(lambda x_: jnp.vdot(jbip.fast_to_items(x_, jf), jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tbip.fast_to_items(xt, tf)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        grad.numpy(), tbip.to_users(torch.from_numpy(g), tsplit).numpy(), rtol=2e-5, atol=2e-5
    )


def test_bucketed_hybrid_bf16_forward_matches_jax(small):
    """bf16 messages, a 32-user bf16 head and 4 buckets: both packages'
    fast forwards within 3e-2 of max|ref| of the f32 layered-equivalent
    forward (``tests/test_spmm_fast.py``'s bound), and of each other."""
    jgraph, tgraph, jsplit, tsplit = small
    kw = dict(msgs_dtype="bfloat16", heavy_users=32, heavy_dtype="bfloat16", src_buckets=4)
    jf = jbip.build_fast_ops(jsplit, **kw)
    tf = tbip.build_fast_ops(tsplit, **kw, device="cpu")
    cfg = JaxConfig(num_nodes=jgraph.num_nodes, embedding_dim=12, num_layers=3)
    emb = np.array(jax_init_params(jax.random.key(1), cfg)["embedding"])
    j_op = jbip.build_item_operator(jsplit)
    jref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)},
                                              jbip.FastBipartite(jsplit, j_op), 3))
    jout = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)},
                                              jbip.FastBipartite(jsplit, j_op, jf), 3))
    t_op = tbip.build_item_operator(tsplit, device="cpu")
    out = tbip.fast_get_embedding({"embedding": torch.from_numpy(emb)},
                                  tbip.FastBipartite(tsplit, t_op, tf), 3).numpy()
    scale = np.abs(jref).max()
    assert np.abs(out - jref).max() / scale < 3e-2
    assert np.abs(out - jout).max() / scale < 3e-2


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_build_fast_bipartite_src_buckets_matches_jax(small, mode):
    """``build_fast_bipartite(..., fast_ops=True, src_buckets=4)`` forward
    against JAX's: f32 at 2e-5 relative to max|ref|; bf16 (B_ii, messages,
    a 32-user head) at 3e-2 of max|ref|."""
    jgraph, tgraph, _, _ = small
    jdt, tdt = DTYPES[mode]
    kw = dict(fast_ops=True, msgs_dtype=mode, heavy_users=32 if mode == "bfloat16" else 0,
              heavy_dtype=mode, src_buckets=4)
    jfb = jbip.build_fast_bipartite(jgraph, dtype=jdt, **kw)
    tfb = tbip.build_fast_bipartite(tgraph, dtype=tdt, device="cpu", **kw)
    assert len(tfb.fops.items_plan.buckets) == len(jfb.fops.items_plan.buckets) == 4
    emb = normal(8, (jgraph.num_nodes, 8)) * 0.1
    ref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)}, jfb, 3))
    out = tbip.fast_get_embedding({"embedding": torch.from_numpy(emb)}, tfb, 3).numpy()
    scale = np.abs(ref).max()
    tol = 2e-5 if mode == "float32" else 3e-2
    assert np.abs(out - ref).max() / scale < tol
