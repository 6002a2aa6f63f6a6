"""The port's SpMM pair (gnn_ecommerce_tpu_torch/ops/spmm_fast.py) against
the JAX package's, on the same arcs: the segment reduce against the Pallas
kernel in interpret mode, the ELL, and fast_to_items / fast_to_users with
and without the heavy-user head. The port runs on the CPU, where the CUDA
kernel's wrapper takes its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.ops import spmm_fast as jfast
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.ops import spmm_fast as tfast
from gnn_ecommerce_tpu_torch.ops._kernels import SEGREDUCE
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def small():
    jgraph, tgraph = graphs(*small_arcs())
    return jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _ui_arcs(split):
    return split.ui_src_user, split.ui_dst_item, split.ui_w, split.n_items


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_gather_segreduce_matches_pallas(small, mode):
    jsplit, tsplit = small
    jdt, tdt = DTYPES[mode]
    x = normal(0, (tsplit.n_users, 16))
    jplan = jfast.build_segreduce_plan(*[np.asarray(a) for a in _ui_arcs(jsplit)[:3]], jsplit.n_items)
    ref = jfast.gather_segreduce(jnp.asarray(x), jplan, msgs_dtype=jdt, interpret=True)
    tplan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), device="cpu")
    out = tfast.gather_segreduce(torch.from_numpy(x), tplan, msgs_dtype=tdt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ch", [1, 4, 256])
def test_segreduce_plan_chunks_cover_rows(small, ch):
    """The chunk layout the kernel walks: chunks never cross a row, hold at
    most ``ch`` arcs, cover every arc once, and the kernel's two-pass sum
    over them (chunk partials, then each row's partials in order) equals
    the plain version."""
    _, tsplit = small
    plan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), ch=ch, device="cpu")
    cp = plan.chunk_ptr.numpy()
    rcp = plan.row_chunk_ptr.numpy()
    dst = plan.dst.numpy()
    sizes = np.diff(cp)
    assert cp[0] == 0 and cp[-1] == len(dst)
    assert (sizes >= 1).all() and (sizes <= ch).all()
    assert rcp[-1] == plan.n_chunks
    for r in range(plan.n_out):
        for c in range(rcp[r], rcp[r + 1]):
            assert (dst[cp[c] : cp[c + 1]] == r).all()
    x = normal(1, (tsplit.n_users, 8))
    msgs = (x[plan.src.numpy()] * plan.w.numpy()[:, None]).astype(np.float32)
    partial = np.stack([msgs[cp[c] : cp[c + 1]].sum(0) for c in range(plan.n_chunks)])
    two_pass = np.stack([partial[rcp[r] : rcp[r + 1]].sum(0) for r in range(plan.n_out)])
    plain = tfast.segreduce_plain(torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(two_pass, plain, rtol=1e-5, atol=1e-6)


def test_segreduce_kernel_wrapper_refuses_cpu_tensors(small):
    _, tsplit = small
    plan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), device="cpu")
    before = dict(SEGREDUCE.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SEGREDUCE(torch.zeros(tsplit.n_users, 4), plan)
    assert SEGREDUCE.launches == before


@pytest.mark.parametrize("gather", ["float32", "bfloat16"])
def test_ell_apply_matches_jax(small, gather):
    jsplit, tsplit = small
    jdt, tdt = DTYPES[gather]
    jplan = jfast.build_ell_plan(
        np.asarray(jsplit.iu_indptr), np.asarray(jsplit.iu_src_item),
        np.asarray(jsplit.iu_w), jsplit.n_users,
    )
    tplan = tfast.build_ell_plan(
        tsplit.iu_indptr, tsplit.iu_src_item, tsplit.iu_w, tsplit.n_users, device="cpu"
    )
    assert tplan.widths == jplan.widths
    x = normal(2, (tsplit.n_items, 16))
    ref = jfast.ell_apply(
        jnp.asarray(x), jplan, gather_dtype=None if gather == "float32" else jdt
    )
    out = tfast.ell_apply(
        torch.from_numpy(x), tplan, gather_dtype=None if gather == "float32" else tdt
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "mode,heavy", [("float32", 0), ("float32", 50), ("bfloat16", 0), ("bfloat16", 50)]
)
def test_fast_pair_matches_jax(small, mode, heavy):
    jsplit, tsplit = small
    jfops = jbip.build_fast_ops(jsplit, msgs_dtype=mode, heavy_users=heavy, heavy_dtype=mode)
    tfops = tbip.build_fast_ops(
        tsplit, msgs_dtype=mode, heavy_users=heavy, heavy_dtype=mode, device="cpu"
    )
    assert (tfops.w_hi is None) == (heavy == 0)
    x = normal(3, (tsplit.n_users, 16))
    np.testing.assert_allclose(
        tbip.fast_to_items(torch.from_numpy(x), tfops).numpy(),
        np.asarray(jbip.fast_to_items(jnp.asarray(x), jfops)),
        rtol=2e-5, atol=2e-5,
    )
    y = normal(4, (tsplit.n_items, 16))
    np.testing.assert_allclose(
        tbip.fast_to_users(torch.from_numpy(y), tfops).numpy(),
        np.asarray(jbip.fast_to_users(jnp.asarray(y), jfops)),
        rtol=2e-5, atol=2e-5,
    )


def test_fast_pair_matches_segment_sum(small):
    """Exact f32 pair against the JAX package's plain segment-sum SpMMs."""
    jsplit, tsplit = small
    tfops = tbip.build_fast_ops(tsplit, heavy_users=50, device="cpu")
    x = normal(5, (tsplit.n_users, 12))
    np.testing.assert_allclose(
        tbip.fast_to_items(torch.from_numpy(x), tfops).numpy(),
        np.asarray(jbip.to_items(jnp.asarray(x), jsplit)),
        rtol=2e-5, atol=2e-5,
    )
    y = normal(6, (tsplit.n_items, 12))
    np.testing.assert_allclose(
        tbip.fast_to_users(torch.from_numpy(y), tfops).numpy(),
        np.asarray(jbip.to_users(jnp.asarray(y), jsplit)),
        rtol=2e-5, atol=2e-5,
    )
