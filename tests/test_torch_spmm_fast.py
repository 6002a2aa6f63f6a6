"""The port's SpMM pair (gnn_ecommerce_tpu_torch/ops/spmm_fast.py) against
the JAX package's, on the same arcs: the segment reduce against the Pallas
kernel in interpret mode, the ELL, and fast_to_items / fast_to_users with
and without the heavy-user head. The port runs on the CPU, where the CUDA
kernel's wrapper takes its plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.ops import spmm_fast as jfast
from gnn_ecommerce_tpu_torch.device import aligned_len
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


def _chunk_rows(plan) -> list:
    """Each chunk's rows: the dst values of its arcs, ascending, once each."""
    cp, dst = plan.chunk_ptr.numpy(), plan.dst.numpy()
    return [np.unique(dst[cp[c] : cp[c + 1]]) for c in range(plan.n_chunks)]


def _users_side_arcs(seed: int = 11, n_out: int = 700, n_src: int = 60, hub: int = 1500):
    """Arcs shaped like a users-side plan: rows of 1-12 arcs from a small
    item table, a tenth of the rows empty, and one hub row."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 13, n_out) * (rng.random(n_out) >= 0.1)
    sizes[n_out // 3] = hub
    dst = np.repeat(np.arange(n_out), sizes)
    src = rng.integers(0, n_src, len(dst)).astype(np.int32)
    w = (rng.random(len(dst)) + 0.05).astype(np.float32)
    return src, dst, w, n_out, n_src


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_gather_segreduce_short_rows_matches_pallas(mode):
    """A users-side-shaped plan (packed chunks of short rows, empty rows,
    a hub of several chunks) against the Pallas kernel in interpret mode,
    2e-5 as the items-side case."""
    src, dst, w, n_out, n_src = _users_side_arcs()
    jdt, tdt = DTYPES[mode]
    x = normal(12, (n_src, 16))
    jplan = jfast.build_segreduce_plan(src, dst, w, n_out)
    ref = jfast.gather_segreduce(jnp.asarray(x), jplan, msgs_dtype=jdt, interpret=True)
    tplan = tfast.build_segreduce_plan(src, dst, w, n_out, device="cpu")
    assert tplan.n_packed >= 10 and tplan.n_partial >= 2
    out = tfast.gather_segreduce(torch.from_numpy(x), tplan, msgs_dtype=tdt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert not out[torch.from_numpy(np.bincount(dst, minlength=n_out) == 0)].any()


@pytest.mark.parametrize("ch", [1, 4, 256])
def test_segreduce_plan_chunks_cover_rows(small, ch):
    """The chunk layout the kernel walks, on the small graph's to_items arcs
    and its users-side arcs (rows of a few arcs): chunks hold at most
    ``ch`` arcs and cover every arc once; a chunk that crosses a row holds
    only whole rows of at most SHORT_ROW_ARCS arcs (a packed chunk), any
    other row lies in ``row_chunks`` chunks of its own; and the kernel's
    two-pass sum over them (chunk sums by row, then each row's partials in
    order) equals the plain version."""
    _, tsplit = small
    users_side = (tsplit.iu_src_item, tsplit.iu_dst_user, tsplit.iu_w, tsplit.n_users)
    for arcs, n_src in ((_ui_arcs(tsplit), tsplit.n_users), (users_side, tsplit.n_items)):
        plan = tfast.build_segreduce_plan(*arcs, ch=ch, device="cpu")
        cp = plan.chunk_ptr.numpy()
        dst = plan.dst.numpy()
        cnt = np.bincount(dst, minlength=plan.n_out)
        sizes = np.diff(cp)
        assert cp[0] == 0 and cp[-1] == len(dst)
        assert (sizes >= 1).all() and (sizes <= ch).all()
        holders = np.zeros(plan.n_out, np.int64)
        for rows in _chunk_rows(plan):
            holders[rows] += 1
            if len(rows) > 1:
                assert (cnt[rows] <= min(tfast.SHORT_ROW_ARCS, ch)).all()
        np.testing.assert_array_equal(holders, plan.row_chunks.numpy())
        assert plan.n_packed == sum(len(rows) > 1 for rows in _chunk_rows(plan))
        x = normal(1, (n_src, 8))
        msgs = (x[plan.src.numpy()] * plan.w.numpy()[:, None]).astype(np.float32)
        two_pass = np.zeros((plan.n_out, 8), np.float32)
        for c in range(plan.n_chunks):
            np.add.at(two_pass, dst[cp[c] : cp[c + 1]], msgs[cp[c] : cp[c + 1]])
        plain = tfast.segreduce_plain(torch.from_numpy(x), plan).numpy()
        np.testing.assert_allclose(two_pass, plain, rtol=1e-5, atol=1e-6)
    if ch == 256:  # the users-side rows (about 7 arcs) are packed
        assert plan.n_packed >= 1


def _short_runs(rng: np.random.Generator, ch: int) -> list:
    """Row sizes of runs of short rows, each run between two long rows:
    rows of 1-12 arcs (at most the shortness limit) with empty rows inside,
    a run of exactly ch arcs and one of ch + 1 (rows of the limit's length,
    so that ch arcs fill one packed chunk where PACKED_ROWS such rows
    hold them)."""
    lim = min(tfast.SHORT_ROW_ARCS, ch)
    long = [lim + 1]

    def run(total):
        return [lim] * (total // lim) + [total % lim] * (total % lim > 0)

    mixed = [int(n) for n in rng.integers(1, min(12, lim) + 1, 60)]
    for at in (5, 6, 30, 59):  # two empty rows in a row, then single ones
        mixed.insert(at, 0)
    return long + mixed + long + run(ch) + long + run(ch + 1) + long


def _edge_plan(seed: int, ch: int, n_src: int = 50, short_runs: bool = False):
    """A plan with empty rows (first, middle, last), one arc, exactly ch and
    ch + 1 arcs, a hub of 40 chunks and random rows; with ``short_runs``
    also :func:`_short_runs`' runs of short rows."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[0, 1, ch, ch + 1, 0, 40 * ch + 3], rng.integers(0, 3 * ch + 2, 30), [0]])
    if short_runs:
        sizes = np.concatenate([sizes[:-1], _short_runs(rng, ch), [0]])
    dst = np.repeat(np.arange(len(sizes)), sizes)
    src = rng.integers(0, n_src, len(dst))
    w = rng.random(len(dst)).astype(np.float32)
    return tfast.build_segreduce_plan(src, dst, w, len(sizes), ch=ch, device="cpu")


@pytest.mark.parametrize("short_runs", [False, True], ids=["rows", "short_rows"])
@pytest.mark.parametrize("ch", [1, 4, 32, 256])
def test_segreduce_plan_output_slots(ch, short_runs):
    """chunk_slot, comb_rows and comb_ptr against chunk_ptr and row_chunks:
    a chunk of whole rows (a row's only chunk, or a packed run of short
    rows) writes them itself and names its first (a packed chunk as n_out +
    its first); each packed row lies in exactly one chunk; comb_rows are exactly the rows with no chunk or
    several, those of more than LONG_ROW_CHUNKS chunks first; their partial
    rows follow comb_rows' order, and a row's chunks take its consecutive
    partial rows in chunk order; every output row is written once."""
    plan = _edge_plan(ch, ch, short_runs=short_runs)
    per_row = plan.row_chunks.numpy()
    cnt = np.bincount(plan.dst.numpy(), minlength=plan.n_out)
    slot = plan.chunk_slot.numpy()
    rows_of = _chunk_rows(plan)
    comb_rows, comb_ptr = plan.comb_rows.numpy(), plan.comb_ptr.numpy()
    assert per_row.max() >= 41 and (per_row == 0).sum() >= 3
    long_rows = np.flatnonzero(per_row > tfast.LONG_ROW_CHUNKS)
    assert plan.n_long == len(long_rows) >= 1
    np.testing.assert_array_equal(
        comb_rows, np.concatenate([long_rows, np.flatnonzero((per_row != 1) & (per_row <= tfast.LONG_ROW_CHUNKS))])
    )
    np.testing.assert_array_equal(np.diff(comb_ptr), per_row[comb_rows])
    assert comb_ptr[0] == 0 and comb_ptr[-1] == plan.n_partial == per_row[per_row > 1].sum()
    for k, r in enumerate(comb_rows):
        chunks = [c for c, rows in enumerate(rows_of) if r in rows]
        np.testing.assert_array_equal(-1 - slot[chunks], np.arange(comb_ptr[k], comb_ptr[k + 1]))
    whole = np.flatnonzero(slot >= 0)
    np.testing.assert_array_equal(
        slot[whole], [rows_of[c][0] + plan.n_out * (len(rows_of[c]) > 1) for c in whole]
    )
    packed = [rows_of[c] for c in whole if len(rows_of[c]) > 1]
    assert plan.n_packed == len(packed)
    np.testing.assert_array_equal(plan.packed.numpy(), [c for c in whole if len(rows_of[c]) > 1])

    written = np.concatenate([np.concatenate([rows_of[c] for c in whole]), comb_rows])
    np.testing.assert_array_equal(np.sort(written), np.arange(plan.n_out))
    if short_runs:
        lim = min(tfast.SHORT_ROW_ARCS, ch)
        assert packed or lim == 1  # rows of one arc each pack only one to a chunk of 1
        for rows in packed:
            assert (cnt[rows] <= lim).all() and cnt[rows].sum() <= ch
            assert rows[-1] - rows[0] < tfast.PACKED_ROWS
        # The run of exactly ch arcs fills one packed chunk (ch + 1 needs two).
        if 1 < lim and ch <= lim * tfast.PACKED_ROWS:
            assert any(cnt[rows].sum() == ch for rows in packed)


def _geometry(table: torch.Tensor) -> tuple:
    """(elements a lane reads, 16-byte vectors of a row's covering span), as
    csrc/segreduce.cu derives them from the rows' alignment."""
    elt = table.element_size()
    bits = table.data_ptr() | table.stride(0) * elt | 16
    align = bits & -bits
    return SEGREDUCE.vector_width(table), (16 - align + table.shape[1] * elt + 15) // 16


def _kernel_order(x: np.ndarray, plan, vec: int, nv16: int, prev: np.ndarray | None = None) -> np.ndarray:
    """csrc/segreduce.cu's sums in its fixed order, in f32 numpy. In a
    chunk, a copy step carries ``rows`` arcs and lane group g sums rows g,
    g + groups, ... of each step, so arc k (counted from its 256-arc index
    window) goes to group (k % rows) % groups; each group sums a row's arcs
    in order and the groups are added in order. A row's only chunk is its
    output. A packed chunk (chunk_slot n_out + its first row) has one
    group: each of its rows is its arcs' products added in order, written
    where the row ends. The combine gives each of the first n_long comb
    rows a block, whose warp g adds partials g, g+8, ... before the 8 warp
    sums are added in order; each other comb row's warp adds its partials
    in order. With ``prev`` (accumulate mode) each written row is
    ``prev[row] + sum`` and a row with no arc keeps ``prev[row]``. Every
    output row is written exactly once."""
    d = x.shape[1]
    n_cv = -(-d // vec)
    rows = 32 // nv16 if nv16 <= 32 else 1
    groups = 32 // n_cv if n_cv <= 32 else 1
    src, w, cp, dst = plan.src.numpy(), plan.w.numpy(), plan.chunk_ptr.numpy(), plan.dst.numpy()
    out = np.full((plan.n_out, d), np.nan, np.float32)
    partial = np.full((plan.n_partial, d), np.nan, np.float32)
    written = np.zeros(plan.n_out, bool)

    def write(r, total):
        assert not written[r], f"row {r} written twice"
        written[r] = True
        out[r] = total if prev is None else prev[r] + total

    for c, dest in enumerate(plan.chunk_slot.numpy()):
        if dest >= plan.n_out:
            for r in np.unique(dst[cp[c] : cp[c + 1]]):
                acc = np.zeros(d, np.float32)
                for a in range(cp[c], cp[c + 1]):
                    if dst[a] == r:
                        acc = acc + w[a] * x[src[a]]
                write(r, acc)
            continue
        acc = np.zeros((groups, d), np.float32)
        for k in range(cp[c + 1] - cp[c]):
            a = cp[c] + k
            acc[k % 256 % rows % groups] += w[a] * x[src[a]]
        total = acc[0]
        for g in range(1, groups):
            total = total + acc[g]
        if dest >= 0:
            write(dest, total)
        else:
            partial[-1 - dest] = total
    comb_ptr = plan.comb_ptr.numpy()
    for b, r in enumerate(plan.comb_rows.numpy()):
        lo, hi = comb_ptr[b], comb_ptr[b + 1]
        n_warps = 8 if b < plan.n_long else 1
        warps = [np.zeros(d, np.float32) for _ in range(n_warps)]
        for g in range(n_warps):
            for p in range(lo + g, hi, n_warps):
                warps[g] = warps[g] + partial[p]
        total = warps[0]
        for g in range(1, n_warps):
            total = total + warps[g]
        if prev is not None and lo == hi:  # no arc: prev stays
            assert not written[r]
            written[r] = True
            out[r] = prev[r]
        else:
            write(r, total)
    assert written.all()
    return out


@pytest.mark.parametrize("short_runs", [False, True], ids=["rows", "short_rows"])
@pytest.mark.parametrize(
    "ch,d,layout",
    [
        (256, 90, "float32"),  # the service's rows: 23 vectors a copy, 45 float2 a sum
        (300, 33, "float32"),  # two index windows a chunk
        (256, 90, "bf16 padded"),  # the main path: two 192-byte rows a copy and a sum
        (32, 90, "bfloat16"),  # 180-byte rows: two a copy, bf16 pairs
        (4, 20, "bf16 padded"),  # 3 vectors a row: 10 rows a step
        (32, 1, "bf16 padded"),  # one vector a row: 32 rows a step
    ],
)
def test_segreduce_kernel_order_matches_plain(ch, d, layout, short_runs):
    """The kernel's summation order over the plan (every row written once,
    empty rows zero) gives the plain version's sums within f32 rounding,
    on plans with and without runs of short rows (packed chunks)."""
    plan = _edge_plan(7, ch, short_runs=short_runs)
    x = torch.from_numpy(normal(8, (50, d)))
    table = {"float32": x, "bfloat16": x.to(torch.bfloat16), "bf16 padded": tfast.bf16_rows(x)}[layout]
    plain = tfast.segreduce_plain(table, plan).numpy()
    if table.dtype == torch.bfloat16:
        plan = dataclasses.replace(plan, w=plan.w.to(torch.bfloat16).float())
    got = _kernel_order(table.float().numpy(), plan, *_geometry(table))
    assert not np.isnan(got).any()
    empty = plan.row_chunks.numpy() == 0
    assert (got[empty] == 0).all()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("d", [1, 8, 90, 256])
def test_bf16_rows_pads_to_16_byte_rows(d):
    """The padded cast's [n, D] view: a row stride of a multiple of 16 bytes
    (``device.aligned_len``, the chain's ``padded_cols`` in bf16), the
    values of ``table.to(bfloat16)``, zero pad columns; the kernel loads it
    16 bytes a lane."""
    x = torch.from_numpy(normal(9, (37, d)))
    got = tfast.bf16_rows(x)
    width = aligned_len(d, torch.bfloat16)
    assert width == tbip.padded_cols(d, torch.bfloat16)
    assert got.shape == (37, d) and got.stride() == (width, 1) and width * 2 % 16 == 0
    assert width - d < 8
    assert torch.equal(got, x.to(torch.bfloat16))
    assert not got.as_strided((37, width), (width, 1))[:, d:].any()
    assert SEGREDUCE.vector_width(got) == 8


def test_segreduce_vector_width_follows_the_layout():
    """16-byte reads only on bf16 rows that all start 16-byte aligned (a
    stride of a multiple of 8); pairs on rows at an even stride; else 1."""
    f32 = torch.zeros(10, 90)
    assert SEGREDUCE.vector_width(f32) == 2
    assert SEGREDUCE.vector_width(torch.zeros(10, 33)) == 1
    assert SEGREDUCE.vector_width(f32.to(torch.bfloat16)) == 2
    assert SEGREDUCE.vector_width(torch.zeros(10, 64, dtype=torch.bfloat16)) == 8
    assert SEGREDUCE.vector_width(torch.zeros(10, 96, dtype=torch.bfloat16)[:, :90]) == 8
    assert SEGREDUCE.vector_width(torch.zeros(10 * 96 + 1, dtype=torch.bfloat16)[1:].view(10, 96)) == 1
    assert SEGREDUCE.vector_width(torch.zeros(10 * 96 + 2, dtype=torch.bfloat16)[2:].view(10, 96)) == 2


def test_segreduce_check_layout_refuses_what_the_kernel_does_not_take(small):
    _, tsplit = small
    plan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), device="cpu")
    n = tsplit.n_users
    assert SEGREDUCE.check_layout(torch.zeros(n, 90), plan) == 2
    for bad in (
        torch.zeros(90, n).T,  # columns not contiguous
        torch.zeros(n, 0),
        torch.zeros(n, 257),
        torch.zeros(plan.n_src - 1, 8),
        torch.zeros(n * 8).as_strided((n, 8), (4, 1)),  # rows overlap
    ):
        with pytest.raises(ValueError):
            SEGREDUCE.check_layout(bad, plan)


def test_segreduce_kernel_wrapper_refuses_cpu_tensors(small):
    _, tsplit = small
    plan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), device="cpu")
    before = dict(SEGREDUCE.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SEGREDUCE(torch.zeros(tsplit.n_users, 4), plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        SEGREDUCE.cast_bf16(torch.zeros(tsplit.n_users, 4), 8)
    assert SEGREDUCE.launches == before


_LAYOUTS = {
    "expanded row": lambda x: x[:1].expand(x.shape),  # strides (0, 1)
    "expanded scalar": lambda x: x[:1, :1].expand(x.shape),  # strides (0, 0), a broadcast gradient
    "transposed": lambda x: x.T.contiguous().T,
    "offset rows": lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape),  # 4-byte aligned
    "column slice": lambda x: torch.cat([x, x[:, :3]], 1)[:, : x.shape[1]],
}


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_gather_segreduce_takes_any_layout(small, layout, mode):
    """Every table layout reaches the kernel in one it takes (check_layout
    passes on segreduce_table's result), with the values of the dense table;
    gather_segreduce gives the dense table's bytes."""
    _, tsplit = small
    plan = tfast.build_segreduce_plan(*_ui_arcs(tsplit), device="cpu")
    dense = torch.from_numpy(normal(10, (tsplit.n_users, 9)))
    table = _LAYOUTS[layout](dense)
    dense = table.clone(memory_format=torch.contiguous_format)
    _, tdt = DTYPES[mode]
    got = tfast.segreduce_table(table, tdt)
    SEGREDUCE.check_layout(got, plan)
    assert torch.equal(got, tfast.segreduce_table(dense, tdt))
    assert torch.equal(
        tfast.gather_segreduce(table, plan, msgs_dtype=tdt),
        tfast.gather_segreduce(dense, plan, msgs_dtype=tdt),
    )


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
