"""The ELL plan and the CUDA ELL gather of ``fast_to_users``
(``ops/spmm_fast.py``: ``build_ell_plan``, ``gather_ell``;
``csrc/ell_gather.cu``).

On the CPU: the plan's invariants (every output row in one bin, ``order``
the inverse of ``inv_order``, the flat buffers' views the native bins, the
kernel's work items widest first, each split row's segments covering its
arcs once and in order), the kernel's summation order emulated in numpy
against the dense product, the plain dispatch (``ell_apply``) against the
dense product, and the layouts the kernel is handed. On a card (skipped
without one): the kernel against its plain version and its numpy emulation,
bit for bit from call to call, ``fast_to_items``' backward against the
CPU's, and its launch and split-row counts. No JAX here: the JAX parity of
``ell_apply`` is ``test_torch_spmm_fast.py``'s."""
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch import native, tracing
from gnn_ecommerce_tpu_torch.device import aligned_len
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.ops import spmm_fast as tfast
from gnn_ecommerce_tpu_torch.ops._kernels import ELL_GATHER

torch.set_num_threads(1)

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
U = 2.0**-24  # f32's unit roundoff


def _hub_csr(seed: int = 5, n_out: int = 900, n_src: int = 70, hubs=(300, 700, 257)):
    """A CSR over ``n_out`` rows shaped like the users side: rows of 1-12
    arcs, a tenth of them empty (the first row too), and hub rows of
    ``hubs`` arcs (wider than ELL_SPLIT_ARCS unless it is raised), from a
    table of ``n_src`` rows; duplicate arcs allowed."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 13, n_out) * (rng.random(n_out) >= 0.1)
    deg[0] = 0
    for k, h in enumerate(hubs):
        deg[(k + 1) * n_out // (len(hubs) + 1)] = h
    indptr = np.append(0, np.cumsum(deg)).astype(np.int64)
    src = rng.integers(0, n_src, int(indptr[-1])).astype(np.int32)
    w = (rng.random(len(src)) + 0.05).astype(np.float32)
    return indptr, src, w, n_out, n_src


def _dense(indptr, src, w, n_out, n_src) -> np.ndarray:
    a = np.zeros((n_out, n_src))
    np.add.at(a, (np.repeat(np.arange(n_out), np.diff(indptr)), src), w.astype(np.float64))
    return a


def _table(seed: int, n: int, d: int, dtype) -> torch.Tensor:
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))
    return x if dtype is None else x.to(dtype).float()  # bf16 values, held in f32


def _work_items(plan) -> list:
    """The kernel's work items from ``plan.bins``, in item order: (width,
    first arc, arcs, destination), the destination ("out", bin row) or
    ("partial", q) as ``csrc/ell_gather.cu`` pass 1 reads them."""
    bins = plan.bins.numpy()
    ends = np.append(bins[1:, 0], plan.n_work)
    items = []
    for (first, row, width, arc, _), end in zip(bins, ends):
        nseg = -(-width // plan.split_arcs)
        for t in range(end - first):
            q = first + t
            if width > plan.split_arcs:
                r, s = divmod(t, nseg)
                a0 = arc + r * width + s * plan.split_arcs
                items.append((width, a0, min(plan.split_arcs, width - s * plan.split_arcs), ("partial", q)))
            else:
                items.append((width, arc + t * width, width, ("out", row + t)))
    return items


def _split_rows(plan) -> list:
    """Each split row as pass 2 reads it: (bin row, first partial row,
    segments)."""
    rows = []
    for first, row, width, _, _ in plan.bins.numpy():
        if width > plan.split_arcs:
            nseg = -(-width // plan.split_arcs)
            n_rows = plan.idx[plan.widths.index(width)].shape[0]
            rows += [(row + t, first + t * nseg, nseg) for t in range(n_rows)]
    return rows


def _emulate(x: np.ndarray, plan) -> np.ndarray:
    """The kernel's f32 arithmetic in its order: each item's arcs in arc
    order (a zero weight skipped), each product and each sum rounded to
    f32; split rows add their partial rows in segment order."""
    idx, w, order = plan.idx_flat.numpy(), plan.w_flat.numpy(), plan.order.numpy()
    out = np.full((plan.n_out, x.shape[1]), np.nan, np.float32)
    partial = np.zeros((plan.n_segments, x.shape[1]), np.float32)
    for _, a0, n, (kind, at) in _work_items(plan):
        acc = np.zeros(x.shape[1], np.float32)
        for a in range(a0, a0 + n):
            if w[a] != 0:
                acc = acc + w[a] * x[idx[a]]
        if kind == "out":
            out[order[at]] = acc
        else:
            partial[at] = acc
    for row, p0, nseg in _split_rows(plan):
        acc = np.zeros(x.shape[1], np.float32)
        for p in range(p0, p0 + nseg):
            acc = acc + partial[p]
        out[order[row]] = acc
    return out


def _order_bound(x_abs: np.ndarray, csr, plan) -> np.ndarray:
    """Twice the f32 error bound of a row's sum of its W arcs in any order,
    W the row's bin width: two summation orders differ by at most this."""
    width = np.zeros(plan.n_out)
    width[plan.order.numpy()] = np.repeat(plan.widths, [b.shape[0] for b in plan.idx])
    return 2 * width[:, None] * U * (_dense(*csr) @ x_abs.astype(np.float64)) + 1e-30


@pytest.mark.parametrize("split_arcs", [tfast.ELL_SPLIT_ARCS, 8])
def test_ell_plan_invariants(split_arcs, monkeypatch):
    csr = _hub_csr()
    indptr, src, w, n_out, _ = csr
    monkeypatch.setattr(tfast, "ELL_SPLIT_ARCS", split_arcs)
    plan = tfast.build_ell_plan(indptr, src, w, n_out, device="cpu")
    assert plan.split_arcs == split_arcs
    order, inv = plan.order.numpy(), plan.inv_order.numpy()
    # Every output row lies in exactly one bin; order inverts inv_order.
    assert sorted(order.tolist()) == list(range(n_out))
    np.testing.assert_array_equal(order[inv], np.arange(n_out))
    np.testing.assert_array_equal(inv[order], np.arange(n_out))
    assert sum(b.shape[0] for b in plan.idx) == n_out
    # The flat buffers' per-bin views are the native bins, one after the other.
    lo = arc = 0
    for ib, wb, W in zip(plan.idx, plan.w, plan.widths):
        rows = ib.shape[0]
        nib, nwb = native.ell_fill_bin(indptr, src, w, order[lo : lo + rows].astype(np.int64), W)
        np.testing.assert_array_equal(ib.numpy(), nib)
        np.testing.assert_array_equal(wb.numpy(), nwb)
        assert ib.untyped_storage().data_ptr() == plan.idx_flat.untyped_storage().data_ptr()
        assert ib.storage_offset() == arc and wb.storage_offset() == arc
        lo, arc = lo + rows, arc + rows * W
    assert arc == plan.idx_flat.numel() == plan.w_flat.numel()
    # The kernel's items: widest first; each unsplit row once, each split
    # row's segments its arcs once and in order, their partial rows
    # consecutive and first.
    items = _work_items(plan)
    assert len(items) == plan.n_work
    assert [it[0] for it in items] == sorted((it[0] for it in items), reverse=True)
    out_rows = [at for *_, (kind, at) in items if kind == "out"]
    split = _split_rows(plan)
    assert len(split) == plan.n_split_rows
    assert sorted(out_rows + [r for r, _, _ in split]) == list(range(n_out))
    by_q = {at: (a0, n) for _, a0, n, (kind, at) in items if kind == "partial"}
    assert sorted(by_q) == list(range(plan.n_segments))
    for row, p0, nseg in split:
        b = int(np.searchsorted(np.cumsum([x.shape[0] for x in plan.idx]), row, side="right"))
        W = plan.widths[b]
        start = sum(x.numel() for x in plan.idx[:b]) + (row - sum(x.shape[0] for x in plan.idx[:b])) * W
        arcs = [a for p in range(p0, p0 + nseg) for a in range(by_q[p][0], by_q[p][0] + by_q[p][1])]
        assert arcs == list(range(start, start + W))
        assert W > split_arcs and indptr[order[row] + 1] - indptr[order[row]] <= W
    hubs = int((np.diff(indptr) > split_arcs).sum())
    assert plan.n_split_rows >= hubs > 0
    # Pass 2 finds a split row's bin by the bins' first split rows.
    seen = 0
    for _, _, width, _, first_split in plan.bins.numpy():
        if width > split_arcs:
            assert first_split == seen
            seen += plan.idx[plan.widths.index(width)].shape[0]
        else:
            assert first_split == plan.n_split_rows
    assert seen == plan.n_split_rows


@pytest.mark.parametrize("gather", list(DTYPES))
@pytest.mark.parametrize("d", [64, 80, 90])
def test_ell_dispatch_and_kernel_order_match_dense(d, gather):
    """The plain dispatch is ell_apply; it and the kernel's order (numpy)
    equal the dense Â·x within two f32 summation bounds."""
    csr = _hub_csr(seed=d)
    indptr, src, w, n_out, n_src = csr
    plan = tfast.build_ell_plan(indptr, src, w, n_out, device="cpu")
    assert plan.n_split_rows == 3
    x = _table(d + 1, n_src, d, None)
    got = tfast.gather_ell(x, plan, DTYPES[gather])
    assert got.dtype == torch.float32 and got.shape == (n_out, d)
    assert torch.equal(got, tfast.ell_apply(x, plan, DTYPES[gather]))
    xv = x if gather == "float32" else x.to(torch.bfloat16).float()  # the values the messages carry
    ref = _dense(*csr) @ xv.double().numpy()
    bound = _order_bound(np.abs(xv.numpy()), csr, plan)
    assert (np.abs(got.numpy() - ref) <= bound).all()
    emu = _emulate(xv.numpy(), plan)
    assert (np.abs(emu - ref) <= bound).all()
    assert not emu[np.diff(indptr) == 0].any()  # rows with no arc: zeros


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "expanded", "offset", "padded"])
@pytest.mark.parametrize("gather", list(DTYPES))
@pytest.mark.parametrize("d", [64, 90])
def test_ell_table_layouts(d, gather, layout):
    """ell_table hands the kernel 16-byte rows holding the values ell_apply
    gathers, from any layout, and keeps a table it takes as it is."""
    base = _table(3, 50, d, None)
    table = {
        "contiguous": lambda: base,
        "transposed": lambda: base.T.contiguous().T,
        "expanded": lambda: base[:1].expand(50, d),
        "offset": lambda: torch.cat([torch.zeros(1), base.reshape(-1)])[1:].view(50, d),
        "padded": lambda: torch.nn.functional.pad(base, (0, -(-(d + 1) // 4) * 4 - d))[:, :d],
    }[layout]()
    got = tfast.ell_table(table, DTYPES[gather])
    assert ELL_GATHER.takes_rows(got)
    assert (got.stride(0) * got.element_size()) % 16 == 0 and got.stride(1) == 1
    want = table if gather == "float32" else table.to(torch.bfloat16)
    assert got.dtype == want.dtype and torch.equal(got, want)
    kept = layout == "padded" or (layout == "contiguous" and d % 4 == 0)
    assert (got.data_ptr() == table.data_ptr()) == (gather == "float32" and kept)
    if not kept or gather != "float32":  # a copy: rows of device.aligned_len
        assert got.stride(0) == aligned_len(d, got.dtype)


def test_ell_kernel_refuses_host_tensors():
    indptr, src, w, n_out, n_src = _hub_csr()
    plan = tfast.build_ell_plan(indptr, src, w, n_out, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ELL_GATHER(torch.zeros(n_src, 8), plan)


def test_ell_plan_of_no_rows():
    plan = tfast.build_ell_plan(np.zeros(1, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32), 0,
                                device="cpu")
    assert plan.n_work == plan.n_segments == plan.n_split_rows == 0 and plan.bins.shape == (0, 5)
    assert tfast.gather_ell(torch.zeros(3, 8), plan).shape == (0, 8)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ELL gather kernel runs only there")
    return torch.device("cuda", 0)


def _big_hub_csr():
    """The hub graph plus one hub of 20,480 arcs."""
    return _hub_csr(seed=9, n_out=1200, n_src=300, hubs=(300, 700, 257, 20_480))


@pytest.mark.parametrize("gather", list(DTYPES))
@pytest.mark.parametrize("d", [64, 80, 90])
def test_ell_kernel_matches_plain(d, gather):
    """The kernel equals its numpy emulation bit for bit, and its plain
    version within two f32 summation bounds (each row's arcs in another
    order); two calls give the same bytes."""
    dev = _card()
    csr = _big_hub_csr()
    indptr, src, w, n_out, n_src = csr
    cpu_plan = tfast.build_ell_plan(indptr, src, w, n_out, device="cpu")
    plan = tfast.build_ell_plan(indptr, src, w, n_out, device=dev)
    x = _table(d, n_src, d, None)
    got = tfast.gather_ell(x.to(dev), plan, DTYPES[gather])
    again = tfast.gather_ell(x.to(dev), plan, DTYPES[gather])
    assert torch.equal(got, again)
    xv = x if gather == "float32" else x.to(torch.bfloat16).float()
    np.testing.assert_array_equal(got.cpu().numpy(), _emulate(xv.numpy(), cpu_plan))
    plain = tfast.ell_apply(x, cpu_plan, DTYPES[gather]).numpy()
    bound = _order_bound(np.abs(xv.numpy()), csr, cpu_plan)
    assert (np.abs(got.cpu().numpy() - plain) <= bound).all()


@pytest.mark.parametrize("gather", list(DTYPES))
def test_ell_kernel_counts_launches_and_split_rows(gather):
    """One launch a call in the table's mode; ops.to_users.split_rows counts
    the split rows of each CUDA to_users call, none beside a heavy head."""
    dev = _card()
    indptr, src, w, n_out, n_src = _big_hub_csr()
    u = np.repeat(np.arange(n_out), np.diff(indptr))
    graph = build_graph(u, src.astype(np.int64), w, n_out, n_src, device=dev)
    split = tbip.split_graph(graph)
    mode = "bfloat16" if gather == "bfloat16" else "float32"
    x = torch.randn(n_src, 90, device=dev)
    for heavy, want in ((0, 4), (8, 0)):
        fops = tbip.build_fast_ops(split, mode, heavy_users=heavy, heavy_dtype=mode, device=dev)
        assert fops.users_ell.n_split_rows == want
        before = dict(ELL_GATHER.launches)
        with tracing.recording():
            tbip.fast_to_users(x, fops)
            tbip.fast_to_users(x, fops)
        rep = tracing.report()
        assert ELL_GATHER.launches[mode] - before[mode] == 2
        assert rep["counters"].get("ops.to_users.split_rows", 0) == 2 * want


@pytest.mark.parametrize("mode,heavy", [("float32", 0), ("bfloat16", 0), ("bfloat16", 8)])
def test_fast_to_items_backward_matches_cpu(mode, heavy):
    """fast_to_items' gradient (the ELL and the head) on the card against
    the CPU's: f32 to 1e-4, bf16 within test_gradients_match_jax_grad's
    2e-3 relative."""
    dev = _card()
    indptr, src, w, n_out, n_src = _big_hub_csr()
    u = np.repeat(np.arange(n_out), np.diff(indptr))
    grads = []
    for device in ("cpu", dev):
        graph = build_graph(u, src.astype(np.int64), w, n_out, n_src, device=device)
        fops = tbip.build_fast_ops(tbip.split_graph(graph), mode, heavy_users=heavy, heavy_dtype=mode,
                                   device=device)
        x = _table(1, n_out, 90, None).to(device).requires_grad_()
        g = _table(2, n_src, 90, None).to(device)
        tbip.fast_to_items(x, fops).backward(g)
        grads.append(x.grad.cpu())
    ref, got = grads
    if mode == "bfloat16":
        assert ((got - ref).norm() / ref.norm()).item() < 2e-3
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * ref.abs().max().item())
