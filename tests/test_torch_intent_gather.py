"""The CUDA intent gather-sum of DGCF's routing (``csrc/intent_gather.cu``,
``ops/routing.py:intent_gather``) and its wrapper.

On the CPU: the wrapper's refusals, checked before anything is built or
launched. On a card (skipped without one; ``python -m pytest
tests/test_torch_intent_gather.py --noconftest -q`` there, from the
repository's root): the kernel against its plain version at the DGCF cell's
graph (1,639,358 users × 54,571 items, 20.2M arcs, d 64, K 4) in both
directions (the routed product over the heads and, with each arc's weights
taken from its reverse arc, its transpose), bf16 and f32 rows; the same
bytes from two calls; one launch a call and the split rows counted; and a
routed forward and its gradient on a small graph against the CPU's. No
JAX here."""
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch import tracing
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models import dgcf
from gnn_ecommerce_tpu_torch.ops import routing
from gnn_ecommerce_tpu_torch.ops._kernels import INTENT_GATHER

torch.set_num_threads(1)

U = 2.0**-24  # f32's unit roundoff


def _plan():
    indptr = np.array([0, 2, 5])
    return routing.build_intent_plan(indptr, torch.zeros(5, dtype=torch.int32))


@pytest.mark.parametrize("case,match", [
    ("cpu_table", "CUDA"), ("bad_dtype", "f32 or bf16"), ("weights_shape", "weights"),
    ("chunk_width", "multiple"), ("misaligned_rows", "16-byte"),
])
def test_wrapper_refuses_before_launching(case, match):
    """Each layout the kernel does not take is refused by the wrapper, ahead
    of the CUDA check, so these run on the CPU and build nothing."""
    plan = _plan()
    table, w = torch.zeros(4, 16), torch.zeros(5, 4)
    if case == "bad_dtype":
        table = table.double()
    elif case == "weights_shape":
        w = torch.zeros(4, 4)
    elif case == "chunk_width":
        w = torch.zeros(5, 8)  # 2 f32 columns an intent: less than a lane's 16 bytes
    elif case == "misaligned_rows":
        table = torch.zeros(4, 18)[:, :15]
        w = torch.zeros(5, 5)
    with pytest.raises((ValueError, TypeError), match=match):
        INTENT_GATHER(table, w, plan)
    assert INTENT_GATHER._lib is None


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the intent gather kernel runs only there")
    return torch.device("cuda", 0)


_CELL = {}


def _cell_graph(dev):
    """The DGCF cell's routing graph (seed 26), built once a process."""
    if "rg" not in _CELL:
        import json
        import os

        from benchmark import inputs

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        config = json.load(open(os.path.join(root, "benchmark", "configs", "dgcf-cosmetics-d64-k4.json")))
        (u, i, w), _ = inputs.graph_edges(config, 26, dev)
        g = config["graph"]
        _CELL["rg"] = routing.build_routing_graph(build_graph(u, i, w, g["n_users"], g["n_items"], device=dev))
    return _CELL["rg"]


@pytest.mark.parametrize("gather", [torch.bfloat16, None])
def test_kernel_matches_plain_at_the_cell_graph(gather):
    """Both directions, within the f32 summation bound of each row (the
    plain version's sums run in another order: split rows are added in
    blocked slices); two calls give the same bytes; one launch a call."""
    dev = _card()
    rg = _cell_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rg.n_nodes, 64, generator=gen, device=dev) * 0.1
    w = torch.rand(rg.n_arcs, 4, generator=gen, device=dev)
    rows = routing._rows(x, gather)
    mode = "bfloat16" if gather is not None else "float32"
    lens = (rg.indptr[1:] - rg.indptr[:-1])[:, None].float()
    for weights in (w, w.index_select(0, rg.rev)):
        before = INTENT_GATHER.launches[mode]
        got = routing.intent_gather(rows, weights, rg)
        again = routing.intent_gather(rows, weights, rg)
        assert INTENT_GATHER.launches[mode] - before == 2
        assert torch.equal(got, again)
        plain = routing.intent_gather_plain(rows, weights, rg)
        mag = routing.intent_gather_plain(rows.float().abs(), weights, rg)
        bound = 2 * (lens + 2) * U * mag
        assert bool(((got - plain).abs() <= bound).all()), float(((got - plain).abs() - bound).max())
        del got, again, plain, mag
    assert rg.plan.n_split_rows > 2000


def test_split_rows_counted_a_call():
    dev = _card()
    rg = _cell_graph(dev)
    x = torch.zeros(rg.n_nodes, 64, device=dev)
    w = torch.ones(rg.n_arcs, 4, device=dev)
    with tracing.recording():
        routing.intent_spmm(w, x, rg, torch.bfloat16)
        routing.intent_spmm(w, x, rg, torch.bfloat16)
    assert tracing.report()["counters"] == {"ops.intent_gather.split_rows": 2 * rg.plan.n_split_rows}


@pytest.mark.parametrize("gather", [torch.bfloat16, None])
def test_routed_step_matches_cpu(gather):
    """A routed forward, a BPR loss on it and its gradient on a small graph
    with hub rows (split at 256 arcs) on the card against the CPU's: f32
    rows to 1e-4 of the gradient's norm, bf16 rows within 2e-3 (each side
    rounds its rows). The cor term is left out: its distances' square roots
    at 1e-8 move its gradient by 1e-4 relative under a 1e-7 change of the
    rows, whatever computes them, where BPR's moves by 3e-7."""
    rng = np.random.default_rng(4)
    n_u, n_i = 3000, 40
    u = np.concatenate([rng.integers(0, n_u, 20000), np.arange(n_u)])
    i = np.concatenate([np.minimum(rng.zipf(1.3, 20000) - 1, n_i - 1), rng.integers(0, n_i, n_u)])
    key = np.unique(u * n_i + i)
    u, i = key // n_i, key % n_i
    table = torch.from_numpy(rng.standard_normal((n_u + n_i, 32)).astype(np.float32) * 0.1)
    users = torch.as_tensor(rng.integers(0, n_u, 256))
    pos, neg = (torch.as_tensor(rng.integers(0, n_i, 256) + n_u) for _ in range(2))
    out = []
    for device in ("cpu", _card()):
        rg = routing.build_routing_graph(build_graph(u, i, np.ones(len(u), np.float32), n_u, n_i, device=device))
        leaf = table.to(device).requires_grad_()
        final, _ = dgcf.dgcf_forward(leaf, rg, 4, 2, 1, gather)
        u_rows = final[users.to(device)]
        scores = (u_rows * final[pos.to(device)]).sum(-1) - (u_rows * final[neg.to(device)]).sum(-1)
        loss = -torch.nn.functional.logsigmoid(scores).mean()
        (grad,) = torch.autograd.grad(loss, [leaf])
        out.append((final.detach().cpu(), grad.cpu()))
        assert rg.plan.n_split_rows > 0
    (f_cpu, g_cpu), (f_card, g_card) = out
    tol = 2e-3 if gather is not None else 1e-4
    assert float((f_card - f_cpu).norm() / f_cpu.norm()) < tol
    assert float((g_card - g_cpu).norm() / g_cpu.norm()) < tol
