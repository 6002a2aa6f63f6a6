"""The item chain over an f32 B_ii, applied as its two sparse factors
(``ops/bipartite.py``: ``item_product``, ``FactoredItemOp``), against the
dense chain (``item_chain_core`` over ``fb.item_op``): the forward, plan-less
and with plans, at odd and even depths; the training loss's gradient; the
counter ``ops.item_chain.factored``; and a bf16 B_ii left to its dense
GEMM. On a card (skipped without one; ``python -m pytest
tests/test_torch_item_chain_factored.py --noconftest -q`` there): a service
refresh's cache against the dense chain's. No JAX here: the JAX parity of the
f32 forward is ``test_torch_bipartite.py``'s."""
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch import tracing
from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit, PreparedData, SamplerArrays
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, uniform_alphas
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.serve import RecommenderService
from gnn_ecommerce_tpu_torch.train.step import make_loss_fn

torch.set_num_threads(1)

DIM = 12


def _arcs(seed: int = 3, n_u: int = 400, n_i: int = 70, e: int = 3000):
    """Distinct weighted (user, item) arcs, a purchase (weight 1) in five."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u, e) * n_i + rng.integers(0, n_i, e))
    u, i = key // n_i, key % n_i
    w = np.where(rng.random(len(u)) < 0.2, 1.0, rng.uniform(0.01, 0.5, len(u))).astype(np.float32)
    return u, i, w, n_u, n_i


def _fast_bipartite(form: str, device="cpu", dtype=torch.float32):
    u, i, w, n_u, n_i = _arcs()
    graph = build_graph(u, i, w, n_u, n_i, device=device)
    if form == "planless":
        return tbip.build_fast_bipartite(graph, dtype=dtype, device=device)
    mode = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return tbip.build_fast_bipartite(graph, dtype=dtype, fast_ops=True, msgs_dtype=mode,
                                     heavy_users=30 if form == "plans_head" else 0, heavy_dtype=mode,
                                     device=device)


def _table(n: int, seed: int = 0, device="cpu") -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"embedding": (torch.randn(n, DIM, generator=g) * 0.1).to(device)}


def _dense_embedding(params: dict, fb, layers: int) -> torch.Tensor:
    """``fast_get_embedding``'s result with the dense B_ii in the chain."""
    E = params["embedding"]
    alpha = uniform_alphas(layers, E.device)
    E_u, E_i = E[: fb.n_users], E[fb.n_users :]
    out_i, S_i = tbip.item_chain_core(E_u, E_i, fb.to_items, fb.item_op, layers, alpha)
    return torch.cat([alpha[0] * E_u + fb.to_users(S_i), out_i])


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    """Within ``rtol`` of the largest element: f32 sums in another order."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * want.abs().max().item())


@pytest.mark.parametrize("layers", [2, 4, 5])
@pytest.mark.parametrize("form", ["planless", "plans", "plans_head"])
def test_f32_forward_equals_the_dense_chain(form, layers):
    fb = _fast_bipartite(form)
    assert isinstance(tbip.item_product(fb), tbip.FactoredItemOp)
    params = _table(fb.n_users + fb.n_items)
    with torch.no_grad():
        got = tbip.fast_get_embedding(params, fb, layers)
        want = _dense_embedding(params, fb, layers)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("form", ["planless", "plans_head"])
def test_f32_training_gradient_equals_the_dense_chains(form, monkeypatch):
    """The first gradient of the fast training loss (``fast_batch_embeddings``,
    BPR + L2) through the factors' autograd pairs, against the dense chain's
    through ``mm_f32``'s."""
    fb = _fast_bipartite(form)
    layers, n_u = 5, fb.n_users
    cfg = LightGCNConfig(n_u + fb.n_items, DIM, layers)
    loss_fn = make_loss_fn(cfg, 1e-4, batch_embed_fn=lambda p, f, us, po, ne: tbip.fast_batch_embeddings(
        p, f, layers, us, po, ne, edge_cap=4096))
    g = torch.Generator().manual_seed(4)
    users = torch.randint(0, n_u, (64,), generator=g)
    pos, neg = (torch.randint(0, fb.n_items, (64,), generator=g) + n_u for _ in range(2))

    def grad():
        params = {"embedding": _table(n_u + fb.n_items, seed=1)["embedding"].requires_grad_()}
        loss, _ = loss_fn(params, fb, users, pos, neg)
        return torch.autograd.grad(loss, params["embedding"])[0]

    got = grad()
    monkeypatch.setattr(tbip, "item_product", lambda fb: fb.item_op)
    want = grad()
    assert want.abs().max() > 0
    _close(got, want, 1e-5)


@pytest.mark.parametrize("layers", [3, 4, 5])
def test_factored_counter_counts_each_f32_product_and_no_bf16_one(layers):
    """One count a B_ii product: ceil((L - 1) / 2) a forward over an f32
    B_ii (2 at L 5), none over a bf16 one, which the chain takes as it is."""
    fb32 = _fast_bipartite("plans")
    fb16 = _fast_bipartite("plans", dtype=torch.bfloat16)
    assert tbip.item_product(fb16) is fb16.item_op
    counts = []
    for fb in (fb32, fb16):
        params = _table(fb.n_users + fb.n_items)
        with tracing.recording(), torch.no_grad():
            tbip.fast_get_embedding(params, fb, layers)
        counts.append(tracing.report()["counters"].get("ops.item_chain.factored", 0))
    assert counts == [layers // 2, 0]


def test_a_callable_operator_is_its_own_product():
    """A mesh's f32 B_ii band (``ItemBand``, in a ``ShardedFastBipartite``)
    keeps its own product: only a dense f32 B_ii is factored here."""
    import types

    from gnn_ecommerce_tpu_torch.parallel.edge_partition_fast import ItemBand

    B = _fast_bipartite("planless").item_op
    band = ItemBand(B[8:], 8, B.shape[0], None)
    assert band.dtype == torch.float32
    assert tbip.item_product(types.SimpleNamespace(item_op=band)) is band


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the service's refresh runs K1 and the ELL gather only there")
    return torch.device("cuda", 0)


def test_service_refresh_matches_the_dense_chain_on_the_card():
    """One refresh of a service on a generated graph (5,000 users, 600 items,
    d 90, 5 layers): its cache, through the factors (K1, the ELL gather),
    within 1e-5 of the dense chain's over the service's own f32 B_ii, and
    two factored products counted."""
    dev = _card()
    u, i, w, n_u, n_i = _arcs(seed=7, n_u=5000, n_i=600, e=60_000)
    order = np.lexsort((i, u))
    users = np.unique(u)
    indptr = np.searchsorted(u[order], np.append(users, n_u)).astype(np.int64)
    flat = (i[order] + n_u).astype(np.int64)
    empty = EvalSplit(np.zeros(0, np.int64), CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)),
                      CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)))
    prepared = PreparedData(
        n_users=n_u, n_items=n_i, edge_user=u.astype(np.int64), edge_item_node=(i + n_u).astype(np.int64),
        edge_weight=w, sampler=SamplerArrays(users=users, pos_indptr=indptr, pos_flat=flat,
                                             ign_indptr=indptr, ign_flat=flat),
        val=empty, test=empty, user_classes=np.arange(n_u), item_classes=np.arange(n_i))
    layers, dim = 5, 90
    g = torch.Generator().manual_seed(5)
    params = {"embedding": (torch.randn(n_u + n_i, dim, generator=g) * 0.05).to(dev)}
    svc = RecommenderService(prepared, params, LightGCNConfig(n_u + n_i, dim, layers), k=5, device=dev)
    with tracing.recording():
        svc.refresh(params)
    assert tracing.report()["counters"]["ops.item_chain.factored"] == 2
    with torch.no_grad():
        want = _dense_embedding(params, svc.fast_bipartite, layers)
    _close(svc.final_emb, want, 1e-5)
