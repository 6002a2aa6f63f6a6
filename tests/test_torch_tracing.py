"""The port's span tracer (``gnn_ecommerce_tpu_torch/tracing.py``) on the CPU:
off it hands out one shared no-op object and keeps nothing; recording keeps
each span's parent on its own thread's stack, its self time and the
counters; under a torch profiler each span (and each mark, which is never
recorded) is a host ``cpu_op`` event, not a user annotation; and the spans of the training step (LightGCN's,
SimGCL's and DGCF's), the service's refresh
and the fast-bipartite build appear where those paths run. Also the
batcher's queue-wait and dispatch counters. On a card (skipped without one;
``python -m pytest tests/test_torch_tracing.py --noconftest -q -k copies``
there): a LightGCN step neither copies from the host nor waits for the card."""
import contextlib
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch import tracing
from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit, PreparedData, SamplerArrays
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops import bipartite as bip
from gnn_ecommerce_tpu_torch.sampling.bpr import make_sampler_data
from gnn_ecommerce_tpu_torch.serve import BatchingRecommender, RecommenderService, make_server
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns
from torch_port_case import small_arcs

torch.set_num_threads(1)

DIM, LAYERS, BATCH, STEPS = 8, 3, 64, 3
STEP_SPANS = ("train.step", "train.sample", "train.forward", "train.loss", "train.backward", "train.adam")


def records(name):
    return [r for r in tracing._spans if r.name == name]


def parent_name(rec):
    return None if rec.parent is None else rec.parent.name


def test_off_is_one_shared_object_and_keeps_nothing():
    with tracing.recording():
        pass
    assert not torch._C._autograd._profiler_enabled()
    first, second = tracing.span("a"), tracing.span("b.c")
    assert first is second is tracing._OFF
    assert tracing.mark("d") is tracing._OFF
    with first as entered:
        assert entered is None
        tracing.count("n", 3)
    assert tracing.report() == {"spans": {}, "counters": {}}


def test_recording_parents_self_time_threads_and_counters():
    def worker():
        with tracing.span("thread.outer"):
            with tracing.span("thread.inner"):
                tracing.count("n", 2)

    with tracing.recording():
        with tracing.span("outer"):
            time.sleep(0.01)
            with tracing.span("inner"):
                time.sleep(0.02)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            tracing.count("n")
    rep = tracing.report()
    assert set(rep["spans"]) == {"outer", "inner", "thread.outer", "thread.inner"}
    assert rep["counters"] == {"n": 3}
    assert all(s["calls"] == 1 and s["device_ms"] is None for s in rep["spans"].values())
    outer, inner = rep["spans"]["outer"], rep["spans"]["inner"]
    assert inner["host_ms"] >= 20 and outer["host_ms"] >= 30
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    assert inner["self_host_ms"] == pytest.approx(inner["host_ms"])
    # The worker's spans are on their own stack, not under the main thread's.
    (t_outer,), (t_inner,), (m_inner,) = records("thread.outer"), records("thread.inner"), records("inner")
    assert parent_name(t_outer) is None and parent_name(t_inner) == "thread.outer"
    assert parent_name(m_inner) == "outer" and t_outer.thread != m_inner.thread
    # A new block drops what the last one kept; spans after it are not kept.
    with tracing.recording():
        pass
    with tracing.span("late"):
        pass
    assert tracing.report() == {"spans": {}, "counters": {}}


def test_span_under_a_profiler_is_a_host_op_not_a_user_annotation():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ops.outer") as s:
            assert s is not tracing._OFF
            with tracing.span("ops.inner"):
                torch.ones(8).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("ops.outer", "ops.inner"):
        assert name in events
        assert not events[name].is_user_annotation()
    assert events["ops.inner"].start_ns() >= events["ops.outer"].start_ns()


def test_mark_is_on_the_profiler_timeline_alone():
    from torch.profiler import ProfilerActivity, profile

    with tracing.recording():
        with tracing.span("outer"):
            assert tracing.mark("inner.mark") is tracing._OFF
    assert set(tracing.report()["spans"]) == {"outer"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            with tracing.span("outer"), tracing.mark("inner.mark"):
                torch.ones(8).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "inner.mark" in events and not events["inner.mark"].is_user_annotation()
    assert events["inner.mark"].start_ns() >= events["outer"].start_ns()
    assert set(tracing.report()["spans"]) == {"outer"}


def _tiny():
    u, i, w, n_u, n_i = small_arcs()
    order = np.lexsort((i, u))
    uu, ii = u[order], i[order]
    users = np.unique(uu)
    indptr = np.searchsorted(uu, np.append(users, n_u)).astype(np.int64)
    flat = (ii + n_u).astype(np.int64)
    sampler = SamplerArrays(users=users, pos_indptr=indptr, pos_flat=flat, ign_indptr=indptr, ign_flat=flat)
    return u, i, w, n_u, n_i, sampler


# B_ii products in a chain of LAYERS layers: one a pair of layers 2..L (ceil((L - 1) / 2)).
PRODUCTS = LAYERS // 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_steps_spans_once_a_step(dtype):
    """Each step's spans; the sparse products once a step over a bf16 B_ii,
    and over an f32 B_ii also twice a B_ii product in the chain (its two
    factors, each with its gradient), which ``ops.item_chain.factored``
    counts."""
    u, i, w, n_u, n_i, sampler = _tiny()
    graph = build_graph(u, i, w, n_u, n_i, device="cpu")
    if dtype == "float32":
        fb = bip.build_fast_bipartite(graph, fast_ops=True, heavy_users=50, device="cpu")
    else:
        fb = bip.build_fast_bipartite(graph, dtype=torch.bfloat16, fast_ops=True, msgs_dtype="bfloat16",
                                      heavy_users=50, heavy_dtype="bfloat16", device="cpu")
    factored = PRODUCTS if dtype == "float32" else 0
    sdata = make_sampler_data(sampler, n_u, n_i, "cpu")
    params = {"embedding": torch.randn(n_u + n_i, DIM, generator=torch.Generator().manual_seed(0)) * 0.1}
    opt = Adam(0.005)
    state = opt.init(params)
    _, run_steps = make_train_fns(
        LightGCNConfig(n_u + n_i, DIM, LAYERS), opt, BATCH, 1e-4,
        batch_embed_fn=lambda p, f, us, po, ne: bip.fast_batch_embeddings(p, f, LAYERS, us, po, ne, edge_cap=4096),
    )
    gen = torch.Generator().manual_seed(1)
    with tracing.recording():
        params, state, _ = run_steps(params, state, fb, sdata, gen, STEPS)
    rep = tracing.report()
    spans = rep["spans"]
    for name in STEP_SPANS + ("ops.item_chain", "ops.batch_users"):
        assert spans[name]["calls"] == STEPS, name
    for name in ("ops.to_items", "ops.to_users"):
        assert spans[name]["calls"] == STEPS * (1 + 2 * factored), name
    assert rep["counters"].get("ops.item_chain.factored", 0) == STEPS * factored
    assert spans["train.sync"]["calls"] == 1
    assert "train.sample.bisect" not in spans  # a profiler's mark, not recorded
    # The forward's products under the chain; to_items' backward (the ELL)
    # under the backward; every child of a step inside it.
    for child, parent in (("train.sample", {"train.step"}), ("train.forward", {"train.step"}),
                          ("train.backward", {"train.step"}), ("train.adam", {"train.step"}),
                          ("ops.item_chain", {"train.forward"}),
                          ("ops.to_items", {"ops.item_chain", "train.backward"} if factored else {"ops.item_chain"}),
                          ("ops.batch_users", {"train.forward"}),
                          ("ops.to_users", {"ops.item_chain", "train.backward"} if factored else {"train.backward"})):
        assert {parent_name(r) for r in records(child)} == parent, child
    kids = sum(spans[k]["host_ms"] for k in STEP_SPANS[1:])
    assert kids <= spans["train.step"]["host_ms"]
    assert spans["train.step"]["self_host_ms"] == pytest.approx(spans["train.step"]["host_ms"] - kids)


def _copies_and_waits_in_steps(dev: torch.device) -> dict:
    """The bf16 main path's LightGCN step (``fast_batch_embeddings`` with the
    default layer weights) on ``_tiny``'s case: 3 steps, then ``run_steps``
    of 4 under the profiler. Counts the ``train.step`` spans, the device's
    events, and inside a ``train.step`` the device's host-to-device copies
    and the runtime calls that wait for the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    u, i, w, n_u, n_i, sampler = _tiny()
    graph = build_graph(u, i, w, n_u, n_i, device="cpu")
    fb = bip.build_fast_bipartite(graph, dtype=torch.bfloat16, fast_ops=True, msgs_dtype="bfloat16",
                                  heavy_users=50, heavy_dtype="bfloat16", device=dev)
    sdata = make_sampler_data(sampler, n_u, n_i, dev)
    table = torch.randn(n_u + n_i, DIM, generator=torch.Generator().manual_seed(0)) * 0.1
    params = {"embedding": table.to(dev)}
    opt = Adam(0.005)
    state = opt.init(params)
    train_step, run_steps = make_train_fns(
        LightGCNConfig(n_u + n_i, DIM, LAYERS), opt, BATCH, 1e-4,
        batch_embed_fn=lambda p, f, us, po, ne: bip.fast_batch_embeddings(p, f, LAYERS, us, po, ne, edge_cap=4096),
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        params, state, _ = train_step(params, state, fb, sdata, gen)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_steps(params, state, fb, sdata, gen, 4)
    events = list(prof.profiler.kineto_results.events())
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.name() == "train.step"]
    inside = lambda e: any(lo <= e.start_ns() <= hi for lo, hi in spans)
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    on_host = [e for e in events if e.device_type() != DeviceType.CUDA]
    return {
        "steps": len(spans),
        "device_events": len(on_card),
        "copies_htod": sum(e.name().startswith("Memcpy HtoD") and inside(e) for e in on_card),
        "syncs": sum("Synchronize" in e.name() and inside(e) for e in on_host),
    }


def test_train_step_neither_copies_from_the_host_nor_waits():
    """On a card (skipped without one): inside ``train.step`` nothing is
    copied from the host and the host never waits for the stream, so the
    host can run ahead of the card; ``run_steps``' one read of its metrics
    (``train.sync``) lies outside the steps. The layer weights are filled on
    the card, not copied there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: host-to-device copies and stream waits are the card's")
    got = _copies_and_waits_in_steps(torch.device("cuda", 0))
    assert got["steps"] == 4 and got["device_events"] > 0, got
    assert got["copies_htod"] == 0 and got["syncs"] == 0, got


@pytest.mark.parametrize("recording", [True, False])
def test_simgcl_step_spans_and_counters(recording):
    """One SimGCL step: ``train.cl`` with two ``train.cl.view`` (each with a
    ``train.cl.noise`` a layer) and one ``train.cl.infonce``; the counters
    hold the rows noised and the arcs the views traverse. Off, nothing."""
    from gnn_ecommerce_tpu_torch.models.simgcl import make_simgcl_loss_fn, simgcl_alphas

    u, i, w, n_u, n_i, sampler = _tiny()
    graph = build_graph(u, i, w, n_u, n_i, device="cpu")
    fb = bip.build_fast_bipartite(graph, fast_ops=True, heavy_users=50, device="cpu")
    sdata = make_sampler_data(sampler, n_u, n_i, "cpu")
    params = {"embedding": torch.randn(n_u + n_i, DIM, generator=torch.Generator().manual_seed(0)) * 0.1}
    opt = Adam(0.001)
    state = opt.init(params)
    cfg = LightGCNConfig(n_u + n_i, DIM, LAYERS, alpha=simgcl_alphas(LAYERS))
    loss_fn = make_simgcl_loss_fn(cfg, 1e-4, 0.5, 0.1, 0.2, 4096, torch.Generator().manual_seed(2))
    train_step, _ = make_train_fns(cfg, opt, BATCH, 1e-4, loss_fn=loss_fn)
    gen = torch.Generator().manual_seed(1)
    with tracing.recording():
        pass  # drops what earlier tests kept
    with tracing.recording() if recording else contextlib.nullcontext():
        train_step(params, state, fb, sdata, gen)
    rep = tracing.report()
    if not recording:
        assert rep == {"spans": {}, "counters": {}}
        return
    spans = rep["spans"]
    for name, calls in (("train.cl", 1), ("train.cl.view", 2), ("train.cl.noise", 2 * LAYERS),
                        ("train.cl.infonce", 1), ("train.forward", 1), ("train.backward", 1)):
        assert spans[name]["calls"] == calls, name
    for child, parent in (("train.cl", "train.step"), ("train.cl.view", "train.cl"),
                          ("train.cl.noise", "train.cl.view"), ("train.cl.infonce", "train.cl")):
        assert {parent_name(r) for r in records(child)} == {parent}, child
    assert rep["counters"] == {"train.cl.noised_rows": 2 * LAYERS * (n_u + n_i),
                               "train.cl.view_arcs": 2 * LAYERS * 2 * len(u),
                               "ops.item_chain.factored": PRODUCTS}  # the clean term's f32 B_ii


@pytest.mark.parametrize("recording", [True, False])
def test_dgcf_step_spans_and_counters(recording):
    """One DGCF step (K 2, T 3, L 2): ``train.dgcf`` with L·T
    ``train.dgcf.iter``, each with its ``.softmax``, ``.degree`` and
    ``.spmm``, L·T − 1 ``.score`` (the last layer's last update is skipped),
    one ``train.dgcf.cor`` beside it; ``train.dgcf.routed_arcs`` counts arcs
    × intents of every iteration, and no split rows on the CPU (the kernel's
    plain version). Off, nothing."""
    from gnn_ecommerce_tpu_torch.models.dgcf import make_dgcf_loss_fn
    from gnn_ecommerce_tpu_torch.ops.routing import build_routing_graph

    k, t, layers = 2, 3, 2
    u, i, w, n_u, n_i, sampler = _tiny()
    rg = build_routing_graph(build_graph(u, i, w, n_u, n_i, device="cpu"))
    sdata = make_sampler_data(sampler, n_u, n_i, "cpu")
    params = {"embedding": torch.randn(n_u + n_i, DIM, generator=torch.Generator().manual_seed(0)) * 0.1}
    opt = Adam(0.001)
    state = opt.init(params)
    loss_fn = make_dgcf_loss_fn(k, t, layers, 1e-4, 0.01, 16, torch.Generator().manual_seed(2))
    train_step, _ = make_train_fns(None, opt, BATCH, 1e-4, loss_fn=loss_fn)
    gen = torch.Generator().manual_seed(1)
    with tracing.recording():
        pass  # drops what earlier tests kept
    with tracing.recording() if recording else contextlib.nullcontext():
        train_step(params, state, rg, sdata, gen)
    rep = tracing.report()
    if not recording:
        assert rep == {"spans": {}, "counters": {}}
        return
    spans = rep["spans"]
    iters = layers * t
    for name, calls in (("train.dgcf", 1), ("train.dgcf.iter", iters), ("train.dgcf.softmax", iters),
                        ("train.dgcf.degree", iters), ("train.dgcf.spmm", iters), ("train.dgcf.score", iters - 1),
                        ("train.dgcf.cor", 1), ("train.forward", 1), ("train.backward", 1)):
        assert spans[name]["calls"] == calls, name
    for child, parent in (("train.dgcf", "train.forward"), ("train.dgcf.iter", "train.dgcf"),
                          ("train.dgcf.softmax", "train.dgcf.iter"), ("train.dgcf.degree", "train.dgcf.iter"),
                          ("train.dgcf.spmm", "train.dgcf.iter"), ("train.dgcf.score", "train.dgcf.iter"),
                          ("train.dgcf.cor", "train.step")):
        assert {parent_name(r) for r in records(child)} == {parent}, child
    assert rep["counters"] == {"train.dgcf.routed_arcs": iters * 2 * len(u) * k}


def test_fast_bipartite_build_spans_and_verbose_phases(capsys):
    u, i, w, n_u, n_i, _ = _tiny()
    graph = build_graph(u, i, w, n_u, n_i, device="cpu")
    with tracing.recording():
        fb = bip.build_fast_bipartite(graph, fast_ops=True, heavy_users=50, device="cpu")
    rep = tracing.report()
    phases = ("host_csr", "pair_aggregate", "scatter", "heavy_matmuls")
    assert {"setup.split", "setup.plans", "setup.item_op"} <= set(rep["spans"])
    for p in phases:
        (rec,) = records(f"setup.item_op.{p}")
        assert parent_name(rec) == "setup.item_op"
    assert set(fb.build_seconds) == {"plans", "item_op"} and rep["counters"] == {}
    # verbose prints a line after each phase's span, the counts in its label:
    # the heavy users are those of more than ell_width (8) arcs.
    split = bip.split_graph(graph)
    bip.build_item_operator(split, heavy_chunk=4, verbose=True, device="cpu")
    err = capsys.readouterr().err
    assert "b_ii phase host csr" in err and "b_ii phase scatter" in err
    pairs = int(re.search(r"b_ii phase pair_aggregate \((\d+) pairs\)", err).group(1))
    heavy = int(re.search(r"b_ii phase heavy matmuls \((\d+) users\)", err).group(1))
    assert pairs > 0 and heavy == int((np.bincount(split.ui_src_user) > 8).sum()) > 0


def _service():
    u, i, w, n_u, n_i, sampler = _tiny()
    empty = EvalSplit(np.zeros(0, np.int64), CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)),
                      CsrList(np.zeros(1, np.int64), np.zeros(0, np.int64)))
    prepared = PreparedData(n_users=n_u, n_items=n_i, edge_user=u.astype(np.int64),
                            edge_item_node=(i + n_u).astype(np.int64), edge_weight=w, sampler=sampler,
                            val=empty, test=empty, user_classes=np.arange(n_u), item_classes=np.arange(n_i))
    params = {"embedding": torch.randn(n_u + n_i, DIM, generator=torch.Generator().manual_seed(2)) * 0.1}
    return RecommenderService(prepared, params, LightGCNConfig(n_u + n_i, DIM, LAYERS), k=5, device="cpu"), params


def test_refresh_spans():
    svc, params = _service()
    with tracing.recording():
        svc.refresh(params)
        svc.refresh(params)
    rep = tracing.report()
    spans = rep["spans"]
    for name in ("serve.refresh", "serve.refresh.propagate", "serve.refresh.cache", "serve.refresh.swap",
                 "ops.item_chain"):
        assert spans[name]["calls"] == 2, name
    # The service's f32 B_ii runs as its two factors: each product adds one
    # call of each sparse direction inside the chain.
    for name in ("ops.to_items", "ops.to_users"):
        assert spans[name]["calls"] == 2 * (1 + PRODUCTS), name
    assert rep["counters"]["ops.item_chain.factored"] == 2 * PRODUCTS
    for child in ("serve.refresh.propagate", "serve.refresh.cache", "serve.refresh.swap"):
        assert {parent_name(r) for r in records(child)} == {"serve.refresh"}
    assert {parent_name(r) for r in records("ops.to_users")} == {"serve.refresh.propagate", "ops.item_chain"}
    assert svc.last_refresh_s * 1e3 <= spans["serve.refresh"]["host_ms"]


def test_batcher_counts_queue_wait_and_dispatch():
    svc, _ = _service()
    linger = 0.05
    batcher = BatchingRecommender(svc, max_wait_s=linger)
    users = np.asarray(svc.prepared.sampler.users)
    reqs = [users[k : k + 2] for k in range(0, 16, 2)]
    out = [None] * len(reqs)

    def call(k):
        out[k] = batcher.recommend(reqs[k])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(k,)) for k in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    wall = time.perf_counter() - t0
    assert all(o is not None for o in out)
    m = batcher.metrics()
    assert m["batched_requests_total"] == len(reqs)
    # Each batch waits out its linger from its oldest request's arrival.
    assert m["queue_wait_seconds_total"] >= 0.99 * linger * m["batches_total"]
    assert m["queue_wait_seconds_total"] <= len(reqs) * wall
    assert 0 < m["dispatch_seconds_total"] <= 2 * wall
    server = make_server(batcher, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics") as r:
            text = r.read().decode()
    finally:
        server.shutdown()
    counts = {line.split()[0]: float(line.split()[1]) for line in text.splitlines() if line and line[0] != "#"}
    assert "# TYPE lightgcn_queue_wait_seconds_total counter" in text
    assert counts["lightgcn_queue_wait_seconds_total"] == pytest.approx(m["queue_wait_seconds_total"])
    assert counts["lightgcn_dispatch_seconds_total"] == pytest.approx(m["dispatch_seconds_total"])
