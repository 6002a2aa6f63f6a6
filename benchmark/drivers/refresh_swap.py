"""Driver ``refresh_swap``: pushing a new table into a running service.

Set-up makes two tables on the card from the seed and builds
``RecommenderService`` (f32: its own f32 B_ii and plans) over the seed's
graph with the first; it refreshes once with each table to warm the path.
The window calls ``RecommenderService.refresh(params)`` back to back,
alternating the two tables, until ``--seconds`` have passed. Each call is a
whole f32 fast propagation into the cache, ending in its synchronize, and
the swap; ``refresh_ms`` is the window's seconds over its refreshes. The
cache each table last produced is kept for the check.
"""
from __future__ import annotations

import time
import types

import torch

from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops.bipartite import item_chain_core
from gnn_ecommerce_tpu_torch.serve.service import RecommenderService

from benchmark import inputs, program
from benchmark.harness import Window, log
from benchmark.reference import judge
from benchmark.reference import lightgcn as ref

TABLES = ("table", "table_b")


def tables(cell, dev) -> dict:
    model, g = cell.config["model"], cell.config["graph"]
    seeds = inputs.streams(cell.seed)
    return {name: inputs.xavier_table(seeds[name], g["n_users"] + g["n_items"], model["embedding_dim"], dev)
            for name in TABLES}


def setup(cell):
    dev = torch.device(cell.device)
    model, sv, g = cell.config["model"], cell.config["serve"], cell.config["graph"]
    n_users, n_items = g["n_users"], g["n_items"]
    D, L = model["embedding_dim"], model["num_layers"]
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    params = {name: {"embedding": t} for name, t in tables(cell, dev).items()}
    svc = RecommenderService(program.prepared(u, i, w, n_users, n_items), params[TABLES[0]],
                             LightGCNConfig(n_users + n_items, D, L), k=sv["k"], mask_mode=sv["mask_mode"],
                             device=dev)
    for name in (TABLES[1], TABLES[0]):
        svc.refresh(params[name])
    log(f"service built; a warm refresh {svc.last_refresh_s:.6f} s")
    st = types.SimpleNamespace(u=u, i=i, w=w, svc=svc, params=params, last={},
                               shape=program.graph_shape(u, i, n_users, n_items, D, L))
    alpha = torch.full((L + 1,), 1.0 / (L + 1), dtype=torch.float32, device=dev)

    def chain():
        x = params[TABLES[0]]["embedding"][n_users:]
        with torch.no_grad():
            return item_chain_core(x, x, lambda y: y, svc.fast_bipartite.item_op, L, alpha)

    def time_refreshes(n: int) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in range(n):
            svc.refresh(params[TABLES[k % 2]])
        return (time.perf_counter() - t) / n

    st.ops = {"chain": chain}
    st.time_refreshes = time_refreshes
    return st


def window(cell, st, seconds: float) -> Window:
    n = 0
    t0 = time.perf_counter()
    while True:
        name = TABLES[(n + 1) % 2]
        st.svc.refresh(st.params[name])
        st.last[name] = st.svc.final_emb
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    log(f"window: {n} refreshes in {elapsed:.6f} s")
    return Window(metrics={"refresh_ms": elapsed / n * 1e3}, attempted=n, failed=0)


def release(cell, st) -> None:
    st.svc = st.params = st.ops = st.time_refreshes = None


def check(cell, st, win) -> dict:
    """Each table's last cache against the reference's f32 embedding of it."""
    finals = reference_finals(cell, st, torch.device(cell.device))
    gap = max(judge.row_gap(emb, finals[name]) for name, emb in st.last.items())
    return {"embedding_gap": (gap, cell.mix["limits"]["embedding_gap"])}


def reference_finals(cell, st, dev, quant=None) -> dict:
    model, g = cell.config["model"], cell.config["graph"]
    adj = ref.Adjacency(st.u, st.i, st.w, g["n_users"], g["n_items"], dev, quant=quant)
    with torch.no_grad():
        return {name: ref.final_embedding(adj, t, model["num_layers"]) for name, t in tables(cell, dev).items()}


def controls(cell) -> dict:
    """{kind: {number: value}} of the control: the reference in TF32 in the
    program's place."""
    from benchmark.reference.precision import TF32

    dev = torch.device(cell.device)
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    st = types.SimpleNamespace(u=u, i=i, w=w)
    f32 = reference_finals(cell, st, dev)
    low = reference_finals(cell, st, dev, quant=TF32)
    return {"control_tf32": {"embedding_gap": max(judge.row_gap(low[n], f32[n]) for n in f32)}}
