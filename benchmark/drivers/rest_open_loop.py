"""Driver ``rest_open_loop``: REST serving under open-loop arrivals.

Set-up builds the service as ``cli/serve.py`` does (``RecommenderService``
in f32 over the seed's graph and table, ``BatchingRecommender`` with the
mix's settings, ``serve/server.py:make_server`` on an ephemeral port, served
from a thread) and starts the load generator (``benchmark/loadgen.py``) as a
separate process, which sends a warm-up stream at the mix's rate. The
window is the mix's rate times ``--seconds`` requests, uniform arrivals over
the window (a Poisson process given its count), sized by the mix's
``sizes`` and drawn over users in proportion to their train degree. Each
request is timed from when it was due to its parsed answer; a failed one
counts as the longest. ``request_p50_ms`` is over every request of the
window; its p99 is recorded in a traced run (``request_p99_ms.serve``), and
both are on stderr in every run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import torch

from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.serve.batching import BatchingRecommender
from gnn_ecommerce_tpu_torch.serve.server import make_server
from gnn_ecommerce_tpu_torch.serve.service import RecommenderService

from benchmark import inputs, program
from benchmark.harness import Window, log
from benchmark.reference import judge
from benchmark.reference import lightgcn as ref

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "loadgen.py")


def percentile(sorted_values: np.ndarray, q: float) -> float:
    """The element at ``int(n·q)`` of the ascending values (at most the
    last): ``runs/_load.py:pct_ms``'s rule, unrounded."""
    return float(sorted_values[min(len(sorted_values) - 1, int(len(sorted_values) * q))])


def latency_summary(requests: list, timeout_s: float) -> dict:
    """p50, p90 and p99 (ms) of every request, each from its due time to its
    answer; a failed request counts as ``timeout_s``. Also the count that
    failed and the generator's lateness (sent after due)."""
    due = np.array([r[0] for r in requests])
    done = np.array([r[2] if r[3] == 200 else r[0] + timeout_s for r in requests])
    late = np.sort(np.array([r[1] - r[0] for r in requests]))
    lat = np.sort(done - due)
    return {
        "request_p50_ms": percentile(lat, 0.50) * 1e3,
        "request_p90_ms": percentile(lat, 0.90) * 1e3,
        "request_p99_ms": percentile(lat, 0.99) * 1e3,
        "failed": int(sum(1 for r in requests if r[3] != 200)),
        "late_p50_ms": percentile(late, 0.50) * 1e3, "late_p99_ms": percentile(late, 0.99) * 1e3,
        "late_max_ms": float(late[-1]) * 1e3,
    }


def schedule(cell, rate: float, seconds: float, stream: str, user_weight: np.ndarray):
    """``[[due, body], ...]`` at ``rate`` over ``seconds`` from the seed's
    ``stream``."""
    rng = np.random.default_rng(inputs.streams(cell.seed)[stream])
    due, ids = inputs.request_stream(rng, int(round(rate * seconds)), seconds, cell.mix["sizes"], user_weight)
    return [[float(d), json.dumps(r.tolist())] for d, r in zip(due, ids)], ids


def setup(cell):
    st = build(cell)
    st.load = start_load(cell, st, cell.mix["rate_per_s"], cell.seconds, cell.mix["warm_seconds"])
    return st


def build(cell):
    """The service behind the HTTP server, served from a thread."""
    dev = torch.device(cell.device)
    model, sv, g = cell.config["model"], cell.config["serve"], cell.config["graph"]
    n_users, n_items = g["n_users"], g["n_items"]
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    table = inputs.xavier_table(inputs.streams(cell.seed)["table"], n_users + n_items, model["embedding_dim"], dev)
    svc = RecommenderService(program.prepared(u, i, w, n_users, n_items), {"embedding": table},
                             LightGCNConfig(n_users + n_items, model["embedding_dim"], model["num_layers"]),
                             k=sv["k"], mask_mode=sv["mask_mode"], device=dev)
    del table
    batcher = BatchingRecommender(svc, **cell.mix["batching"])
    httpd = make_server(batcher, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    st = types.SimpleNamespace(u=u, i=i, w=w, svc=svc, batcher=batcher, httpd=httpd, thread=thread,
                               weight=np.bincount(u, minlength=n_users).astype(np.float64))
    st.shape = program.graph_shape(u, i, n_users, n_items, model["embedding_dim"], model["num_layers"])
    return st


def start_load(cell, st, rate: float, seconds: float, warm_seconds: float):
    """The generator process, its warm-up stream sent and answered."""
    warm, _ = schedule(cell, rate, warm_seconds, "warm", st.weight)
    win, ids = schedule(cell, rate, seconds, "traffic", st.weight)
    proc = subprocess.Popen([sys.executable, LOADGEN], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    proc.stdin.write(json.dumps({"port": st.httpd.server_address[1], "timeout_s": cell.mix["timeout_s"],
                                 "warm": warm, "window": win}) + "\n")
    proc.stdin.flush()
    warm_done = json.loads(proc.stdout.readline())
    log(f"load generator warm-up: {warm_done}")
    return types.SimpleNamespace(proc=proc, ids=ids, warm=warm_done)


def run_load(cell, load) -> list:
    """Start the window and wait for every request of it (the generator
    gives each up ``timeout_s`` after it was due, so it ends; a generator
    that does not is killed and the run fails)."""
    proc = load.proc
    proc.stdin.write("go\n")
    proc.stdin.flush()
    try:
        out, _ = proc.communicate(timeout=cell.seconds + cell.mix["timeout_s"] + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return json.loads(out.strip().splitlines()[-1])["requests"]


def window(cell, st, seconds: float) -> Window:
    before = st.batcher.metrics()
    requests = run_load(cell, st.load)
    after = st.batcher.metrics()
    st.counters = {k: after[k] - before[k] for k in ("batches_total", "batched_users_total")}
    summ = latency_summary(requests, cell.mix["timeout_s"])
    log(f"request latency ms: p50 {summ['request_p50_ms']!r} p90 {summ['request_p90_ms']!r} "
        f"p99 {summ['request_p99_ms']!r}")
    log(f"load generator lateness ms: p50 {summ['late_p50_ms']!r} p99 {summ['late_p99_ms']!r} "
        f"max {summ['late_max_ms']!r}; last answer {max(r[2] for r in requests):.3f} s "
        f"into a {seconds} s window; {len(requests)} requests")
    return Window(metrics={"request_p50_ms": summ["request_p50_ms"]},
                  attempted=len(requests), failed=summ["failed"],
                  extra={"requests": requests, "ids": st.load.ids, "summary": summ})


def release(cell, st) -> None:
    st.httpd.shutdown()
    st.httpd.server_close()
    st.thread.join(timeout=30)
    st.svc = st.batcher = st.httpd = None


def answered(win) -> tuple:
    """(users [R], served [R, k]) of every answered request of the window;
    an answer of the wrong shape is kept as a row of -1."""
    users, rows = [], []
    for (_, _, _, status, items), ids in zip(win.extra["requests"], win.extra["ids"]):
        if status != 200:
            continue
        ok = isinstance(items, list) and len(items) == len(ids)
        for k, user in enumerate(ids):
            users.append(user)
            rows.append(items[k] if ok else None)
    return np.asarray(users, np.int64), rows


def check(cell, st, win) -> dict:
    """Every answered row's widest score gap against the reference's f32
    embedding of the same table, with its purchases masked; malformed rows
    and failed requests are counted."""
    dev = torch.device(cell.device)
    n_users, k = cell.config["graph"]["n_users"], cell.config["serve"]["k"]
    final = reference_final(cell, st, dev)
    users, rows = answered(win)
    served = np.array([r if isinstance(r, list) and len(r) == k else [-1] * k for r in rows], np.int64)
    gap, bad = judge.score_gap(final, n_users, users, served.reshape(-1, k),
                               ref.purchase_rows(st.u, st.i, st.w, n_users), k)
    limits = cell.mix["limits"]
    return {"failed_requests": (float(win.failed), limits["failed_requests"]),
            "bad_rows": (float(bad), limits["bad_rows"]),
            "score_gap": (gap, limits["score_gap"])}


def reference_final(cell, st, dev, quant=None) -> torch.Tensor:
    model, g = cell.config["model"], cell.config["graph"]
    adj = ref.Adjacency(st.u, st.i, st.w, g["n_users"], g["n_items"], dev, quant=quant)
    table = inputs.xavier_table(inputs.streams(cell.seed)["table"], g["n_users"] + g["n_items"],
                                model["embedding_dim"], dev)
    with torch.no_grad():
        return ref.final_embedding(adj, table, model["num_layers"])



def controls(cell) -> dict:
    """{kind: {number: value}} of the control: the reference in TF32 in the
    program's place, answering the window's requests at the mix's rate."""
    from benchmark.reference.precision import TF32

    dev = torch.device(cell.device)
    g, k = cell.config["graph"], cell.config["serve"]["k"]
    n_users = g["n_users"]
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    st = types.SimpleNamespace(u=u, i=i, w=w)
    _, ids = schedule(cell, cell.mix["rate_per_s"], cell.seconds, "traffic",
                      np.bincount(u, minlength=n_users).astype(np.float64))
    users = np.concatenate(ids)
    purchases = ref.purchase_rows(u, i, w, n_users)
    f32 = reference_final(cell, st, dev)
    low = reference_final(cell, st, dev, quant=TF32)
    served = np.concatenate([
        ref.top_k(low, n_users, users[s:s + judge.ROWS_PER_BLOCK], purchases, k, quant=TF32)[2].cpu().numpy()
        for s in range(0, len(users), judge.ROWS_PER_BLOCK)])
    gap, bad = judge.score_gap(f32, n_users, users, served, purchases, k)
    return {"control_tf32": {"score_gap": gap, "bad_rows": float(bad)}}
