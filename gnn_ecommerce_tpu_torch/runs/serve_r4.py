"""Port of ``scripts/serve_r4.py``: sustained load with and without the
cross-request batcher (``SERVE_r4.json``).

Two workloads, each in windows (20 s) alternating the unbatched server
(``make_server(svc)``) and the batched one (``BatchingRecommender(svc,
max_wait_s=0.004)``), two of each: big requests (8 clients x 64 users,
which the batcher passes straight to the service: 64 >= ``solo_min`` 32)
and small ones (16 x 4, which it coalesces). Three warm requests open each
window. The result has the script's keys: each window (``windows``), the
batcher's counters, each workload's aggregate and the batched-over-unbatched
``summary``; plus ``EXTRA_KEYS``: the card, the host and the answers
checked (each window's against the plain top-K, after the window).

    python -m gnn_ecommerce_tpu_torch.runs.serve_r4 -d DATA_DIR -c CKPT_DIR [--out x.json]
"""
from __future__ import annotations

import sys

import numpy as np

from ..serve import BatchingRecommender
from . import _load
from ._cli import checkpoint_of, cli

WINDOW_S = 20.0
CLIENTS = 8
BATCH = 64  # the round-3 protocol: already-big requests
SMALL_CLIENTS = 16  # many tiny requests: the regime batching exists for
SMALL_BATCH = 4
MAX_WAIT_S = 0.004
WARM_REQUESTS = 3
EXTRA_KEYS = {"device", "host", "answers"}


def run_load(port: int, n_users: int, label: str, clients: int, batch: int, window_s: float,
             verify) -> dict:
    """``scripts/serve_r4.py:run_load``: warm requests, then one window;
    ``verify(answers)`` after it. A failed request raises."""
    base = f"http://127.0.0.1:{port}"
    rng0 = np.random.default_rng(0)
    for _ in range(WARM_REQUESTS):  # warm this workload's path end to end
        _load.predict(base, rng0.integers(0, n_users, batch))
    sl = _load.run_slice(port, n_users, batch, window_s, range(clients))
    sl.raise_errors(label)
    verify(sl.answers)
    s = _load.window_summary(sl.latencies, sl.wall, clients, batch)
    out = {"label": label, **{k: s[k] for k in ("clients", "batch", "window_s", "requests")},
           "errors": sl.errors, **{k: s[k] for k in ("requests_per_s", "users_per_s", "latency_ms")}}
    _load.log(f"{label}: {out}")
    return out


def aggregate(runs: list, label: str, batch: int) -> dict:
    """The script's ``agg``: users/s over the windows' summed wall seconds,
    the mean of their percentiles, their requests."""
    sel = [r for r in runs if r["label"] == label]
    wall = sum(r["window_s"] for r in sel)
    return {
        "users_per_s": round(sum(r["requests"] * batch for r in sel) / wall, 1),
        "p50_ms": round(float(np.mean([r["latency_ms"]["p50"] for r in sel])), 1),
        "p90_ms": round(float(np.mean([r["latency_ms"]["p90"] for r in sel])), 1),
        "p99_ms": round(float(np.mean([r["latency_ms"]["p99"] for r in sel])), 1),
        "requests": sum(r["requests"] for r in sel),
    }


def summarize(results: dict, runs: list, batches: dict) -> dict:
    """Each workload's aggregates into ``results`` and the ``summary``."""
    summary = {}
    for wl, batch in batches.items():
        u = aggregate(runs, f"{wl}-unbatched", batch)
        b = aggregate(runs, f"{wl}-batched", batch)
        results[f"{wl}_unbatched"], results[f"{wl}_batched"] = u, b
        summary[wl] = {
            "p99_ms_unbatched": u["p99_ms"],
            "p99_ms_batched": b["p99_ms"],
            "users_per_s_unbatched": u["users_per_s"],
            "users_per_s_batched": b["users_per_s"],
            "p99_improvement": round(u["p99_ms"] / max(b["p99_ms"], 1e-9), 2),
            "throughput_improvement": round(b["users_per_s"] / max(u["users_per_s"], 1e-9), 2),
        }
    return summary


def run(svc, load_s: float, checkpoint: str, window_s: float = WINDOW_S, clients: int = CLIENTS,
        batch: int = BATCH, small_clients: int = SMALL_CLIENTS, small_batch: int = SMALL_BATCH) -> dict:
    """The script's eight windows on ``svc`` (loaded in ``load_s`` from
    ``checkpoint``); raises on a failed request or a wrong answer."""
    n_users = svc.prepared.n_users
    results = {
        "scale": f"{n_users}x{svc.prepared.n_items}, "
                 f"dim {svc.cfg.embedding_dim}, {svc.cfg.num_layers} layers",
        "checkpoint": checkpoint,
        "load_s": round(load_s, 1),
        "bucket_warmup_s": round(getattr(svc, "warmup_s", 0.0), 1),
    }
    check = _load.AnswerCheck(svc.k)
    refs = {"active": _load.Reference.of(svc)}
    batcher = BatchingRecommender(svc, max_wait_s=MAX_WAIT_S)
    plain, batched = _load.Server(svc), _load.Server(batcher)
    runs = []
    try:
        # Big requests (the batcher passes them through), then small ones,
        # each alternating A/B/A/B.
        for wl, c, b in (("big", clients, batch), ("small", small_clients, small_batch)):
            for mode in ("unbatched", "batched", "unbatched", "batched"):
                server = plain if mode == "unbatched" else batched
                runs.append(run_load(server.port, n_users, f"{wl}-{mode}", c, b, window_s,
                                     lambda answers: check.check(answers, refs)))
    finally:
        plain.close()
        batched.close()
    m = batcher.metrics()
    results["windows"] = runs
    results["batcher"] = {
        k: m[k] for k in ("batches_total", "batched_requests_total", "users_per_batch_avg")
    }
    results["summary"] = summarize(results, runs, {"big": batch, "small": small_batch})
    _load.log(f"summary: {results['summary']}")
    results.update({"device": _load.card(svc.device), "host": _load.host(), "answers": check.stats()})
    return results


def main(argv=None) -> int:
    return cli(__doc__, argv, lambda svc, load_s, args: run(svc, load_s, checkpoint_of(args)))


if __name__ == "__main__":
    sys.exit(main())
