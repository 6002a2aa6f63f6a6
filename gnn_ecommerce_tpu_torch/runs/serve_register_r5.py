"""Port of ``scripts/serve_register_r5.py``: version swaps through the HTTP
management API (``scripts/serve_register_r5.json``).

The server (``make_server(BatchingRecommender(svc))``) starts on the best
checkpoint. Through the management routes it registers a second checkpoint
(``LightGCN_last``) as a new version, which loads it, propagates it and
warms every batch size before the default flips (``register_s``); it asks
64 users for their top-20 before the swap, after it
(``first_request_after_swap_ms``) and after the rollback to the first
version (``first_request_after_rollback_ms``), then unregisters the new
version. The answers after the rollback must be bit for bit those before
the swap (``rollback_exact``) and those after the swap must differ.
``best_vs_last_top20_overlap`` is printed with no bar: it depends on the
checkpoints.

``under_load`` (a key the script did not have) runs the same sequence while
8 clients x 64 users load the server: zero failed requests, every answer one
version's exact top-K (never a mix, ``answers_by_version``), and the load's
p50/p99 in the window that holds the register against the rest. Plus
``EXTRA_KEYS``: the card, the host and the answers checked.

    python -m gnn_ecommerce_tpu_torch.runs.serve_register_r5 -d DATA_DIR -c CKPT_DIR [--out x.json]
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..serve import BatchingRecommender
from ..serve.server import MODEL_NAME
from ..train.checkpoint import LAST_NAME
from . import _load
from ._cli import cli

USERS = 64
LOAD_CLIENTS, LOAD_BATCH = 8, 64
# Load before the register and after the unregister, in the under_load run.
LEAD_S = TAIL_S = 2.0
MODEL = f"/v1/models/{MODEL_NAME}"
EXTRA_KEYS = {"device", "host", "answers", "under_load"}


def swap_sequence(base: str, svc, users: list, checkpoint_dir: str, checkpoint_name: str) -> dict:
    """Register ``checkpoint_name`` as a new default version, ask for
    ``users``' top-K, roll back to the version that was active, ask again,
    unregister the new one. Returns each answer, the new version's id and
    :class:`~._load.Reference`, and the seconds of each step."""
    first = next(v["version"] for v in _load.request(base, "GET", "/v1/models")["models"][0]["versions"]
                 if v["active"])
    before = _load.predict(base, users)
    t0 = time.perf_counter()
    out = _load.request(base, "POST", f"{MODEL}:register",
                        {"checkpoint_dir": checkpoint_dir, "checkpoint_name": checkpoint_name})
    t1 = time.perf_counter()
    version = out["version"]
    ref = _load.Reference.of(svc, version)
    swapped = _load.predict(base, users)
    t2 = time.perf_counter()
    _load.request(base, "PUT", f"{MODEL}/{first}/set-default")
    t3 = time.perf_counter()
    back = _load.predict(base, users)
    t4 = time.perf_counter()
    _load.request(base, "DELETE", f"{MODEL}/{version}")
    left = [v["version"] for v in _load.request(base, "GET", "/v1/models")["models"][0]["versions"]]
    if left != [first]:
        raise AssertionError(f"versions after the unregister: {left}, expected [{first!r}]")
    if swapped == before:
        raise AssertionError(f"{checkpoint_name} and the first version gave identical top-K")
    if back != before:
        raise AssertionError("the rollback did not restore the first version's answers")
    return {
        "first": first, "version": version, "ref": ref, "before": before, "swapped": swapped,
        "back": back, "register": (t0, t1), "register_s": t1 - t0,
        "after_swap_s": t2 - t1, "after_rollback_s": t4 - t3,
    }


def check_sequence(check, seq: dict, users: list, ref_first) -> None:
    """The sequence's own answers: before the swap and after the rollback
    the first version's top-K, after the swap the new version's."""
    ids = np.asarray(users)
    check.check([_load.Answer(ids, seq[k], 0.0, 0.0) for k in ("before", "back")],
                {seq["first"]: ref_first})
    check.check([_load.Answer(ids, seq["swapped"], 0.0, 0.0)], {seq["version"]: seq["ref"]})


def latency_window(lat: list) -> dict:
    lat = np.sort(np.array(lat))
    if not len(lat):
        return {"requests": 0, "p50_ms": None, "p99_ms": None, "max_ms": None}
    return {"requests": len(lat), "p50_ms": _load.pct_ms(lat, 0.5),
            "p99_ms": _load.pct_ms(lat, 0.99), "max_ms": round(float(lat[-1]) * 1e3, 1)}


def run(svc, checkpoint_dir: str, initial_load_s: float, load_clients: int = LOAD_CLIENTS,
        load_batch: int = LOAD_BATCH, lead_s: float = LEAD_S, tail_s: float = TAIL_S) -> dict:
    """The swap sequence on ``svc`` (loaded in ``initial_load_s``) with
    ``checkpoint_dir``'s LightGCN_last, idle and then under load; raises on
    a failed request or a wrong answer."""
    n_users = svc.prepared.n_users
    check = _load.AnswerCheck(svc.k)
    ids = [int(u) for u in np.random.default_rng(3).integers(0, n_users, USERS)]
    server = _load.Server(BatchingRecommender(svc))
    try:
        ref_first = _load.Reference.of(svc)
        seq = swap_sequence(server.base, svc, ids, checkpoint_dir, LAST_NAME)
        check_sequence(check, seq, ids, ref_first)
        _load.log(f"idle: register {seq['register_s']:.2f} s")

        load = _load.Load(server.port, n_users, load_batch, range(load_clients)).start()
        try:
            time.sleep(lead_s)
            busy = swap_sequence(server.base, svc, ids, checkpoint_dir, LAST_NAME)
            time.sleep(tail_s)
        finally:
            sl = load.stop()
        sl.raise_errors("load under the swaps")
    finally:
        server.close()
    refs = {busy["first"]: ref_first, busy["version"]: busy["ref"]}
    by_version = check.check(sl.answers, refs)
    check_sequence(check, busy, ids, ref_first)
    r0, r1 = busy["register"]
    during = [a.t1 - a.t0 for a in sl.answers if a.t0 < r1 and a.t1 > r0]
    outside = [a.t1 - a.t0 for a in sl.answers if not (a.t0 < r1 and a.t1 > r0)]
    overlap = np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(seq["before"], seq["swapped"])])
    summary = _load.window_summary(sl.latencies, sl.wall, load_clients, load_batch)
    under_load = {
        **{k: summary[k] for k in ("clients", "batch", "window_s", "requests", "requests_per_s")},
        "errors": sl.errors,
        "latency_ms": {k: summary["latency_ms"][k] for k in ("p50", "p99")},
        "register_s": round(busy["register_s"], 1),
        "first_request_after_swap_ms": round(busy["after_swap_s"] * 1e3, 1),
        "first_request_after_rollback_ms": round(busy["after_rollback_s"] * 1e3, 1),
        "rollback_exact": True,
        "answers_by_version": by_version,
        "register_window": latency_window(during),
        "outside_register": latency_window(outside),
    }
    _load.log(f"under load: {under_load}")
    return {
        "benchmark": "serve_register_r5",
        "scale": f"{n_users}x{svc.prepared.n_items}, dim {svc.cfg.embedding_dim}",
        "initial_load_s": round(initial_load_s, 1),
        "register_s": round(seq["register_s"], 1),
        "register_includes": "checkpoint load + full propagation + per-bucket warm BEFORE the default flip",
        "first_request_after_swap_ms": round(seq["after_swap_s"] * 1e3, 1),
        "first_request_after_rollback_ms": round(seq["after_rollback_s"] * 1e3, 1),
        "best_vs_last_top20_overlap": round(float(overlap), 4),
        "rollback_exact": True,
        "under_load": under_load,
        "device": _load.card(svc.device),
        "host": _load.host(),
        "answers": check.stats(),
    }


def main(argv=None) -> int:
    return cli(__doc__, argv, lambda svc, load_s, args: run(svc, args.checkpoint_dir, load_s))


if __name__ == "__main__":
    sys.exit(main())
