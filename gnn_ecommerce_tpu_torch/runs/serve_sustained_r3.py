"""Port of ``scripts/serve_sustained_r3.py``: sustained concurrent load.

``clients`` threads (8) each send requests of ``batch`` (64) random users
for a fixed window (20 s) to ``make_server(svc)``: the service without the
batcher, as the script served it. One warm request first. The result is
``SERVE_r3.json``'s ``sustained_http_load`` (requests/s, users/s,
p50/p90/p99 ms), plus ``EXTRA_KEYS``: the card, the host, the answers
checked (each against the plain top-K after the window) and ``profile``,
one more window of ``profile_s`` under ``torch.profiler``
(``_load.profile_window``: how much of a request's latency is spent in the
CUDA runtime's copies and stream waits).

    python -m gnn_ecommerce_tpu_torch.runs.serve_sustained_r3 -d DATA_DIR -c CKPT_DIR [--out x.json]
"""
from __future__ import annotations

import sys

import numpy as np

from . import _load
from ._cli import cli

WINDOW_S = 20.0
CLIENTS = 8
BATCH = 64
PROFILE_S = 5.0
EXTRA_KEYS = {"device", "host", "answers", "profile"}


def run(svc, window_s: float = WINDOW_S, clients: int = CLIENTS, batch: int = BATCH,
        profile_s: float = PROFILE_S) -> dict:
    """The sustained window on ``svc``; raises on a failed request or a
    wrong answer."""
    n_users = svc.prepared.n_users
    check = _load.AnswerCheck(svc.k)
    server = _load.Server(svc)
    try:
        _load.predict(server.base, np.random.default_rng(0).integers(0, n_users, batch))
        sl = _load.run_slice(server.port, n_users, batch, window_s, range(clients))
        sl.raise_errors("sustained window")
        profiled, profile = _load.profile_window(
            server.port, n_users, clients, batch, profile_s, svc.device
        )
    finally:
        server.close()
    check.check(sl.answers + profiled.answers, {"active": _load.Reference.of(svc)})
    # Each request's exclusion mask is [batch, mask_width] int32, copied to the card.
    profile["mask_width"] = svc._mask_width
    out = _load.window_summary(sl.latencies, sl.wall, clients, batch)
    _load.log(f"sustained: {out}")
    return {
        **out,
        "device": _load.card(svc.device),
        "host": _load.host(),
        "answers": check.stats(),
        "profile": profile,
    }


def main(argv=None) -> int:
    return cli(__doc__, argv, lambda svc, load_s, args: run(svc))


if __name__ == "__main__":
    sys.exit(main())
