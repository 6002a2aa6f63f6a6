"""``request_p99_ms.serve``: the 99th percentile of the window's requests,
each from its due time to its parsed answer, a failed one counted as the
longest (``drivers/rest_open_loop.py:latency_summary``). Recorded, not
bounded: on the card's shared host its run-to-run spread is far wider than
any bound (``PERF.md`` §2)."""


def read(ctx):
    summary = (getattr(ctx.window, "extra", None) or {}).get("summary")
    return None if not summary else summary["request_p99_ms"]
