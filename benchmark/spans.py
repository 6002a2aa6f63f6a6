"""The program's own spans (``gnn_ecommerce_tpu_torch/tracing.py``), read in
one recording pass after the traced window has closed.

The pass drives the driver's own hook with the tracer recording: a train
cell's ``time_steps``, ``STEPS`` steps in calls of the mix's
``steps_per_call`` (so the pass waits for the device as often as the window
does, and each call's host-bound sampler after that wait weighs as much), a
refresh cell's ``time_refreshes(REFRESHES)``. Its report is kept on the
driver's state, so that every reader of a run shares one pass; recording is
off again before the pass returns. Where the state has no such hook, or the
program no tracer or no span of that name (a program older than its spans),
the readers find nothing and return None.
"""
from __future__ import annotations

from benchmark.harness import log

STEPS = 16
REFRESHES = 8
# (the driver's hook, how many units it runs, the span of one unit)
PASSES = (("time_steps", STEPS, "train.step"), ("time_refreshes", REFRESHES, "serve.refresh"))


def report(ctx) -> dict | None:
    """The pass's ``tracing.report()`` with ``units`` (calls of the unit's
    span) and ``unit_ms`` (the hook's seconds a unit, recording on); None
    without a hook or a tracer."""
    st = ctx.state
    if "span_report" in vars(st):
        return st.span_report
    st.span_report = None
    try:
        from gnn_ecommerce_tpu_torch import tracing
    except ImportError:
        return None
    for hook, n, unit in PASSES:
        run = getattr(st, hook, None)
        if run is None:
            continue
        chunk = min(n, int(ctx.cell.mix.get("steps_per_call", n)))
        with tracing.recording():
            seconds = sum(run(chunk) for _ in range(n // chunk)) / (n // chunk)
        rep = tracing.report()
        rep["units"] = (rep["spans"].get(unit) or {}).get("calls", 0)
        rep["unit_ms"] = seconds * 1e3
        log(f"span pass: {hook}({chunk}) x {n // chunk} {rep['unit_ms']:.3f} ms a unit with recording on, "
            f"{rep['units']} {unit} spans")
        for name, s in sorted(rep["spans"].items()):
            log(f"  span {name}: {s}")
        st.span_report = rep
        break
    return st.span_report


def device_ms_per_unit(ctx, name: str) -> float | None:
    """Span ``name``'s device ms over the pass's units (train steps or
    refreshes); None where the pass recorded no such span or no device
    time."""
    rep = report(ctx)
    if not rep or not rep["units"]:
        return None
    s = rep["spans"].get(name)
    if not s or s["device_ms"] is None:
        return None
    return s["device_ms"] / rep["units"]
