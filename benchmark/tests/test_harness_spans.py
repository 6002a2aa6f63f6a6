"""The readers of the program's spans (``benchmark/spans.py``) on fake
contexts: each finds nothing without the driver's hook, the tracer or the
span, and otherwise the span's device ms over the pass's units; one
recording pass serves every reader of a run, and recording is off again
after it. The B_ii build readers read the program's own timer."""
import os
import sys
import types

import pytest

from benchmark import harness

from conftest import REPO

SPAN_READERS = {"sampler_ms.train": "train.sample", "batch_users_ms.train": "ops.batch_users",
                "backward_ms.train": "train.backward", "adam_ms.train": "train.adam",
                "to_users_ms.refresh": "ops.to_users"}


def metric(name):
    return harness.load_module(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"), f"s_{name}")


TRAIN_MIX = harness.load_json(os.path.join(REPO, "benchmark", "mixes", "train.json"))


def ctx_of(state, mix=None):
    return types.SimpleNamespace(cell=types.SimpleNamespace(mix=mix or {}), state=state, window=None, trace=None)


def fake_report(unit, units, device_ms):
    spans = {unit: {"calls": units, "host_ms": 1.0, "self_host_ms": 0.0, "device_ms": 100.0}}
    spans.update({name: {"calls": units, "host_ms": 1.0, "self_host_ms": 1.0, "device_ms": ms}
                  for name, ms in device_ms.items()})
    return {"spans": spans, "counters": {}}


@pytest.mark.parametrize("hook,unit,mix,calls", [
    ("time_steps", "train.step", TRAIN_MIX, [4] * 4),
    ("time_refreshes", "serve.refresh", {"driver": "refresh_swap"}, [8]),
])
def test_one_pass_serves_every_reader(monkeypatch, hook, unit, mix, calls):
    """A train cell's pass runs in the window's calls of ``steps_per_call``
    steps, each ending in its own wait for the device."""
    from gnn_ecommerce_tpu_torch import tracing

    runs = []

    def run(n):
        runs.append((n, tracing._on))
        return 0.05

    device_ms = {span: 8.0 * (k + 1) for k, span in enumerate(SPAN_READERS.values())}
    monkeypatch.setattr(tracing, "report", lambda: fake_report(unit, 4, device_ms))
    ctx = ctx_of(types.SimpleNamespace(**{hook: run}), mix)
    for name, span in SPAN_READERS.items():
        assert metric(name).read(ctx) == pytest.approx(device_ms[span] / 4), name
    assert runs == [(n, True) for n in calls]
    assert not tracing._on
    assert ctx.state.span_report["unit_ms"] == pytest.approx(50.0)


def test_nothing_without_hook_tracer_or_span(monkeypatch):
    from gnn_ecommerce_tpu_torch import tracing

    for name in SPAN_READERS:
        assert metric(name).read(ctx_of(types.SimpleNamespace())) is None, name
    # A hook, but its pass recorded no span (a program without spans), or
    # spans without device time (off CUDA).
    st = types.SimpleNamespace(time_steps=lambda n: 0.01)
    for name in SPAN_READERS:
        assert metric(name).read(ctx_of(st)) is None, name
    monkeypatch.setattr(tracing, "report", lambda: fake_report("train.step", 16, {"train.sample": None}))
    assert metric("sampler_ms.train").read(ctx_of(types.SimpleNamespace(time_steps=lambda n: 0.01))) is None
    # A program with no tracer at all.
    import gnn_ecommerce_tpu_torch

    monkeypatch.delattr(gnn_ecommerce_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "gnn_ecommerce_tpu_torch.tracing", None)
    st = types.SimpleNamespace(time_steps=lambda n: 0.01)
    assert metric("adam_ms.train").read(ctx_of(st)) is None and st.span_report is None


def test_recording_pass_on_the_cpu():
    """The real tracer over a hook that runs spans: every span kept, no
    device time off CUDA, so the readers find nothing."""
    from gnn_ecommerce_tpu_torch import tracing

    def run(n):
        for _ in range(n):
            with tracing.span("train.step"), tracing.span("train.sample"):
                pass
        return 0.001

    ctx = ctx_of(types.SimpleNamespace(time_steps=run))
    assert metric("sampler_ms.train").read(ctx) is None
    rep = ctx.state.span_report
    assert rep["units"] == 16 and rep["spans"]["train.sample"]["calls"] == 16
    assert rep["spans"]["train.sample"]["device_ms"] is None


def test_b_ii_build_readers():
    fb = types.SimpleNamespace(build_seconds={"plans": 1.5, "item_op": 24.25})
    assert metric("b_ii_build_s.train").read(ctx_of(types.SimpleNamespace(fb=fb))) == 24.25
    svc = types.SimpleNamespace(fast_bipartite=fb)
    assert metric("b_ii_build_s.refresh").read(ctx_of(types.SimpleNamespace(svc=svc))) == 24.25
    for name in ("b_ii_build_s.train", "b_ii_build_s.refresh"):
        assert metric(name).read(ctx_of(types.SimpleNamespace())) is None
        assert metric(name).read(ctx_of(types.SimpleNamespace(fb=None, svc=None))) is None
