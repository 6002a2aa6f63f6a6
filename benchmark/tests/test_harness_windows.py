"""The windows' arithmetic: request percentiles timed from when each request
was due, a failed request counted as the longest, and the rates of the
closed-loop windows (the window's seconds over the work it completed)."""
import types

import numpy as np
import pytest

from benchmark import harness

from conftest import REPO


def driver(name):
    return harness.load_module(f"{REPO}/benchmark/drivers/{name}.py", f"d_{name}")


def test_percentiles_from_due_time():
    d = driver("rest_open_loop")
    # due, sent, done, status, items: sent late does not shorten a latency.
    reqs = [[k * 0.01, k * 0.01 + 0.005, k * 0.01 + 0.002 * (k + 1), 200, [[1]]] for k in range(100)]
    s = d.latency_summary(reqs, timeout_s=60)
    lat = sorted(0.002 * (k + 1) for k in range(100))
    assert s["request_p50_ms"] == pytest.approx(lat[50] * 1e3)
    assert s["request_p99_ms"] == pytest.approx(lat[99] * 1e3)
    assert s["late_p50_ms"] == pytest.approx(5.0) and s["failed"] == 0


def test_failed_request_counts_as_the_longest():
    d = driver("rest_open_loop")
    reqs = [[0.0, 0.0, 0.001, 200, [[1]]] for _ in range(99)] + [[0.5, 0.5, 0.6, 0, None]]
    s = d.latency_summary(reqs, timeout_s=60)
    assert s["failed"] == 1
    assert s["request_p99_ms"] == pytest.approx(60_000.0)
    assert s["request_p50_ms"] == pytest.approx(1.0)


class Clock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_train_window_rate(monkeypatch):
    d = driver("train_steps")
    clock = Clock(0.1)
    monkeypatch.setattr(d.time, "perf_counter", clock)
    calls = []

    def run_steps(params, opt, fb, sdata, gen, n):
        calls.append(n)
        return params, opt, {"loss": 0.5, "dropped_arcs": 0.0}

    st = types.SimpleNamespace(params=None, opt_state=None, fb=None, sdata=None, gen=None, run_steps=run_steps)
    cell = types.SimpleNamespace(mix={"steps_per_call": 4})
    win = d.window(cell, st, seconds=1.0)
    steps = 4 * len(calls)
    assert win.attempted == steps and win.failed == 0
    # The clock reads once at the start, once after each call, once at the end.
    assert win.metrics["train_step_ms"] == pytest.approx((len(calls) + 1) * 0.1 / steps * 1e3)


def test_refresh_window_rate(monkeypatch):
    d = driver("refresh_swap")
    monkeypatch.setattr(d.time, "perf_counter", Clock(0.05))
    swapped = []
    svc = types.SimpleNamespace(refresh=lambda p: swapped.append(p["embedding"]), final_emb=None)
    st = types.SimpleNamespace(svc=svc, params={"table": {"embedding": "A"}, "table_b": {"embedding": "B"}},
                               last={})
    win = d.window(None, st, seconds=1.0)
    assert swapped[:4] == ["B", "A", "B", "A"]
    assert win.attempted == len(swapped) and set(st.last) == {"table", "table_b"}
    assert win.metrics["refresh_ms"] == pytest.approx((len(swapped) + 1) * 0.05 / len(swapped) * 1e3)


def test_answered_rows_keep_malformed_answers():
    d = driver("rest_open_loop")
    win = harness.Window({}, 3, 1, {"requests": [[0, 0, 1, 200, [[1, 2]]], [0, 0, 1, 0, None],
                                                   [0, 0, 1, 200, [[3, 4]]]],
                                      "ids": [np.array([5]), np.array([6]), np.array([7, 8])]})
    users, rows = d.answered(win)
    assert list(users) == [5, 7, 8] and rows == [[1, 2], None, None]
