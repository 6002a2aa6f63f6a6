"""Spans and counters at the port's layer boundaries, off unless read.

``span(name)`` marks one layer::

    with tracing.span("train.sample"):
        users, pos, neg = sample_batch(...)

Names are dotted after the layer they time (``train.*``, ``ops.*``,
``serve.refresh*``, ``setup.*``). A span does nothing, and allocates
nothing, unless a torch profiler is active or a :func:`recording` block is
open; no environment variable or flag turns it on.

- Under an active profiler the span is a ``FUNCTION``-scope host event on
  kineto's clock (``torch._C._profiler._RecordFunctionFast``), so a trace's
  idle gaps and operators carry the layer's name. Not
  ``torch.profiler.record_function``: its user annotation gets a device-side
  twin on CUDA, which a reader of the raw events would count as device work.
- Inside ``recording()`` the span is kept in memory: its name, thread,
  parent (a stack per thread, since autograd's backward runs on its own
  thread), host start and end, and on CUDA a pair of timing events on the
  current stream. :func:`report` sums them by name.

``mark(name)`` is a span for the profiler's timeline alone, and
``count(name, n)`` adds to a counter inside ``recording()``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_profiler_enabled = torch._C._autograd._profiler_enabled

_lock = threading.Lock()
_local = threading.local()
_on = False
_spans: list = []
_counters: dict = {}
_pool: list = []  # CUDA timing events of spans already reported


_OFF = contextlib.nullcontext()  # the span of every call while nothing reads spans


class _Record:
    __slots__ = ("name", "thread", "parent", "start_ns", "end_ns", "child_ns", "events", "device_ms")

    def __init__(self, name: str, parent):
        self.name, self.thread, self.parent = name, threading.get_ident(), parent
        self.start_ns = self.end_ns = self.child_ns = 0
        self.events = self.device_ms = None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    with _lock:
        if _pool:
            return _pool.pop()
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "_fn", "_rec")

    def __init__(self, name: str):
        self.name, self._fn, self._rec = name, None, None

    def __enter__(self):
        if _profiler_enabled():
            self._fn = _RecordFunctionFast(self.name)
            self._fn.__enter__()
        if _on:
            stack = _stack()
            rec = _Record(self.name, stack[-1] if stack else None)
            if torch.cuda.is_initialized():
                rec.events = (_event(), _event())
                rec.events[0].record()
            stack.append(rec)
            self._rec = rec
            rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            rec.end_ns = time.perf_counter_ns()
            if rec.events is not None:
                rec.events[1].record()
            _stack().pop()
            if rec.parent is not None:
                rec.parent.child_ns += rec.end_ns - rec.start_ns
            with _lock:
                _spans.append(rec)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work (see the module's doc)."""
    if not _on and not _profiler_enabled():
        return _OFF
    return _Span(name)


def mark(name: str):
    """A span on a profiler's timeline alone, never recorded: for work cut
    finer than any reader of :func:`report` needs, where recording each
    piece would cost more than the piece (the sampler's halving steps)."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def _drop_kept() -> None:
    """Forget what was recorded; the spans' events go back to the pool."""
    for rec in _spans:
        if rec.events is not None:
            _pool.extend(rec.events)
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def recording():
    """Keep spans and counters in memory inside the block. What an earlier
    block kept is dropped when this one opens, and kept for
    :func:`report` after it closes."""
    global _on
    with _lock:
        _drop_kept()
        _on = True
    try:
        yield
    finally:
        _on = False


def report() -> dict:
    """What was recorded, by name: ``{"spans": {name: {"calls", "host_ms",
    "self_host_ms", "device_ms"}}, "counters": {name: n}}``.

    ``host_ms`` sums each span's host duration and ``self_host_ms`` that less
    what its child spans cover. ``device_ms`` sums each span's stream
    interval, between its two CUDA events (None for spans without them,
    off CUDA). Waits for the device once."""
    with _lock:
        spans, counters = list(_spans), dict(_counters)
    if any(rec.events is not None for rec in spans):
        torch.cuda.synchronize()
    with _lock:
        for rec in spans:
            if rec.events is not None:
                rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
                _pool.extend(rec.events)
                rec.events = None
    out = {}
    for rec in spans:
        s = out.setdefault(rec.name, {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0, "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += (rec.end_ns - rec.start_ns) / 1e6
        s["self_host_ms"] += (rec.end_ns - rec.start_ns - rec.child_ns) / 1e6
        if rec.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + rec.device_ms
    return {"spans": out, "counters": counters}
