"""The harness: finds a cell's configuration, mix, driver and metric readers by
name, runs one cell and builds its result line.

``BENCHMARK.json`` names everything. A cell (``workloads``) names a
configuration, whose ``file`` holds its sizes, and a traffic mix, which is
``benchmark/mixes/<traffic>.json``: parameters for the driver that the mix
names, ``benchmark/drivers/<driver>.py``. A per-layer metric is read by
``benchmark/metrics/<metric>.py``. Adding a cell, a configuration, a mix of
an existing driver or a metric is adding files and entries; nothing here
changes.

A driver module has five functions:

- ``setup(cell) -> state``: the inputs from the seed, the program built
  through its public entry points, every shape of the window warmed;
- ``window(cell, state, seconds) -> Window``: the measured window;
- ``release(cell, state)``: drops the program's device state before the
  reference runs;
- ``check(cell, state, window) -> {name: (number, limit)}``: the comparison
  with the plain reference (``benchmark/reference``); a run is correct when
  every number is at or under its limit;
- ``controls(cell) -> {kind: {number: value}}``: the same numbers with the
  control (the reference one precision down) and the driver's planted
  faults in the program's place, for ``tools/control.py``.

A metric reader has ``read(ctx) -> float | None``: ``ctx.state`` is the
driver's state, ``ctx.window`` the window, ``ctx.trace`` the profiler
trace's summary (``measure.Trace.summary``). A reader that finds nothing to
read returns None, and the metric is left out of the line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time

FOREIGN = ("jax", "jaxlib", "flax", "gnn_ecommerce_tpu")


@dataclasses.dataclass
class Window:
    """A measured window: the end-to-end metrics it measured, the work
    attempted and failed, and anything the check and readers need."""

    metrics: dict
    attempted: int
    failed: int
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    driver: object
    end_to_end: list
    per_layer: list
    seed: int
    seconds: float
    trace: bool
    device: str
    root: str


@dataclasses.dataclass
class Context:
    cell: Cell
    state: object
    window: Window
    trace: dict | None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: by its ``workloads``, or,
    without one, an end-to-end metric everywhere and a per-layer metric
    wherever its ``moves`` is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def find_cell(root: str, name: str, seed: int, seconds: float, trace: bool, device: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(root, "benchmark", "mixes", f"{entry['traffic']}.json"))
    driver = load_module(os.path.join(root, "benchmark", "drivers", f"{mix['driver']}.py"),
                         f"benchmark_driver_{mix['driver']}")
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name, entry, config, mix, driver, e2e, layer, int(seed), float(seconds), bool(trace),
                device, root)


def foreign_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def read_layers(cell: Cell, ctx: Context) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = load_module(os.path.join(cell.root, "benchmark", "metrics", f"{m['name']}.py"),
                             f"benchmark_metric_{m['name'].replace('.', '_')}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        log(f"per-layer {m['name']}: {value}")
    return out


def run_cell(cell: Cell, t_start: float) -> dict:
    """Set up, measure, read and check one run of ``cell``; returns the
    result line's object (the checks under ``checks``, last)."""
    import torch

    from .measure import Trace

    cuda = cell.device.startswith("cuda")
    log(f"cell {cell.name}: seed {cell.seed}, {cell.seconds} s, trace {int(cell.trace)}, {cell.device}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = cell.driver.setup(cell)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s")
    trace = Trace() if cell.trace and cuda else None
    with trace or contextlib.nullcontext():
        win = cell.driver.window(cell, state, cell.seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {win.metrics}, attempted {win.attempted}, failed {win.failed}")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": int(win.attempted), "failed": int(win.failed)}
    breakdown = None
    if cell.trace:
        summary = trace.summary() if trace is not None else None
        metrics = read_layers(cell, Context(cell, state, win, summary))
        if summary is not None:
            device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        e2e = {**win.metrics, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    cell.driver.release(cell, state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.driver.check(cell, state, win)
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    result.update(correct=correct, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result


def finite(x):
    """JSON has no infinity: an infinite number compared is written as a
    string."""
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def print_result(result: dict) -> None:
    """The checks as the last lines of stderr, then the result as the last
    line of stdout."""
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = {k: {kk: finite(vv) for kk, vv in c.items()} for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
