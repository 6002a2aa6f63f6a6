"""Shared fixtures of the harness's tests, and the ``card`` marker.

    python -m pytest benchmark/tests -q          # on the CPU: card tests skip
    python -m pytest benchmark/tests -q -m card  # on the card

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json``, with the serve
cell added, and the ``benchmark`` folder) whose configurations keep every key but shrink the
graph, the width and the heavy head, so that a whole run fits a test on the
CPU. At this size the program's readings stay under the cells' limits, as
they do at full size; at a much smaller one bf16's error is a larger share.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_GRAPH = {"n_users": 20000, "n_items": 1500, "n_edges": 120000}

# The serve cell is out of BENCHMARK.json until a rate holds on the card
# (PERF.md, Open questions); the tiny copy keeps it, so that its driver, the
# load generator and its readers stay tested.
SERVE = "cosmetics-d90-l5.serve"
SERVE_ENTRIES = {
    "workloads": [{"name": SERVE, "config": "lightgcn-cosmetics-d90-l5", "traffic": "serve", "chips": 1,
                   "why": "open-loop REST requests from another process"}],
    "end_to_end": [{"name": "request_p50_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [SERVE]}],
    "per_layer": [{"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
                   "moves": "request_p50_ms", "workloads": [SERVE]}
                  for name, unit, better, source, layer in (
                      ("device_idle_pct.serve", "%", "lower", "device_trace", "device"),
                      ("users_per_batch.serve", "users", "higher", "program_counter", "serve.batching"),
                      ("request_p99_ms.serve", "ms", "lower", "host_clock", "serve (HTTP, batcher, service)"))],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def make_tiny(root: str, serve_rate: float = 40.0) -> str:
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("_cache", "tests", "__pycache__"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    if not any(w["name"] == SERVE for w in bench["workloads"]):
        for key, entries in SERVE_ENTRIES.items():
            bench[key] += entries
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(REPO, c["file"])))
        cfg["graph"].update(TINY_GRAPH)
        cfg["model"]["embedding_dim"] = 32
        cfg["train"].update(heavy_users=256)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    path = os.path.join(root, "benchmark", "mixes", "serve.json")
    mix = json.load(open(path))
    mix.update(rate_per_s=serve_rate, warm_seconds=0.5)
    with open(path, "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(str(tmp_path))


def run_tiny(root: str, cell: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
             device: str = "cpu") -> dict:
    """One run of ``cell`` in ``root`` through the harness, the look for a
    card skipped."""
    from benchmark import harness

    t = time.perf_counter()
    return harness.run_cell(harness.find_cell(root, cell, seed, seconds, trace, device), t)
