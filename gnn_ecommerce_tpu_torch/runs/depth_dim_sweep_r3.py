"""Port of ``scripts/depth_dim_sweep_r3.py``: the depth and width of the
bipartite-factorized forward at root ``bench.py``'s shape
(``scripts/depth_dim_sweep_r3.json``).

- ``layered``: ``get_embedding`` on the graph, propagating through
  ``propagate_segment_chunked(g, x, 8)``, at 4 and 5 layers, dim 80, 2
  timed calls each;
- ``fast``: ``fast_get_embedding`` on ``FastBipartite(split, B_ii in bf16
  (1.5 GB bands), build_fast_ops(split, "bfloat16", heavy_users=16384,
  heavy_dtype="bfloat16"))`` at dim {80, 90} × layers {4, 5}, 10 timed
  calls each; the parameters are drawn once a dim (seed 0) and serve both
  depths, as in the script.

The layered forwards run first and their graph-sized temporaries go before
B_ii is built. Each fast corner is held, outside its timed calls, to the
layered f32 forward on the same parameters (each dim's layer stack
propagated once, untimed where the sweep does not time it): the relative
Frobenius distance within ``BF16_FORWARD_REL``, the bound that
``chip_smoke.py`` holds the main configuration's bf16 forward to. On the
card each odd layer adds one B_ii GEMM, and dim 90 makes the pair GEMM's
right-hand side 360-byte rows (dim 80: 320), which are not 16-byte aligned.
The fast corners launch K1 bf16 and its cast; the layered forward no TPU
kernel. Each record has the script's keys (``layers``, ``dim``, ``ms``)
plus ``RECORD_KEYS`` (its launches in the timed calls and, for a fast
corner, its check); the line is ``{"layered": [...], "fast": [...]}`` plus
``EXTRA_KEYS`` (the card, the whole run's launches and the bars,
``bars.depth_dim_sweep_r3``: every output held and every number finite).

    python -m gnn_ecommerce_tpu_torch.runs.depth_dim_sweep_r3 [--device cuda] [--out x.json]
"""
from __future__ import annotations

import gc
import sys

import torch

from ..device import resolve_device
from ..graph.build import BipartiteGraph
from ..models.lightgcn import LightGCNConfig, get_embedding, init_params
from ..ops.bipartite import (
    FastBipartite,
    build_fast_ops,
    build_item_operator,
    fast_get_embedding,
    split_graph,
)
from ..ops.propagate import propagate_segment_chunked
from ..probes._timing import time_ms
from . import _load, bars
from ._cli import emit, launches_since, quality_parser
from .heavy_k_sweep_r3 import bench_graph

LAYERED = (4, 5)
LAYERED_DIM = 80
DIMS = (80, 90)
LAYERS = (4, 5)
REPS_LAYERED, REPS_FAST = 2, 10
CHUNKS = 8
HEAVY_USERS = 16_384
BAND_BYTES = 1.5e9
BF16_FORWARD_REL = 5e-2
RECORD_KEYS = {"launches", "check"}
EXTRA_KEYS = {"device", "launches", "bars"}


def params_for(graph: BipartiteGraph, dim: int, dev) -> dict:
    """The sweep's parameters at ``dim``: seed 0, the same for every depth."""
    cfg = LightGCNConfig(num_nodes=graph.num_nodes, embedding_dim=dim, num_layers=max(LAYERS))
    return init_params(torch.Generator().manual_seed(0), cfg, device=dev)


def chunked(g, x):
    return propagate_segment_chunked(g, x, CHUNKS)


def layered_references(params: dict, graph: BipartiteGraph, depths) -> dict:
    """The layered f32 forward at each depth of ``depths`` from one layer
    stack: ``Σ_{l ≤ L} x_l / (L + 1)``."""
    x = params["embedding"]
    sums, refs = x.clone(), {}
    for layer in range(1, max(depths) + 1):
        x = chunked(graph, x)
        sums += x
        if layer in depths:
            refs[layer] = sums / (layer + 1)
    return refs


def relative(out: torch.Tensor, ref: torch.Tensor, tol: float = BF16_FORWARD_REL) -> dict:
    rel = ((out.float() - ref).norm() / ref.norm()).item()
    return {"rel_frobenius": rel, "tol": tol,
            "held": bool(out.shape == ref.shape and torch.isfinite(out).all().item() and rel <= tol)}


def run(graph: BipartiteGraph, device="cuda", fb: FastBipartite | None = None,
        layered=LAYERED, reps_layered: int = REPS_LAYERED, reps_fast: int = REPS_FAST) -> dict:
    """``{"layered": [...], "fast": [...]}``: the layered forward at each
    depth of ``layered`` (at ``LAYERED_DIM``), the fast one at each of
    ``DIMS`` × ``LAYERS``. ``fb``, where given, is the bf16 fast operator to
    time (built from ``graph`` otherwise)."""
    dev = resolve_device(device)
    out = {"layered": [], "fast": []}
    refs = {}
    with torch.no_grad():
        for dim in DIMS:
            params = params_for(graph, dim, dev)
            refs[dim] = layered_references(params, graph, set(LAYERS))
            if dim != LAYERED_DIM:
                continue
            for depth in layered:
                cfg = LightGCNConfig(num_nodes=graph.num_nodes, embedding_dim=dim, num_layers=depth)
                with launches_since() as launches:
                    ms = time_ms(lambda: get_embedding(params, graph, cfg, chunked), dev,
                                 reps=reps_layered)
                rec = {"layers": depth, "dim": dim, "ms": ms, "launches": launches}
                _load.log(f"layered {rec}")
                out["layered"].append(rec)
            del params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if fb is None:
            split = split_graph(graph)
            fb = FastBipartite(
                split=split,
                item_op=build_item_operator(split, dtype=torch.bfloat16, band_bytes=BAND_BYTES,
                                            device=dev),
                fops=build_fast_ops(split, "bfloat16", heavy_users=HEAVY_USERS,
                                    heavy_dtype="bfloat16", device=dev),
            )
        for dim in DIMS:
            params = params_for(graph, dim, dev)
            for depth in LAYERS:
                with launches_since() as launches:
                    ms = time_ms(lambda: fast_get_embedding(params, fb, depth), dev, reps=reps_fast)
                held = {"forward": relative(fast_get_embedding(params, fb, depth), refs[dim][depth])}
                rec = {"layers": depth, "dim": dim, "ms": ms, "launches": launches, "check": held}
                _load.log(f"fast {rec}")
                out["fast"].append(rec)
            del params
    return out


def main(argv=None) -> int:
    args = quality_parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    with launches_since() as launches:
        result = run(bench_graph(dev), dev)
    line = {**result, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["depth_dim_sweep_r3"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
