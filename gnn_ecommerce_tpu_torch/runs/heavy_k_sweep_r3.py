"""Port of ``scripts/heavy_k_sweep_r3.py``: both sparse directions of the
fast pair at root ``bench.py``'s shape for dense heavy-user heads of K in
{0, 8192, 16384, 32768} users, plans only, no B_ii resident
(``scripts/heavy_k_sweep_r3.json``). The head is the one knob that trades
device memory for ``fast_to_users`` time.

For each K: ``build_fast_ops(split, "bfloat16", heavy_users=K,
heavy_dtype="bfloat16" if K else "float32")`` (its seconds, synchronized),
then ``fast_to_items`` on ``x_u`` and ``fast_to_users`` on ``x_i`` (dim 80,
``default_rng(0)`` and ``default_rng(1)`` normals in f32) timed by the
probes' timer, each output held, outside the timed calls, to an f32
``torch.sparse.mm`` of the same normalized arcs: elementwise within
``BF16_TOL`` of ``Â·|x|`` (two bf16 roundings in a product, the message
and the weight or head entry, are 2^-7 of it; the rest is room for the
f32 sums' order), and the K's plans freed before the next. Only
``fast_to_items`` reaches a TPU kernel: K1 bf16 and its cast
(``to_users`` is the ELL plus the head). Each record has the script's keys
plus ``RECORD_KEYS`` (its launches in the timed calls and its check); the
line is ``{"results": [...]}`` plus ``EXTRA_KEYS`` (the card, the launches
of the whole run and the bars, ``bars.heavy_k_sweep_r3``: every output held
and every number finite).

    python -m gnn_ecommerce_tpu_torch.runs.heavy_k_sweep_r3 [--device cuda] [--out x.json]
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..ops.bipartite import BipartiteSplit, build_fast_ops, fast_to_items, fast_to_users, split_graph
from ..probes._timing import time_ms
from . import _load, bars
from ._cli import emit, launches_since, quality_parser

KS = (0, 8192, 16384, 32768)
DIM = 80
REPS = 10
BF16_TOL = 2.0**-6
RECORD_KEYS = {"launches", "check"}
EXTRA_KEYS = {"device", "launches", "bars"}


def inputs(split: BipartiteSplit, dev, dim: int = DIM) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's ``x_u`` and ``x_i``: f32 normals from ``default_rng(0)``
    and ``default_rng(1)``."""
    x_u = np.random.default_rng(0).standard_normal((split.n_users, dim)).astype(np.float32)
    x_i = np.random.default_rng(1).standard_normal((split.n_items, dim)).astype(np.float32)
    return torch.from_numpy(x_u).to(dev), torch.from_numpy(x_i).to(dev)


def reference_operators(split: BipartiteSplit, dev) -> dict:
    """The normalized arcs as f32 CSR matrices: ``to_items`` [n_items,
    n_users] (the split's users → items arcs, sorted by item) and
    ``to_users`` [n_users, n_items] (its items → users CSR)."""
    item_ptr = np.searchsorted(split.ui_dst_item, np.arange(split.n_items + 1))

    def csr(crow, col, w, shape):
        return torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(crow, np.int64)), torch.from_numpy(np.asarray(col, np.int64)),
            torch.from_numpy(np.asarray(w, np.float32)), shape,
        ).to(dev)

    return {
        "to_items": csr(item_ptr, split.ui_src_user, split.ui_w, (split.n_items, split.n_users)),
        "to_users": csr(split.iu_indptr, split.iu_src_item, split.iu_w, (split.n_users, split.n_items)),
    }


def check(out: torch.Tensor, op: torch.Tensor, x: torch.Tensor, tol: float = BF16_TOL) -> dict:
    """``out`` against ``op @ x`` in f32: its largest error, that error over
    what ``tol · (op @ |x|)`` allows (``ratio`` ≤ 1 holds), and the relative
    Frobenius distance."""
    ref = torch.sparse.mm(op, x)
    allowed = tol * torch.sparse.mm(op, x.abs()) + 1e-6 * ref.abs().max()
    diff = (out - ref).abs()
    res = {
        "max_abs_err": diff.max().item(),
        "ratio": (diff / allowed).max().item(),
        "rel_frobenius": ((out - ref).norm() / ref.norm()).item(),
        "tol": tol,
    }
    res["held"] = bool(out.shape == ref.shape and res["ratio"] <= 1.0)
    return res


def bench_graph(dev):
    """Root ``bench.py``'s graph on ``dev`` (``bench.shape_for``: its shape
    on the card, a tiny one on the CPU)."""
    s = bench.shape_for(dev)
    return bench.build_synthetic_graph(s["n_users"], s["n_items"], s["n_edges"], device=dev)[0]


def run(split: BipartiteSplit, ks=KS, reps: int = REPS, device="cuda", hold=None) -> list[dict]:
    """One record a K. ``hold(k, fops, x_u)``, where given, is called with
    each K's plans before they are freed."""
    dev = resolve_device(device)
    x_u, x_i = inputs(split, dev)
    ops = reference_operators(split, dev)
    records = []
    for k in ks:
        t0 = time.perf_counter()
        fops = build_fast_ops(
            split, msgs_dtype="bfloat16", heavy_users=k,
            heavy_dtype="bfloat16" if k else "float32", device=dev,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        head_gb = 0.0 if fops.w_hi is None else fops.w_hi.numel() * fops.w_hi.element_size() / 1e9
        with torch.no_grad(), launches_since() as launches:
            t_items = time_ms(lambda: fast_to_items(x_u, fops), dev, reps=reps)
            t_users = time_ms(lambda: fast_to_users(x_i, fops), dev, reps=reps)
        with torch.no_grad():
            held = {
                "to_items": check(fast_to_items(x_u, fops), ops["to_items"], x_u),
                "to_users": check(fast_to_users(x_i, fops), ops["to_users"], x_i),
            }
            if hold is not None:
                hold(k, fops, x_u)
        rec = {
            "K": k,
            "head_gb_bf16": head_gb,
            "to_items_ms": t_items,
            "to_users_ms": t_users,
            "pair_ms": t_items + t_users,
            "plan_build_s": build_s,
            "launches": launches,
            "check": held,
        }
        _load.log(f"heavy K {k}: {rec}")
        records.append(rec)
        del fops
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    args = quality_parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    with launches_since() as launches:
        split = split_graph(bench_graph(dev))
        results = run(split, device=dev)
    line = {"results": results, "device": _load.card(dev), "launches": launches}
    return emit(bars.hold(line, bars.BARS["heavy_k_sweep_r3"](line)), args.out)


if __name__ == "__main__":
    sys.exit(main())
