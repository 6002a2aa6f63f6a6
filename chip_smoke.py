"""Drive the PyTorch port's serving path on one H100 and hold its CUDA kernel
against its plain version.

    python3 chip_smoke.py [--seed 0]

Phases, one printed line each (plus detail lines):
  0 device   the card's name and power limit (nvidia-smi), TF32 off
  1 build    nvcc builds csrc/segreduce.cu for sm_90a
  2 data     a full-scale synthetic corpus made from --seed: 1,552,888 users x
             54,571 items, 9,649,537 train edges, Zipf(0.9) item popularity,
             power-law user degrees (the 16,384 heaviest users hold about a
             fifth of the arcs), a purchase CSR for the request masks
  3 kernel   the segment-reduce kernel against its plain version at D=90:
             f32 over all user->item arcs (the service's run) and bf16 over
             the tail left by the 16,384-user head (the main configuration's
             run); kernel, plain and torch.sparse.mm times and the bound
  4 forward  the RecommenderService (dim 90, 5 layers, f32) propagates once
             through the fast forward; its cache is held against the layered
             get_embedding on the card; forward time and a profiler breakdown
  5 bf16     the main configuration's forward (bf16 B_ii, messages and a
             16,384-user head) against the f32 forward; time and breakdown
  6 serve    the REST server with the batcher answers :predict requests of
             1, 8, 64 and 512 users (300 timed per size, p50/p90/p99), each
             answer checked against a plain top-K
  7 kernels  one JSON line per the port's kernels, with the launches counted
             over phases 4-6 (the main path)
The last line is {"ok": true, "device": {...}}. Any failed check raises.
Without CUDA, or without the repository around this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit, PreparedData, SamplerArrays
from gnn_ecommerce_tpu_torch.device import mm_f32, resolve_device
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, get_embedding, init_params
from gnn_ecommerce_tpu_torch.ops._kernels import SEGREDUCE
from gnn_ecommerce_tpu_torch.ops.bipartite import (
    build_fast_bipartite,
    fast_get_embedding,
    split_graph,
    split_heavy_users,
)
from gnn_ecommerce_tpu_torch.ops.spmm_fast import build_segreduce_plan, segreduce_plain
from gnn_ecommerce_tpu_torch.serve import BatchingRecommender, RecommenderService, make_server

N_USERS, N_ITEMS, N_EDGES = 1_552_888, 54_571, 9_649_537
DIM, LAYERS, HEAVY_USERS = 90, 5, 16_384
# Timed requests per size, after a few untimed ones; each answer is checked
# after the timing, so the check does not sit between two requests.
REQUESTS_PER_SIZE, WARMUP_REQUESTS = 300, 5
ITEM_SKEW, USER_SKEW = 0.9, 0.75
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def phase(n: int, name: str, t0: float, detail: str = "") -> None:
    print(f"phase {n} {name}: {time.perf_counter() - t0:.2f} s {detail}".rstrip(), flush=True)


def zipf_ranks(rng: np.random.Generator, n: int, m: int, a: float) -> np.ndarray:
    """m draws of ranks in [0, n) with P(rank r) ∝ (r+1)^-a (inverse CDF of
    the continuous power law, a < 1)."""
    span = (n + 1.0) ** (1.0 - a) - 1.0
    r = (1.0 + rng.random(m) * span) ** (1.0 / (1.0 - a))
    return np.minimum(r.astype(np.int64) - 1, n - 1)


def make_prepared(seed: int, n_users: int, n_items: int, n_edges: int) -> PreparedData:
    """Unique (user, item) edges: one per user, the rest drawn with power-law
    user activity and Zipf item popularity; about 15% purchases (weight 1.0),
    the rest view/cart weights."""
    rng = np.random.default_rng(seed)
    user_of_rank = rng.permutation(n_users)
    base = np.arange(n_users, dtype=np.int64) * n_items + zipf_ranks(rng, n_items, n_users, ITEM_SKEW)
    extra = np.empty(0, np.int64)
    while len(extra) < n_edges - n_users:
        m = int((n_edges - n_users - len(extra)) * 1.3) + 1000
        draw = user_of_rank[zipf_ranks(rng, n_users, m, USER_SKEW)] * n_items
        draw += zipf_ranks(rng, n_items, m, ITEM_SKEW)
        extra = np.setdiff1d(np.concatenate([extra, draw]), base)
    keys = np.sort(np.concatenate([base, rng.permutation(extra)[: n_edges - n_users]]))
    users, items = keys // n_items, keys % n_items
    weight = rng.choice(
        np.array([0.01, 0.1, 0.11, 1.0], np.float32), size=len(keys), p=[0.7, 0.1, 0.05, 0.15]
    )
    buy = weight == 1.0
    pos_users, pos_start = np.unique(users[buy], return_index=True)
    pos_indptr = np.append(pos_start, int(buy.sum())).astype(np.int64)
    pos_flat = items[buy] + n_users  # keys are sorted: per-user sorted items
    empty = EvalSplit(
        user_ids=np.empty(0, np.int64),
        truth=CsrList(np.zeros(1, np.int64), np.empty(0, np.int64)),
        train_mask=CsrList(np.zeros(1, np.int64), np.empty(0, np.int64)),
    )
    return PreparedData(
        n_users=n_users,
        n_items=n_items,
        edge_user=users,
        edge_item_node=items + n_users,
        edge_weight=weight,
        sampler=SamplerArrays(pos_users, pos_indptr, pos_flat, pos_indptr, pos_flat),
        val=empty,
        test=empty,
        user_classes=np.arange(n_users),
        item_classes=np.arange(n_items),
    )


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(label: str, fn, top: int = 6) -> None:
    """One call of ``fn`` under torch.profiler: wall ms, summed kernel ms on
    the card, the idle share (1 - kernel/wall) and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(
        f"  profile {label}: wall_ms {wall_ms:.3f} kernel_ms {busy_ms:.3f} "
        f"idle_share {1 - busy_ms / wall_ms:.3f}",
        flush=True,
    )
    for e in kernels[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} {e.key[:90]}")


def check_kernel(name: str, table: torch.Tensor, plan) -> dict:
    """Kernel against its plain version on the same inputs, then times."""
    out = SEGREDUCE(table, plan)
    ref = segreduce_plain(table, plan)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)
    # Largest error as a share of what the check allows (< 1 passes).
    margin = ((out - ref).abs() / (1e-5 * scale + 1e-4 * ref.abs())).max().item()
    # Both against an f64 sum of the same products: only summation order and
    # f32 rounding differ (the plain version's index_add_ adds in no fixed order).
    w64 = (plan.w if table.dtype == torch.float32 else plan.w.to(torch.bfloat16)).double()
    ref64 = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float64, device=table.device)
    ref64.index_add_(0, plan.dst, table.index_select(0, plan.src).double() * w64[:, None])
    f64_kernel = (out.double() - ref64).abs().max().item()
    f64_plain = (ref.double() - ref64).abs().max().item()
    del out, ref, ref64
    n_arcs, d = plan.src.numel(), table.shape[1]
    elt = table.element_size()
    rows_read = torch.unique(plan.src).numel()
    # Each input once: the referenced table rows, index and weight per arc,
    # the chunk pointers; the output written once.
    bytes_once = (
        rows_read * d * elt + n_arcs * 8 + (plan.n_chunks + plan.n_out + 2) * 8
        + plan.n_out * d * 4
    )
    # Each arc reads its own row (no reuse across arcs).
    bytes_gather = n_arcs * d * elt + n_arcs * 8 + plan.n_out * d * 4
    flops = 2 * n_arcs * d
    bound_ms = max(bytes_once / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    kernel_ms = time_ms(lambda: SEGREDUCE(table, plan))
    plain_ms = time_ms(lambda: segreduce_plain(table, plan))
    crow = torch.zeros(plan.n_out + 1, dtype=torch.int64, device=table.device)
    crow[1:] = torch.cumsum(torch.bincount(plan.dst, minlength=plan.n_out), 0)
    csr = torch.sparse_csr_tensor(
        crow, plan.src.long(), plan.w, size=(plan.n_out, table.shape[0])
    )
    dense = table.float()
    library_ms = time_ms(lambda: torch.sparse.mm(csr, dense))
    print(
        f"  {name}: arcs {n_arcs} chunks {plan.n_chunks} rows_read {rows_read} "
        f"max_abs_err {err:.3e} (max |ref| {scale:.3e}, check margin {margin:.3f}; "
        f"vs f64: kernel {f64_kernel:.3e} plain {f64_plain:.3e}) "
        f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
        f"bytes_once {bytes_once} bytes_gather {bytes_gather} bound_ms {bound_ms:.4f} "
        f"gather_bound_ms {bytes_gather / HBM_BYTES_PER_S * 1e3:.4f}",
        flush=True,
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "gnn_ecommerce_tpu_torch/csrc/segreduce.cu",
        "replaces": "gnn_ecommerce_tpu/ops/spmm_fast.py:274",
        "launches": 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_once / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations",
        "library_ms": library_ms,
        "gather_bound_ms": bytes_gather / HBM_BYTES_PER_S * 1e3,
        "arcs": n_arcs,
    }


def plain_topk(emb, ids, prepared, k):
    """Reference answer: full scores, purchased items masked, torch.topk."""
    n_users = prepared.n_users
    scores = mm_f32(emb[ids], emb[n_users:].T)
    s = prepared.sampler
    slots = np.minimum(np.searchsorted(s.users, ids), len(s.users) - 1)
    rows = np.flatnonzero(s.users[slots] == ids)
    lo, hi = s.pos_indptr[slots[rows]], s.pos_indptr[slots[rows] + 1]
    n = hi - lo
    flat = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
    scores[
        torch.as_tensor(np.repeat(rows, n), device=scores.device),
        torch.as_tensor(s.pos_flat[flat] - n_users, device=scores.device),
    ] = -float("inf")
    vals, idx = torch.topk(scores, k, dim=1)
    return scores, vals.cpu(), idx.cpu()


def check_answer(items, scores, vals, idx):
    """Same top-K sets as the plain answer, except items tied with its k-th
    score."""
    for row, got in enumerate(items):
        want = set(idx[row].tolist())
        if set(got) == want:
            continue
        kth = vals[row, -1].item()
        for item in set(got) ^ want:
            assert abs(scores[row, item].item() - kth) <= 1e-6 * abs(kth), (row, item)


def post(url: str, body) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the corpus and weights")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device(torch.device("cuda", 0))
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    phase(0, "device", t0, f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    SEGREDUCE.load()
    phase(1, "build", t0)
    for line in SEGREDUCE.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    prepared = make_prepared(args.seed, N_USERS, N_ITEMS, N_EDGES)
    graph_host = build_graph(
        prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
        prepared.n_users, prepared.n_items, items_offset=True, device="cpu",
    )
    split = split_graph(graph_host)
    deg = np.bincount(split.ui_src_user, minlength=prepared.n_users)
    head_share = np.sort(deg)[::-1][:HEAVY_USERS].sum() / len(split.ui_src_user)
    phase(
        2, "data", t0,
        f"users {prepared.n_users} items {prepared.n_items} edges {len(prepared.edge_user)} "
        f"head share {head_share:.4f} buyers {len(prepared.sampler.users)}",
    )

    cfg = LightGCNConfig(prepared.n_users + prepared.n_items, DIM, LAYERS)
    params = init_params(torch.Generator().manual_seed(args.seed), cfg, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        E_u = params["embedding"][: prepared.n_users]
        full_plan = build_segreduce_plan(
            split.ui_src_user, split.ui_dst_item, split.ui_w, split.n_items, device=dev
        )
        rows = [check_kernel("segreduce_f32", E_u, full_plan)]
        del full_plan
        _, w_hi, t_src, t_dst, t_w, *_ = split_heavy_users(split, HEAVY_USERS, "bfloat16", dev)
        del w_hi
        tail_plan = build_segreduce_plan(t_src, t_dst, t_w, split.n_items, device=dev)
        rows.append(check_kernel("segreduce_bf16", E_u.to(torch.bfloat16), tail_plan))
        del tail_plan, E_u
        torch.cuda.empty_cache()
        phase(3, "kernel", t0)

        # The main path: every launch count starts at 0 here.
        SEGREDUCE.launches = {mode: 0 for mode in SEGREDUCE.launches}
        t0 = time.perf_counter()
        svc = RecommenderService(prepared, params, cfg, k=20, device=dev)
        f32_launches = SEGREDUCE.launches["float32"]
        assert f32_launches >= 1, "the service did not propagate through the kernel"
        fb = svc.fast_bipartite
        emb = svc.final_emb
        graph_dev = build_graph(
            prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
            prepared.n_users, prepared.n_items, items_offset=True, device=dev,
        )
        ref = get_embedding(params, graph_dev, cfg)
        del graph_dev
        scale = ref.abs().max().item()
        fwd_err = (emb - ref).abs().max().item()
        torch.testing.assert_close(emb, ref, rtol=1e-4, atol=1e-5 * scale)
        del ref
        fwd_ms = time_ms(
            lambda: fast_get_embedding(params, fb, LAYERS, alpha=cfg.alphas()), reps=5, warmup=1
        )
        device_profile(
            "f32 forward", lambda: fast_get_embedding(params, fb, LAYERS, alpha=cfg.alphas())
        )
        phase(
            4, "forward", t0,
            f"B_ii {fb.build_seconds['item_op']:.2f} s plans {fb.build_seconds['plans']:.2f} s "
            f"refresh {svc.last_refresh_s:.2f} s forward_ms {fwd_ms:.3f} "
            f"max_abs_err {fwd_err:.3e} (max |ref| {scale:.3e}) f32 launches {f32_launches}",
        )

        t0 = time.perf_counter()
        fb16 = build_fast_bipartite(
            graph_host, dtype=torch.bfloat16, msgs_dtype="bfloat16",
            heavy_users=HEAVY_USERS, heavy_dtype="bfloat16", device=dev,
        )
        emb16 = fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas())
        assert torch.isfinite(emb16).all()
        rel16 = ((emb16.float() - emb).norm() / emb.norm()).item()
        assert rel16 <= 5e-2, rel16
        fwd16_ms = time_ms(
            lambda: fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas()), reps=5, warmup=1
        )
        device_profile(
            "bf16 forward", lambda: fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas())
        )
        phase(
            5, "bf16", t0,
            f"B_ii {fb16.build_seconds['item_op']:.2f} s plans {fb16.build_seconds['plans']:.2f} s "
            f"forward_ms {fwd16_ms:.3f} rel_frobenius_vs_f32 {rel16:.3e}",
        )
        del fb16, emb16
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    batcher = BatchingRecommender(svc)
    server = make_server(batcher, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/models/lightgcn_recommender:predict"
    rng = np.random.default_rng(args.seed + 1)
    buyers = prepared.sampler.users
    lat, answers = {}, []
    try:
        for size in (1, 8, 64, 512):
            lat[size] = []
            for i in range(WARMUP_REQUESTS + REQUESTS_PER_SIZE):
                ids = np.concatenate([
                    rng.choice(buyers, (size + 1) // 2),
                    rng.integers(0, prepared.n_users, size // 2),
                ])
                t_req = time.perf_counter()
                items = post(url, ids.tolist())["items"]
                if i >= WARMUP_REQUESTS:
                    lat[size].append((time.perf_counter() - t_req) * 1e3)
                answers.append((ids, items))
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=30)
    with torch.inference_mode():
        for ids, items in answers:
            assert len(items) == len(ids) and all(len(r) == 20 for r in items)
            check_answer(items, *plain_topk(emb, ids, prepared, 20))
    pct = {
        size: np.percentile(v, [50, 90, 99]) for size, v in lat.items()
    }
    phase(
        6, "serve", t0,
        f"refresh {svc.last_refresh_s:.2f} s; {REQUESTS_PER_SIZE} timed requests per size, "
        f"{len(answers)} answers checked; p50/p90/p99 ms "
        + " ".join(f"{s}:{p[0]:.3f}/{p[1]:.3f}/{p[2]:.3f}" for s, p in pct.items()),
    )

    launches = dict(SEGREDUCE.launches)
    for row in rows:
        row["launches"] = launches["float32" if row["name"] == "segreduce_f32" else "bfloat16"]
        assert row["launches"] >= 1, f"{row['name']} was not launched on the main path"
    print(json.dumps({"kernels": rows}), flush=True)
    phase(7, "kernels", time.perf_counter(), f"main-path launches {launches}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
