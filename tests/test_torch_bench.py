"""The port's benchmark entry point (``gnn_ecommerce_tpu_torch/bench.py``)
against root ``bench.py``, on the CPU at a tiny shape.

- Root ``bench.py`` is loaded by path, unedited, with its shape constants
  monkeypatched to 3,000 users x 500 items x 20,000 edges: ``skewed_ids``
  and the synthetic graph equal the port's bit for bit (the draws, the
  edges, the holdout), the graphs' arrays to 1e-7 (both f32 from the same
  f64 normalization, so in practice exactly).
- The eval split's truth is exactly each eval user's held-out purchases,
  and its mask exactly the user's remaining train purchases.
- ``bench.cli(["--device", "cpu"])`` prints one JSON line under root
  ``bench.py``'s keys; ``value`` is arcs x layers over the fast forward's
  time, ``projected_train_hours`` follows root ``bench.py``'s formula from
  the printed numbers, and every roofline share and floor is recomputed
  from its printed bytes, operations and rates (relative 1e-12).
- The tiny shape runs root ``bench.py``'s bucketed candidate (its time is
  ``forward_ms["bucketed"]``), and the roofline's ``to_items_k1`` floor is
  the same whichever plan, bucketed or not, does the work.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu_torch import bench

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(N_USERS=3_000, N_ITEMS=500, N_EDGES=20_000)


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("_root_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_skewed_ids_match_root_bench(root_bench):
    for n, size, a in ((1_000, 5_000, 0.75), (500, 3_000, 1.0)):
        want = root_bench.skewed_ids(np.random.default_rng(5), n, size, a)
        got = bench.skewed_ids(np.random.default_rng(5), n, size, a)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_synthetic_graph_matches_root_bench(root_bench, monkeypatch):
    for name, value in TINY.items():
        monkeypatch.setattr(root_bench, name, value)
    jgraph, (ju, ji, jw), (jhu, jhi) = root_bench.build_synthetic_graph()
    graph, (u, i, w), (hu, hi) = bench.build_synthetic_graph(
        TINY["N_USERS"], TINY["N_ITEMS"], TINY["N_EDGES"], device="cpu"
    )
    for got, want in ((u, ju), (i, ji), (w, jw), (hu, jhu), (hi, jhi)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for field in ("src", "dst", "indptr"):
        np.testing.assert_array_equal(getattr(graph, field).numpy(), np.asarray(getattr(jgraph, field)))
    for field in ("w_norm", "w_raw", "deg"):
        np.testing.assert_allclose(getattr(graph, field).numpy(), np.asarray(getattr(jgraph, field)),
                                   rtol=1e-7, atol=0)


def test_eval_split_is_heldout_and_remaining_purchases():
    s = bench.CPU_SHAPE
    (u, i, w), (hu, hi) = bench.synthetic_edges(s["n_users"], s["n_items"], s["n_edges"])
    arrays, pos_users, indptr, pi_s = bench.purchase_sampler(u, i, w, s["n_users"])
    n_eval = 40
    split = bench.heldout_split((hu, hi), pos_users, indptr, pi_s, s["n_users"], n_eval)
    np.testing.assert_array_equal(split.user_ids, np.unique(hu)[:n_eval])
    buys = w == 1.0
    for r, user in enumerate(split.user_ids):
        truth = split.truth.values[split.truth.indptr[r]: split.truth.indptr[r + 1]]
        mask = split.train_mask.values[split.train_mask.indptr[r]: split.train_mask.indptr[r + 1]]
        np.testing.assert_array_equal(np.sort(truth), np.sort(hi[hu == user]))
        np.testing.assert_array_equal(np.sort(mask), np.sort(i[buys & (u == user)]))
    # The sampler's positives and ignore lists are the graph's purchases.
    assert len(arrays.pos_flat) == int(buys.sum())
    np.testing.assert_array_equal(arrays.ign_flat, arrays.pos_flat)


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    """The CLI's stdout on the CPU (a tiny shape), captured through --out
    and the printed line."""
    import contextlib
    import io

    out_path = tmp_path_factory.mktemp("bench") / "bench.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.cli(["--device", "cpu", "--out", str(out_path)]) == 0
    return buf.getvalue(), out_path.read_text()


def test_cli_prints_one_json_line_with_root_bench_keys(line):
    printed, written = line
    lines = printed.splitlines()
    assert len(lines) == 1 and lines[0] + "\n" == written
    r = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(r)
    d = r["detail"]
    for key in ("b_ii_build_s", "fast_forward_ms", "layered_forward_ms", "train_step_ms", "eval_s",
                "heldout_recall_at_20", "projected_train_hours", "graph", "roofline"):
        assert key in d, key
    s = bench.CPU_SHAPE
    assert d["graph"] == f"{s['n_users']}x{s['n_items']}, {s['n_edges']} edges, dim {s['dim']}, 4 layers"
    assert r["device"]["platform"] == "cpu" and "launches" in r
    assert d["fast_path"] in ("plans", "segment", "bucketed")
    assert set(d["forward_ms"]) == {"segment", "plans", "bucketed"}
    assert d["fast_forward_ms"] == min(d["forward_ms"].values()) == d["forward_ms"][d["fast_path"]]
    for v in (r["value"], r["vs_baseline"], d["train_step_ms"], d["eval_s"], d["b_ii_build_s"]):
        assert np.isfinite(v) and v > 0
    assert 0.0 <= d["heldout_recall_at_20"] <= 1.0
    assert d["dropped_arcs"] == 0.0


def test_value_and_projection_follow_root_bench(line):
    r = json.loads(line[0])
    d = r["detail"]
    assert r["value"] == pytest.approx(d["arcs"] * bench.LAYERS / (d["fast_forward_ms"] / 1e3), rel=1e-12)
    epoch_s = bench.STEPS_PER_EPOCH * d["train_step_ms"] / 1e3 + d["eval_s"] + d["fast_forward_ms"] / 1e3
    hours = (d["b_ii_build_s"] + bench.EPOCHS * epoch_s) / 3600.0
    assert d["projected_train_hours"] == pytest.approx(hours, rel=1e-12)
    assert r["vs_baseline"] == pytest.approx(bench.REFERENCE_HOURS / hours, rel=1e-12)


def test_roofline_shares_follow_from_printed_bytes(line):
    rl = json.loads(line[0])["detail"]["roofline"]
    a = rl["assumptions"]
    peaks = {"bf16": a["bf16_flops_per_s"], "f32": a["f32_flops_per_s"]}
    assert a["hbm_bytes_per_s"] == 3.35e12 and peaks == {"bf16": 989e12, "f32": 67e12}
    assert {"to_items_cast", "to_items_k1", "heavy_head_per_direction", "to_users_ell",
            "to_items_segment", "to_users_segment", "b_ii_chain"} == set(rl["phases"])
    for name, ph in rl["phases"].items():
        floor = max(ph["bytes_moved"] / a["hbm_bytes_per_s"], ph["ops"] / peaks[ph["ops_dtype"]]) * 1e3
        assert ph["floor_ms"] == pytest.approx(floor, rel=1e-12), name
        assert ph["pct_of_floor"] == pytest.approx(100 * floor / ph["measured_ms"], rel=1e-12), name
    fwd, step = rl["forward"], rl["train_step"]
    chain = rl["phases"]["b_ii_chain"]["floor_ms"]
    sparse = sum(rl["phases"][p]["floor_ms"] for p in fwd["parts"]) - chain
    assert fwd["floor_ms"] == pytest.approx(sparse + chain, rel=1e-12)
    assert fwd["pct_of_floor"] == pytest.approx(100 * fwd["floor_ms"] / fwd["measured_ms"], rel=1e-12)
    assert step["floor_ms"] == pytest.approx(sparse + 2 * chain + step["adam_hbm_floor_ms"], rel=1e-12)
    assert step["pct_of_floor"] == pytest.approx(100 * step["floor_ms"] / step["measured_ms"], rel=1e-12)
    s = bench.CPU_SHAPE
    adam = 3 * (s["n_users"] + s["n_items"]) * s["dim"] * 4 * 2 / a["hbm_bytes_per_s"] * 1e3
    assert step["adam_hbm_floor_ms"] == pytest.approx(adam, rel=1e-12)


def test_bench_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


def test_roofline_k1_floor_is_the_same_bucketed_or_not():
    """``to_items_k1`` reckons the unbucketed work (each referenced user row
    read once, each arc's index and weight once, the output written once)
    on either path; only its measured time comes from the plan that ran."""
    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, init_params
    from gnn_ecommerce_tpu_torch.ops.bipartite import (
        FastBipartite, build_fast_ops, build_item_operator, split_graph, split_heavy_users,
    )
    from gnn_ecommerce_tpu_torch.ops.spmm_fast import build_bucketed_segreduce_plan

    s = bench.CPU_SHAPE
    dev = torch.device("cpu")
    graph, _, _ = bench.build_synthetic_graph(s["n_users"], s["n_items"], s["n_edges"], device=dev)
    split = split_graph(graph)
    fops = build_fast_ops(split, "bfloat16", s["heavy_users"], "bfloat16", device=dev)
    item_op = build_item_operator(split, dtype=torch.bfloat16, device=dev)
    fb_seg = FastBipartite(split, item_op)
    fb_plans = FastBipartite(split, item_op, fops, user_csr=fb_seg.user_csr)
    _, _, b_src, b_dst, b_w, *_ = split_heavy_users(split, s["heavy_users"], "bfloat16", False, dev)
    bplan = build_bucketed_segreduce_plan(b_src, b_dst, b_w, split.n_items, split.n_users,
                                          bench.SRC_BUCKETS, device=dev)
    params = init_params(torch.Generator().manual_seed(0),
                         LightGCNConfig(graph.num_nodes, s["dim"], bench.LAYERS), device=dev)
    fwd_ms = {"segment": 3.0, "plans": 2.0, "bucketed": 1.0}
    rows = {
        path: bench.roofline(fb_plans, fb_seg, params, bench.LAYERS, fwd_ms, 5.0, path, dev, bplan)
        for path in ("plans", "bucketed")
    }
    k1 = {path: rl["phases"]["to_items_k1"] for path, rl in rows.items()}
    for key in ("bytes_moved", "ops", "floor_ms", "arcs", "gather_bytes"):
        assert k1["plans"][key] == k1["bucketed"][key], key
    assert sum(b.src.numel() for b in bplan.buckets) == k1["plans"]["arcs"]
    assert rows["bucketed"]["forward"]["parts"] == rows["plans"]["forward"]["parts"]
    assert rows["bucketed"]["forward"]["floor_ms"] == rows["plans"]["forward"]["floor_ms"]
    assert rows["bucketed"]["forward"]["measured_ms"] == 1.0
