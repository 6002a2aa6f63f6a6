"""Every floor function against hand arithmetic at a tiny shape, and each
metric file's floor against the shared one it names."""
import os

import pytest

from benchmark import harness, peaks

from conftest import REPO

HBM = 3.35e12
BF16, F32 = 989e12, 67e12
SHAPE = {"n_users": 10, "n_items": 4, "n_nodes": 14, "edges": 12, "arcs": 24, "dim": 3, "layers": 5,
         "users_with_arcs": 7, "items_with_arcs": 4}


def metric(name):
    return harness.load_module(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"), f"m_{name}")


def test_floor_is_the_larger_bound():
    assert peaks.floor_s(3.35e12, 0, "f32") == pytest.approx(1.0)
    assert peaks.floor_s(0, 67e12, "f32") == pytest.approx(1.0)
    assert peaks.floor_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert peaks.share_pct(0.5, 2.0) == 25.0 and peaks.share_pct(1.0, 0) is None


def test_chain_widths():
    assert peaks.chain_widths(90, 5) == [180, 180]
    assert peaks.chain_widths(80, 4) == [160, 80]
    assert peaks.chain_widths(64, 3) == [128]
    assert peaks.chain_widths(8, 1) == []


def test_chain_floor_by_hand():
    # d 3, L 5: two [4, 4] x [4, 6] products.
    nbytes = 4 * 4 * 2 + 4 * 6 * 2 + 4 * 6 * 4
    ops = 2 * 4 * 4 * 6
    assert peaks.chain_floor_s(4, 3, 5, "bf16") == pytest.approx(2 * max(nbytes / HBM, ops / BF16))
    # d 3, L 4: [4, 4] x [4, 6] then [4, 4] x [4, 3], f32.
    f = lambda w: max((4 * 4 * 4 + 4 * w * 8) / HBM, 2 * 4 * 4 * w / F32)
    assert peaks.chain_floor_s(4, 3, 4, "f32") == pytest.approx(f(6) + f(3))
    assert metric("chain_roofline.train").floor_s(SHAPE, "bf16") == peaks.chain_floor_s(4, 3, 5, "bf16")
    assert metric("chain_roofline.refresh").floor_s(SHAPE) == peaks.chain_floor_s(4, 3, 5, "f32")


def test_spmm_floors_by_hand():
    # to_items: 7 user rows read, 12 arcs, 4 item rows written, d 3.
    to_items = max((7 * 12 + 12 * 8 + 4 * 12) / HBM, 2 * 12 * 3 / F32)
    assert metric("to_items_roofline.train").floor_s(SHAPE) == pytest.approx(to_items)
    # to_users: 4 item rows read, 12 arcs, 10 user rows written.
    to_users = max((4 * 12 + 12 * 8 + 10 * 12) / HBM, 2 * 12 * 3 / F32)
    assert metric("to_users_roofline.train").floor_s(SHAPE) == pytest.approx(to_users)


def test_model_floors_by_hand():
    # Step: 5 layers x 24 arcs x 2·3 ops, x3 for the backward; table and
    # two moments (14 x 3 f32) read and written, 8 bytes an arc.
    step = max((6 * 14 * 3 * 4 + 24 * 8) / HBM, 3 * 5 * 24 * 6 / F32)
    assert metric("train_step_mfu_pct").floor_s(SHAPE) == pytest.approx(step)
    fwd = max((2 * 14 * 3 * 4 + 24 * 8) / HBM, 5 * 24 * 6 / F32)
    assert metric("refresh_mfu_pct").floor_s(SHAPE) == pytest.approx(fwd)


def test_full_size_floors_match_the_predictions():
    """The d90-l5 shapes: the chain about 2 x 1.79 ms (bytes-bound), each
    sparse direction about 0.21 ms, the step about 1.14 ms."""
    n_u, n_i, e, d = 1_639_358, 54_571, 10_157_407, 90
    assert peaks.chain_floor_s(n_i, d, 5, "bf16") == pytest.approx(3.57e-3, rel=0.01)
    assert peaks.chain_floor_s(n_i, d, 5, "f32") == pytest.approx(32.0e-3, rel=0.01)
    assert peaks.spmm_floor_s(n_u, e, n_i, d) == pytest.approx(0.206e-3, rel=0.02)
    assert peaks.lightgcn_step_floor_s(n_u + n_i, 2 * e, d, 5) == pytest.approx(1.14e-3, rel=0.02)


def test_readers_find_nothing_without_state():
    import types

    ctx = types.SimpleNamespace(state=types.SimpleNamespace(), window=None, trace=None)
    for name in ("chain_roofline.train", "to_items_roofline.train", "to_users_roofline.train",
                 "train_step_mfu_pct", "chain_roofline.refresh", "refresh_mfu_pct", "users_per_batch.serve",
                 "device_idle_pct.train", "device_idle_pct.serve", "device_idle_pct.refresh",
                 "request_p99_ms.serve"):
        assert metric(name).read(ctx) is None, name


def test_idle_share_from_a_trace_summary():
    import numpy as np

    from benchmark.measure import _union, idle_pct

    s, e = _union(np.array([0, 5, 2, 20]), np.array([3, 8, 4, 25]))
    assert list(s) == [0, 5, 20] and list(e) == [4, 8, 25]
    assert idle_pct({"busy_s": 0.25, "window_s": 1.0}) == 75.0
    assert idle_pct({"busy_s": 0.0, "window_s": 1.0}) is None and idle_pct(None) is None
