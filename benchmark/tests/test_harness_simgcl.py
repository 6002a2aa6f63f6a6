"""The SimGCL cell (``simgcl-cosmetics-d64-l3.train-cl``) on the CPU at the tiny
size of ``conftest.py``: found by name, its reference against hand
arithmetic, its floors by hand, its controls and planted faults failing the
mix's limits, a sound run correct and broken paths not. ``test_card_cell``
runs the tiny cell on the card."""
import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark import cl_floors, harness, peaks
from benchmark.reference import lightgcn as lref
from benchmark.reference import simgcl as ref

from conftest import REPO, run_tiny

CELL = "simgcl-cosmetics-d64-l3.train-cl"
METRICS = ("cl_views_ms.train-cl", "cl_views_roofline.train-cl", "infonce_ms.train-cl", "train_cl_mfu_pct",
           "device_idle_pct.train-cl")


def metric(name):
    return harness.load_module(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"), f"m_{name}")


def test_cell_mix_driver_and_metrics_found_by_name():
    c = harness.find_cell(REPO, CELL, 1, 1.0, True, "cpu")
    assert c.mix["driver"] == "train_cl_steps" and c.driver.__name__ == "benchmark_driver_train_cl_steps"
    assert c.config["model"]["kind"] == "simgcl" and c.config["reduced"] == []
    m = c.config["model"]
    assert (m["embedding_dim"], m["num_layers"], m["cl_weight"], m["cl_eps"], m["cl_temp"]) == (64, 3, 0.5, 0.1, 0.2)
    assert m["layer_weights"] == pytest.approx([0, 1 / 3, 1 / 3, 1 / 3])
    assert c.config["train"]["batch_size"] == 2048
    assert [e["name"] for e in c.end_to_end] == ["train_step_ms", "setup_s"]
    assert [p["name"] for p in c.per_layer] == list(METRICS)


def test_info_nce_by_hand_with_a_duplicate():
    """Ids [a, b, a]: unique {a, b}. Rows of unit length, so the scores are
    dot products over τ."""
    tau = 0.5
    v1 = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    v2 = torch.tensor([[0.6, 0.8], [0.0, 1.0], [0.6, 0.8]])
    s = lambda a, b: float(v1[a] @ v2[b]) / tau
    row = lambda i, cols: s(i, i) - math.log(sum(math.exp(s(i, j)) for j in cols))
    uniq = torch.tensor([0, 1])
    want = -(row(0, [0, 1]) + row(1, [0, 1])) / 2
    assert float(ref.info_nce(v1[uniq], v2[uniq], tau)) == pytest.approx(want, rel=1e-6)
    # Duplicates kept: three rows, three columns, the mean over three.
    kept = -(row(0, [0, 1, 2]) + row(1, [0, 1, 2]) + row(2, [0, 1, 2])) / 3
    assert float(ref.info_nce(v1, v2, tau)) == pytest.approx(kept, rel=1e-6)
    assert abs(kept - want) > 0.1


def test_noise_rows_have_length_eps_and_views_by_hand():
    """On a path u0 - i0 - u1 with every element of each layer nonzero, a
    noised row minus the clean product of the same input has length ε, and
    the clean view is the mean of Â x and Â² x."""
    adj = lref.Adjacency(np.array([0, 1]), np.array([0, 0]), np.array([1.0, 1.0], np.float32), 2, 1, "cpu")
    x = torch.tensor([[0.5, -1.0], [2.0, 0.25], [-1.5, 3.0]])
    gen = torch.Generator().manual_seed(4)
    eps = 0.1
    noised = ref.layers(adj, x, 2, eps, gen)
    for prev, nxt in zip(noised[:-1], noised[1:]):
        np.testing.assert_allclose((nxt - adj.mm(prev)).norm(dim=1).numpy(), [eps] * 3, rtol=1e-5)
    a = adj.A.to_dense()
    np.testing.assert_allclose(ref.clean_embedding(adj, x, 2).numpy(), ((a @ x + a @ a @ x) / 2).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(ref.clean_embedding(adj, x, 2, with_layer0=True).numpy(),
                               ((x + a @ x + a @ a @ x) / 3).numpy(), rtol=1e-6)


SHAPE = {"n_users": 10, "n_items": 4, "n_nodes": 14, "edges": 12, "arcs": 24, "dim": 3, "layers": 3,
         "users_with_arcs": 7, "items_with_arcs": 4, "batch": 5, "unique_users": 4.0, "unique_pos": 2.0}
HBM, F32 = 3.35e12, 67e12


def test_floors_by_hand():
    # Two views x 3 layers: 6 view-layers of 12 arcs each way; noise 6 x 14
    # rows of 3 f32, read and written.
    to_users = max((4 * 12 + 12 * 8 + 10 * 12) / HBM, 2 * 12 * 3 / F32)
    to_items = max((7 * 12 + 12 * 8 + 4 * 12) / HBM, 2 * 12 * 3 / F32)
    noise = 6 * 14 * 3 * 4 * 2 / HBM
    got = cl_floors.views_floor_s(SHAPE, view_arcs=6 * 24, noised_rows=6 * 14)
    assert got == pytest.approx(6 * (to_users + to_items) + noise)
    assert metric("cl_views_roofline.train-cl").floor_s(SHAPE, 6 * 24, 6 * 14) == got
    assert cl_floors.infonce_ops(4, 3) == 6 * 4 * 4 * 3
    ops = 3 * (3 * 3 * 24 * 6) + 6 * 3 * (16 + 4)
    step = max((6 * 14 * 3 * 4 + 24 * 8) / HBM, ops / F32)
    assert cl_floors.simgcl_step_floor_s(SHAPE) == pytest.approx(step)
    assert metric("train_cl_mfu_pct").floor_s(SHAPE) == cl_floors.simgcl_step_floor_s(SHAPE)
    # Full size: the clean term's floor is LightGCN's, and a step's is more.
    full = {"n_nodes": 1_693_929, "arcs": 2 * 10_157_407, "dim": 64, "layers": 3,
            "unique_users": 2048.0, "unique_pos": 2048.0}
    assert cl_floors.simgcl_step_floor_s(full) > peaks.lightgcn_step_floor_s(1_693_929, 2 * 10_157_407, 64, 3)


def test_readers_find_nothing_without_state():
    ctx = types.SimpleNamespace(state=types.SimpleNamespace(), window=None, trace=None,
                                cell=types.SimpleNamespace(mix={}))
    for name in METRICS:
        assert metric(name).read(ctx) is None, name


def test_sound_run_is_correct_and_traced_run_reads_the_host_clock(tiny_root):
    r = run_tiny(tiny_root, CELL, seed=2**31 + 11, seconds=0.5, trace=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"bad_triples", "sampler_z", "dropped_arcs", "grad_gap", "grad_norm_gap",
                                "change_norm_gap", "cl_loss_gap"}
    # On the CPU the spans have no device time and there is no trace.
    assert set(r["metrics"]) == {"train_cl_mfu_pct"}


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_control_and_faults_fail(tiny_root, seed):
    c = harness.find_cell(tiny_root, CELL, seed, 1.0, False, "cpu")
    out = c.driver.controls(c)
    assert set(out) == {"program_sampler", "control_fp8", "no_noise", "duplicates_kept", "layer0_in_mean",
                        "users_by_purchase"}
    limits = c.mix["limits"]
    for kind, nums in out.items():
        failed = [k for k, v in nums.items() if k in limits and not v <= limits[k]]
        assert bool(failed) == (kind != "program_sampler"), (kind, nums, limits)


def adam_unchanged(monkeypatch):
    from gnn_ecommerce_tpu_torch.train import step

    monkeypatch.setattr(step.Adam, "update", lambda self, grads, state, params: None)


def no_noise(monkeypatch):
    from gnn_ecommerce_tpu_torch.models import simgcl

    monkeypatch.setattr(simgcl, "noise_add", lambda x, noise: x)


def duplicates_kept(monkeypatch):
    from gnn_ecommerce_tpu_torch.models import simgcl

    right = simgcl.info_nce_unique
    monkeypatch.setattr(simgcl, "info_nce_unique", lambda a, b, first, temp: right(a, b, torch.ones_like(first), temp))


@pytest.mark.parametrize("fault", [adam_unchanged, no_noise, duplicates_kept])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = run_tiny(tiny_root, CELL, seed=2**31 + 17, seconds=0.5)
    assert not r["correct"], r["checks"]


@pytest.mark.card
def test_card_cell(tiny_root, card):
    r = run_tiny(tiny_root, CELL, seed=2**31 + 23, seconds=1.0, trace=True, device=card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert set(METRICS) <= set(r["metrics"])
