"""The DGCF cell (``dgcf-cosmetics-d64-k4.train-dgcf``) on the CPU at the tiny
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

from benchmark import dgcf_floors, harness
from benchmark.reference import dgcf as ref
from benchmark.reference.precision import FP8

from conftest import REPO, run_tiny

CELL = "dgcf-cosmetics-d64-k4.train-dgcf"
# The generic step's spans (sampler, backward, Adam), then the cell's own.
METRICS = ("sampler_ms.train", "backward_ms.train", "adam_ms.train", "train_dgcf_mfu_pct", "routing_ms.train-dgcf",
           "intent_gather_roofline.train-dgcf", "routing_score_ms.train-dgcf", "device_idle_pct.train-dgcf")
KINDS = {"program_sampler", "control_fp8", "one_iteration", "softmax_over_arcs", "no_tanh", "unrouted_degrees",
         "no_cor", "users_by_purchase"}


def metric(name):
    return harness.load_module(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"), f"m_{name}")


def test_cell_mix_driver_and_metrics_found_by_name():
    c = harness.find_cell(REPO, CELL, 1, 1.0, True, "cpu")
    assert c.mix["driver"] == "train_dgcf_steps" and c.driver.__name__ == "benchmark_driver_train_dgcf_steps"
    assert c.config["model"]["kind"] == "dgcf" and c.config["reduced"] == []
    m = c.config["model"]
    assert (m["embedding_dim"], m["n_factors"], m["n_iterations"], m["num_layers"]) == (64, 4, 2, 1)
    assert (m["cor_weight"], m["cor_batch"]) == (0.01, 324)
    g, tr = c.config["graph"], c.config["train"]
    # The authors' cor_batch on the graph that remains after the holdout.
    assert int(max(g["n_users"], g["n_items"]) / (10_106_621 // tr["batch_size"] + 1)) == 324
    assert (tr["batch_size"], tr["lr"], tr["precision"], tr["heavy_users"]) == (2000, 0.001, "bf16", 0)
    assert [e["name"] for e in c.end_to_end] == ["train_step_ms", "setup_s"]
    assert [p["name"] for p in c.per_layer] == list(METRICS)


def path_arcs():
    """Users 0, 1, item 2 (local item 0): the path u0 - i2 - u1."""
    return ref.Arcs(np.array([0, 1]), np.array([0, 0]), 2, 1, "cpu")


def test_first_iteration_by_hand():
    """On the path u0 - i2 - u1 from A = 1: S = 1/K everywhere, each chunk's
    degree the arc count over K, so u0 and u1 get x[i2]/√2 and i2 gets
    (x[u0] + x[u1])/√2, chunk by chunk; one layer of one iteration averages
    that with the table."""
    arcs = path_arcs()
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0], [0.5, -1.0, 2.0, 0.0], [-2.0, 1.0, 0.5, 3.0]])
    final, s = ref.forward(arcs, x, 2, 1, 1)
    torch.testing.assert_close(s, torch.full((4, 2), 0.5))
    f = torch.stack([x[2] / math.sqrt(2), x[2] / math.sqrt(2), (x[0] + x[1]) / math.sqrt(2)])
    torch.testing.assert_close(final, (x + f) / 2)


def test_second_iteration_scores_by_hand():
    """One score update by hand on the path: A(h, t) = 1 + ⟨normalize(f_k[h]),
    tanh(normalize(x_k[t]))⟩ chunk by chunk, then S = softmax over the two
    intents."""
    arcs = path_arcs()
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0], [0.5, -1.0, 2.0, 0.0], [-2.0, 1.0, 0.5, 3.0]])
    f = torch.stack([x[2] / math.sqrt(2), x[2] / math.sqrt(2), (x[0] + x[1]) / math.sqrt(2)])
    unit = lambda v: v / v.norm()
    want = []
    for h, t in zip(arcs.head.tolist(), arcs.tail.tolist()):
        a = [1 + float(unit(f[h, 2 * k:2 * k + 2]) @ torch.tanh(unit(x[t, 2 * k:2 * k + 2]))) for k in range(2)]
        e = [math.exp(v) for v in a]
        want.append([v / sum(e) for v in e])
    _, s = ref.forward(arcs, x, 2, 2, 1)
    torch.testing.assert_close(s, torch.tensor(want))
    # Without tanh, the same arcs route otherwise.
    _, s_plain = ref.forward(arcs, x, 2, 2, 1, tanh=False)
    assert float((s_plain - s).abs().max()) > 1e-3


def test_dcor_by_hand():
    """Two samples: every centred distance matrix is [[-a, a], [a, -a]]/2
    with a the distance, so dcov₁₂ = sqrt(a·b/4 + 1e-8) and dcor ≈ 1."""
    x1, x2 = torch.tensor([[0.0], [2.0]]), torch.tensor([[1.0], [4.0]])
    a, b = math.sqrt(4 + 1e-8) - math.sqrt(1e-8), math.sqrt(9 + 1e-8) - math.sqrt(1e-8)
    cov = lambda p: math.sqrt(p / 4 + 1e-8)
    want = cov(a * b) / (math.sqrt(cov(a * a) * cov(b * b)) + 1e-10)
    assert float(ref.dcor(x1, x2)) == pytest.approx(want, rel=1e-6)


def test_blocks_and_quant_keep_the_arithmetic(monkeypatch):
    """Blocks of 3 arcs give the unblocked values; the fp8 control moves
    them by its rounding."""
    gen = torch.Generator().manual_seed(1)
    u, i = torch.randint(0, 30, (80,), generator=gen).numpy(), torch.randint(0, 9, (80,), generator=gen).numpy()
    key = np.unique(u * 9 + i)
    u, i = key // 9, key % 9
    table = torch.randn(39, 8, generator=gen) * 0.1
    arcs = ref.Arcs(u, i, 30, 9, "cpu")
    whole = ref.forward(arcs, table, 4, 2, 1)[0]
    monkeypatch.setattr(ref, "BLOCK", 3)
    torch.testing.assert_close(ref.forward(arcs, table, 4, 2, 1)[0], whole)
    fp8 = ref.forward(ref.Arcs(u, i, 30, 9, "cpu", quant=FP8), table, 4, 2, 1)[0]
    assert 1e-3 < float((fp8 - whole).norm() / whole.norm()) < 0.2


SHAPE = {"n_users": 10, "n_items": 4, "n_nodes": 14, "edges": 12, "arcs": 24, "dim": 8, "layers": 1,
         "users_with_arcs": 7, "items_with_arcs": 4, "n_factors": 4, "n_iterations": 2}
HBM, F32 = 3.35e12, 67e12


def test_floors_by_hand():
    # Two products of 24 arcs: each reads a tail id and 4 weights an arc,
    # 11 rows of 8 f32, writes 14 rows of 8 f32.
    one = max((24 * (4 + 16) + 11 * 32 + 14 * 32) / HBM, 2 * 24 * 8 / F32)
    got = dgcf_floors.intent_gather_floor_s(SHAPE, routed_arcs=2 * 24 * 4)
    assert got == pytest.approx(2 * one)
    assert metric("intent_gather_roofline.train-dgcf").floor_s(SHAPE, 2 * 24 * 4) == got
    # Two products and one score update forward, twice that backward.
    step = max((6 * 14 * 8 * 4 + 24 * 8) / HBM, 3 * 2 * 24 * 8 * 3 / F32)
    assert dgcf_floors.dgcf_step_floor_s(SHAPE) == pytest.approx(step)
    assert metric("train_dgcf_mfu_pct").floor_s(SHAPE) == dgcf_floors.dgcf_step_floor_s(SHAPE)
    # Full size: bytes bound both, the products' floor about 0.76 ms a step.
    full = {"n_nodes": 1_693_929, "arcs": 20_213_242, "dim": 64, "layers": 1, "n_factors": 4,
            "n_iterations": 2, "users_with_arcs": 1_600_000, "items_with_arcs": 54_571}
    assert 0.5e-3 < dgcf_floors.intent_gather_floor_s(full, 2 * 20_213_242 * 4) < 1e-3


def test_readers_find_nothing_without_state():
    ctx = types.SimpleNamespace(state=types.SimpleNamespace(), window=None, trace=None,
                                cell=types.SimpleNamespace(mix={}))
    for name in METRICS:
        assert metric(name).read(ctx) is None, name


def test_sound_run_is_correct_and_traced_run_reads_the_host_clock(tiny_root):
    r = run_tiny(tiny_root, CELL, seed=2**31 + 11, seconds=0.5, trace=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"bad_triples", "sampler_z", "grad_gap", "grad_norm_gap", "change_norm_gap",
                                "routing_gap", "cor_loss_gap"}
    # On the CPU the spans have no device time and there is no trace.
    assert set(r["metrics"]) == {"train_dgcf_mfu_pct"}


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_control_and_faults_fail(tiny_root, seed):
    c = harness.find_cell(tiny_root, CELL, seed, 1.0, False, "cpu")
    out = c.driver.controls(c)
    assert set(out) == KINDS
    limits = c.mix["limits"]
    for kind, nums in out.items():
        failed = [k for k, v in nums.items() if k in limits and not v <= limits[k]]
        assert bool(failed) == (kind != "program_sampler"), (kind, nums, limits)


def adam_unchanged(monkeypatch):
    from gnn_ecommerce_tpu_torch.train import step

    monkeypatch.setattr(step.Adam, "update", lambda self, grads, state, params: None)


def no_tanh(monkeypatch):
    """The score update's tails without their tanh (undone by atanh)."""
    from gnn_ecommerce_tpu_torch.models import dgcf

    right = dgcf.intent_sddmm
    monkeypatch.setattr(dgcf, "intent_sddmm", lambda p, q, rg, k, gd=None: right(p, torch.atanh(q), rg, k, gd))


def one_iteration(monkeypatch):
    from gnn_ecommerce_tpu_torch.models import dgcf

    right = dgcf.dgcf_forward
    monkeypatch.setattr(dgcf, "dgcf_forward", lambda table, rg, k, t, layers, gd=None: right(table, rg, k, 1,
                                                                                             layers, gd))


@pytest.mark.parametrize("fault", [adam_unchanged, no_tanh, one_iteration])
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
