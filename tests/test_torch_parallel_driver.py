"""The port's training driver on a mesh: ``train()`` in a gloo world of 2
spawned CPU ranks (``torch_dist_worker.py``, job ``driver``) with every
mesh branch (``partition="edge"``: fast f32, fast bf16 and the explicit
partition; ``"gspmd"``: fast and layered) against the port's one-device
``train()`` with the same seed: per-epoch losses (f32: rtol 1e-5; bf16:
2e-3, the per-step bound of ``test_torch_parallel_train.py``), val P/R@20,
the test metrics, no dropped arcs, the same history on both ranks. A
resume at lr 0 never beats the saved BEST. The checkpoints that rank 0
wrote hold the unified, unpadded table: they load into the one-device
driver (which resumes from them) and into JAX's ``load_checkpoint``."""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.train import checkpoint as jckpt
from gnn_ecommerce_tpu_torch.train import checkpoint as tckpt
from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train

from torch_dist_worker import DRIVER_BASE, DRIVER_RUNS, PROFILED_RUN, driver_prepared, run_world

torch.set_num_threads(1)

F32_RTOL, BF16_RTOL = 1e-5, 2e-3


@pytest.fixture(scope="module")
def prepared():
    return driver_prepared()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_driver")
    ranks = run_world("driver", 2, {"dir": str(root)}, root, timeout=420)
    return root, ranks


@pytest.fixture(scope="module")
def one_device(prepared, tmp_path_factory):
    root = tmp_path_factory.mktemp("one_device")
    out = {}
    for name, kw in DRIVER_RUNS.items():
        cfg = TrainConfig(**DRIVER_BASE, **kw, checkpoint_dir=str(root / name))
        out[name] = train(prepared, cfg, verbose=False, device="cpu")
    return out


@pytest.mark.parametrize("name", list(DRIVER_RUNS))
def test_mesh_train_repeats_one_device(mesh_runs, one_device, name):
    _, ranks = mesh_runs
    ref = one_device[name]
    want = np.array([[h[k] for k in ("loss", "bpr_loss", "reg_loss", "val_precision", "val_recall")]
                     for h in ref.history])
    rtol = BF16_RTOL if "bf16" in name else F32_RTOL
    for r in ranks:
        got = r[f"{name}_history"]
        np.testing.assert_array_equal(got, ranks[0][f"{name}_history"])
        np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=rtol)
        np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], rtol=rtol, atol=1e-6)
        assert not got[:, 5].any()  # no dropped arcs
        best_epoch, best_recall, test_p, test_r = r[f"{name}_test"]
        assert int(best_epoch) == ref.best_epoch
        np.testing.assert_allclose([best_recall, test_p, test_r],
                                   [ref.best_val_recall, ref.test_precision, ref.test_recall],
                                   rtol=rtol, atol=1e-6)


def test_mesh_profiler_writes_one_trace_per_rank(mesh_runs):
    """Every rank exports its own trace of the profiled epoch, and rank 0's
    log names them all."""
    root, ranks = mesh_runs
    d = root / PROFILED_RUN
    names = [f"train_epoch1_rank{r}.json" for r in range(len(ranks))]
    for name in names:
        with open(d / "profile" / name) as f:
            assert json.load(f)["traceEvents"]
    with open(d / "train_log.jsonl") as f:
        msg = next(json.loads(line)["msg"] for line in f if "profiler trace" in line)
    assert all(name in msg for name in names)


def test_mesh_resume_never_beats_best(mesh_runs):
    """A resume at lr 0 from LAST: its epoch repeats LAST, so the on-disk
    BEST stays the best and is restored (through the split layout) for the
    final test."""
    _, ranks = mesh_runs
    for r in ranks:
        assert r["resume_history"].shape[0] == 1
        first, resumed = r["edge_fast_f32_test"], r["resume_test"]
        assert int(resumed[0]) == int(first[0])
        np.testing.assert_allclose(resumed[1:], first[1:], rtol=1e-5)


@pytest.mark.parametrize("name", list(DRIVER_RUNS))
def test_rank0_checkpoints_load_everywhere(mesh_runs, prepared, name, tmp_path):
    """Rank 0 alone wrote one log and the checkpoints, in the unified
    unpadded layout: JAX's load_checkpoint restores them, and the one-device
    driver resumes from them."""
    root, _ = mesh_runs
    d = root / name
    with open(d / "train_log.jsonl") as f:
        epochs = [json.loads(line)["epoch"] for line in f if '"epoch"' in line]
    assert epochs == ([0, 1, 2] if name == "edge_fast_f32" else [0, 1])
    n = prepared.n_users + prepared.n_items
    for ckpt in (tckpt.BEST_NAME, tckpt.LAST_NAME):
        leaves, meta = jckpt.load_checkpoint(str(d), ckpt)
        template = {"embedding": jnp.zeros((n, DRIVER_BASE["latent_dim"]), jnp.float32)}
        params, opt_state = jckpt.restore_into(template, optax.adam(0.1).init(template), leaves)
        assert params["embedding"].shape == (n, DRIVER_BASE["latent_dim"])
        assert np.isfinite(np.asarray(params["embedding"])).all()
        assert int(opt_state[0].count) == DRIVER_BASE["batches_per_epoch"] * (meta["epoch"] + 1)
    # The one-device driver resumes from the mesh's LAST.
    work = tmp_path / name
    shutil.copytree(d, work)
    cfg = TrainConfig(**{**DRIVER_BASE, **DRIVER_RUNS[name], "epochs": 3 + (name == "edge_fast_f32")},
                      checkpoint_dir=str(work), resume=True)
    result = train(prepared, cfg, verbose=False, device="cpu")
    assert [h["epoch"] for h in result.history] == [3 if name == "edge_fast_f32" else 2]
    assert np.isfinite(result.history[-1]["loss"])
