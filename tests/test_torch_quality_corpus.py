"""The quality runs' corpus (``runs/full_corpus_r3.py``) and the main
configuration's seed runs (``runs/train_full_r5b.py``) on the CPU.

- ``build_prepared`` gives the arrays of ``scripts/full_corpus_r3.py``'s
  ``build_prepared`` bit for bit, with both modules' constants scaled down
  alike (the script loaded from ``scripts/`` unedited, its constants set on
  the loaded module), and ``heldout_edges`` gives the columns of JAX's
  ``val_df`` / ``test_df`` (``user_id_idx``, ``item_id_idx``, ``weight``)
  row for row; ``full_corpus_r3 -o`` saves them and ``load_heldout`` reads
  them back.
- The artifact's hash (``artifact_sha256``, also ``quality_run.sh --hash``)
  of the port's saved artifact, and ``prepared_sha256`` of its arrays in
  memory, equal the hash of JAX's saved artifact.
- ``train_full_r5b --seed`` changes the training only: two seeds give one
  artifact hash and two different runs, whether the corpus is built or
  loaded with ``-d``; the line has ``TRAIN_FULL_r5b.json``'s keys plus
  ``EXTRA_KEYS`` (2 epochs, the full-scale quality bars replaced by none).
- ``train`` in a torch.distributed world of one rank trains through the
  mesh branch (the fast edge partition, and the GSPMD layered propagation
  of the defaults, as ``torchrun --nproc-per-node 1`` runs it) and repeats
  the one-device run (``F32_RTOL`` relative, as
  ``tests/test_torch_parallel_driver.py``).
- Each quality run's command line raises without a card unless
  ``--device cpu`` is given.

Exact comparisons but for the world of 1.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.data.artifacts import save_prepared as jax_save_prepared
from gnn_ecommerce_tpu_torch.data.artifacts import _FIELDS
from gnn_ecommerce_tpu_torch.parallel.distributed import init_distributed
from gnn_ecommerce_tpu_torch.runs import (
    bars,
    bprmf_full_r5,
    config3_subsample_r3,
    full_corpus_r3,
    movielens_bench,
    skyline_full_r3,
    svd_full_r5,
    train_full_r5b,
)
from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
F32_RTOL = 1e-5
# The full corpus's shape scaled down, its structure kept.
SMALL = dict(N_USERS=3000, N_ITEMS=400, N_EVENTS=40000, N_PAIRS=15000,
             GEN_KWARGS=dict(seed=42, n_clusters=12, affinity=0.85, item_skew=0.9))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_quality_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def small_corpus(monkeypatch):
    """The port's full_corpus_r3 at SMALL's constants."""
    for name, value in SMALL.items():
        monkeypatch.setattr(full_corpus_r3, name, value)


@pytest.fixture(scope="module")
def both():
    """(JAX's prepared, the port's prepared, the port's held-out edges) at
    SMALL's constants, each module's constants set on it."""
    script = _script("full_corpus_r3")
    saved = {name: getattr(full_corpus_r3, name) for name in SMALL}
    for name, value in SMALL.items():
        setattr(script, name, value)
        setattr(full_corpus_r3, name, value)
    try:
        jax_prepared, jax_n = script.build_prepared()
        tr, va, te, n = full_corpus_r3.build_splits()
        prepared, n2 = full_corpus_r3.build_prepared()
    finally:
        for name, value in saved.items():
            setattr(full_corpus_r3, name, value)
    assert jax_n == n == n2
    return jax_prepared, prepared, full_corpus_r3.heldout_edges(tr, va, te)


@pytest.mark.parametrize("name", sorted(_FIELDS))
def test_build_prepared_matches_jax(both, name):
    jax_prepared, prepared, _ = both
    assert (prepared.n_users, prepared.n_items) == (jax_prepared.n_users, jax_prepared.n_items)
    want, got = np.asarray(_FIELDS[name](jax_prepared)), _FIELDS[name](prepared)
    assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("split", ["val", "test"])
def test_heldout_edges_match_jax_frames(both, split):
    jax_prepared, _, heldout = both
    df = getattr(jax_prepared, f"{split}_df")
    e = heldout[split]
    assert len(e) == len(df) > 0
    np.testing.assert_array_equal(e.user_id, df["user_id_idx"].to_numpy())
    np.testing.assert_array_equal(e.item_id, df["item_id_idx"].to_numpy())
    np.testing.assert_array_equal(e.weight, df["weight"].to_numpy())
    assert e.item_id.max() < jax_prepared.n_items  # local item ids


def test_artifact_hash_matches_jax_artifact(both, tmp_path):
    jax_prepared, prepared, _ = both
    jax_save_prepared(jax_prepared, str(tmp_path / "jax"))
    line = full_corpus_r3.save_corpus(prepared, 15000, 0.0, str(tmp_path / "port"))
    want = full_corpus_r3.artifact_sha256(str(tmp_path / "jax"))
    assert full_corpus_r3.artifact_sha256(str(tmp_path / "port")) == want
    assert line["artifact_sha256"] == full_corpus_r3.prepared_sha256(prepared) == want["sha256"]
    loaded, n_edges = full_corpus_r3.load_corpus(str(tmp_path / "port"))
    assert n_edges == 15000 and np.array_equal(loaded.edge_weight, prepared.edge_weight)


def test_corpus_cli_line(small_corpus, both, tmp_path, capsys):
    d = tmp_path / "data"
    assert full_corpus_r3.main(["-o", str(d), "--device", "cpu", "--out", str(tmp_path / "c.json")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == full_corpus_r3.EXTRA_KEYS
    assert line["artifact_sha256"] == full_corpus_r3.artifact_sha256(str(d))["sha256"]
    assert line["device"] == "cpu" and line["unique_edges"] == SMALL["N_PAIRS"]
    assert json.loads((tmp_path / "c.json").read_text()) == line
    saved = full_corpus_r3.load_heldout(str(d))
    for split, e in both[2].items():
        for col in ("user_id", "item_id", "weight"):
            got, want = getattr(saved[split], col), getattr(e, col)
            assert got.dtype == want.dtype and np.array_equal(got, want), (split, col)


def _seed_run(root, seed: int, *argv) -> dict:
    out = root / f"seed{seed}{'_d' if argv else ''}.json"
    assert train_full_r5b.main(["--device", "cpu", "--seed", str(seed), *argv,
                                "--work", str(root / f"w{seed}"), "--out", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def short_runs():
    """train_full_r5b at 2 epochs, its full-scale bars replaced by none."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_full_r5b, "CONFIG", dataclasses.replace(train_full_r5b.CONFIG, epochs=2))
        mp.setitem(bars.BARS, "train_full_r5b", lambda line: [])
        yield


@pytest.fixture(scope="module")
def seed_runs(tmp_path_factory, short_runs):
    """SMALL's corpus saved by ``full_corpus_r3 -o``, then train_full_r5b's
    lines at seed 1 building the corpus and at seed 2 on the saved
    artifact."""
    root = tmp_path_factory.mktemp("r5b")
    saved = {name: getattr(full_corpus_r3, name) for name in SMALL}
    for name, value in SMALL.items():
        setattr(full_corpus_r3, name, value)
    try:
        assert full_corpus_r3.main(["-o", str(root / "data"), "--device", "cpu",
                                    "--out", str(root / "corpus.json")]) == 0
        lines = {1: _seed_run(root, 1), 2: _seed_run(root, 2, "-d", str(root / "data"))}
    finally:
        for name, value in saved.items():
            setattr(full_corpus_r3, name, value)
    return root, lines


def test_seed_changes_training_only(seed_runs):
    root, lines = seed_runs
    a, b = lines[1], lines[2]
    assert (a["seed"], b["seed"]) == (1, 2)
    corpus = json.loads((root / "corpus.json").read_text())
    assert a["artifact_sha256"] == b["artifact_sha256"] == corpus["artifact_sha256"]
    assert a["workload"] == b["workload"]
    assert a["quality"]["bpr_loss_curve"] != b["quality"]["bpr_loss_curve"]
    for line in (a, b):
        assert len(line["per_epoch"]) == 2 and all(np.isfinite(line["quality"]["bpr_loss_curve"]))
        assert line["launches"] == {}  # the CPU takes each kernel's plain version


def test_seed_run_reuses_saved_artifact(seed_runs, short_runs, tmp_path):
    """``-d`` trains on the saved artifact what the built corpus trains: at
    the same seed, the same run."""
    root, lines = seed_runs
    line = _seed_run(tmp_path, 1, "-d", str(root / "data"))
    assert line["artifact_sha256"] == lines[1]["artifact_sha256"]
    assert line["quality"] == lines[1]["quality"]


def test_seed_run_keys_are_the_tpu_files(seed_runs):
    _, lines = seed_runs
    want = json.loads((ROOT / "TRAIN_FULL_r5b.json").read_text())
    for line in lines.values():
        assert set(line) == set(want) | train_full_r5b.EXTRA_KEYS
        for key in ("workload", "measured", "quality"):
            assert set(line[key]) == set(want[key]), key
        assert set(line["per_epoch"][0]) == set(want["per_epoch"][0])


# The mesh branch's log line for each run of torch_dist_worker.DRIVER_RUNS.
MESH_LOG = {"edge_fast_f32": "fast edge partition built", "gspmd_plain": "mesh training: "}


@pytest.mark.parametrize("run", sorted(MESH_LOG))
def test_world_of_one_trains_through_the_mesh_branch(run, tmp_path):
    """A process that joined a world of one rank takes the mesh branch (its
    log line) and repeats the one-device run: the fast edge partition, and
    the defaults (GSPMD, layered propagation), as a single process under
    ``torchrun`` trains."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_dist_worker import DRIVER_BASE, DRIVER_RUNS, driver_prepared

    prepared = driver_prepared()
    kw = {**DRIVER_BASE, **DRIVER_RUNS[run]}
    ref = train(prepared, TrainConfig(**kw, checkpoint_dir=str(tmp_path / "one")), verbose=False,
                device="cpu")
    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo", device="cpu")
    try:
        got = train(prepared, TrainConfig(**kw, checkpoint_dir=str(tmp_path / "mesh")), verbose=False,
                    device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    with open(tmp_path / "mesh" / "train_log.jsonl") as f:
        assert any(MESH_LOG[run] in json.loads(line).get("msg", "") for line in f)
    with open(tmp_path / "one" / "train_log.jsonl") as f:
        assert not any(msg in json.loads(line).get("msg", "") for line in f for msg in MESH_LOG.values())
    keys = ("loss", "bpr_loss", "reg_loss", "val_precision", "val_recall")
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in ref.history], rtol=F32_RTOL, atol=1e-6)
    assert got.best_epoch == ref.best_epoch
    np.testing.assert_allclose([got.test_precision, got.test_recall],
                               [ref.test_precision, ref.test_recall], rtol=F32_RTOL, atol=1e-6)


MAINS = {
    "full_corpus_r3": (full_corpus_r3, ["-o", "unused"]),
    "svd_full_r5": (svd_full_r5, []),
    "bprmf_full_r5": (bprmf_full_r5, []),
    "skyline_full_r3": (skyline_full_r3, []),
    "movielens_bench": (movielens_bench, []),
    "config3_subsample_r3": (config3_subsample_r3, []),
    "train_full_r5b": (train_full_r5b, []),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_raises_without_a_card(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv = MAINS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    assert not os.listdir(tmp_path)  # it raised before writing anything
