"""The port's preprocess and train CLIs and its FrameworkConfig, run
in-process on the CPU against the JAX package's: the edges CSV, the
prepared artifact, the checkpoints and logs, YAML configs, and every
multi-host signal reaching the bootstrap (a partial world raises)."""
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from gnn_ecommerce_tpu.cli import preprocess as jax_preprocess
from gnn_ecommerce_tpu.data.artifacts import _FIELDS as JAX_FIELDS
from gnn_ecommerce_tpu.data.events import EVENT_TYPE_WEIGHTS_V1, events_to_edges
from gnn_ecommerce_tpu.data.prepare import prepare_splits, split_edges
from gnn_ecommerce_tpu.data.synthetic import synthetic_events
from gnn_ecommerce_tpu_torch.cli import preprocess as preprocess_cli
from gnn_ecommerce_tpu_torch.cli import train as train_cli
from gnn_ecommerce_tpu_torch.cli.config import FrameworkConfig
from gnn_ecommerce_tpu_torch.data.artifacts import _FIELDS, load_prepared
from gnn_ecommerce_tpu_torch.data.events import read_csv

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--dim", "8", "--layers", "2"]


def read_log(path="model-checkpoints/train_log.jsonl") -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_preprocess_csv_reads_back_as_jax_edges(tmp_path):
    ev = synthetic_events(n_users=120, n_items=30, n_events=2500, seed=1)
    raw = ev.rename(columns={"item_id": "product_id"})
    raw["price"] = 1.5
    events_path = tmp_path / "raw.csv"
    raw.to_csv(events_path, index=False)
    out, jax_out = tmp_path / "edges.csv", tmp_path / "edges_jax.csv"
    argv = ["--events", str(events_path), "--scheme", "v2", "--item-col", "product_id"]
    preprocess_cli.main([*argv, "-o", str(out)])
    jax_preprocess.main([*argv, "-o", str(jax_out)])
    assert out.read_text() == jax_out.read_text()
    # pandas' default float parser is not correctly rounded (it reads
    # 0.44999999999999996 as 0.4499999999999999), so the exact read-back
    # takes its round-trip parser, as the port's own reader does.
    got = pd.read_csv(out, float_precision="round_trip")
    assert list(got.columns) == ["user_id", "item_id", "weight"]
    want = events_to_edges(ev, {"view": 0.15, "cart": 0.35, "remove_from_cart": -0.2, "purchase": 1.0})
    pd.testing.assert_frame_equal(got, want.reset_index(drop=True), check_exact=True)
    cols = read_csv(str(out))
    for name in got.columns:
        np.testing.assert_array_equal(cols[name], want[name].to_numpy())
        assert cols[name].dtype == want[name].dtype


def test_preprocess_falls_back_to_csv_module_for_string_ids(tmp_path, capsys):
    rng = np.random.default_rng(4)
    n = 400
    raw = pd.DataFrame({
        "user_id": [f"u{k}" for k in rng.integers(0, 40, n)],
        "item_id": rng.integers(0, 12, n),
        "event_type": rng.choice(["view", "cart", "remove_from_cart", "purchase"], n),
    })
    events_path = tmp_path / "raw.csv"
    raw.to_csv(events_path, index=False)
    ev = preprocess_cli.load_events(str(events_path))
    assert len(ev) == n and "csv module" in capsys.readouterr().err
    out, jax_out = tmp_path / "edges.csv", tmp_path / "edges_jax.csv"
    preprocess_cli.main(["--events", str(events_path), "-o", str(out)])
    jax_preprocess.main(["--events", str(events_path), "-o", str(jax_out)])
    assert out.read_text() == jax_out.read_text()


def test_preprocess_missing_column_exits(tmp_path):
    path = tmp_path / "raw.csv"
    path.write_text("user_id,item_id\n1,2\n")
    with pytest.raises(SystemExit, match="missing columns: \\['event_type'\\]"):
        preprocess_cli.main(["--events", str(path), "-o", str(tmp_path / "e.csv")])


def test_train_cli_synthetic_matches_jax_artifact(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_cli.main([
        "--synthetic", "--synthetic-users", "200", "--synthetic-items", "50",
        "--synthetic-events", "4000", "-e", "2", "--dim", "16", "--layers", "2",
        "--device", "cpu",
    ])
    assert os.path.exists("data/prepared/manifest.json")
    for name in ("LightGCN_best", "LightGCN_last"):
        assert os.path.exists(f"model-checkpoints/{name}/checkpoint.npz")
    meta = json.load(open("model-checkpoints/LightGCN_best/meta.json"))
    assert meta["hyperparams"]["latent_dim"] == 16
    log = read_log()
    assert len([r for r in log if "epoch" in r]) == 2
    assert log[0]["etl_s"] > 0 and log[0]["data_dir"] == "data/prepared"

    edges = events_to_edges(
        synthetic_events(n_users=200, n_items=50, n_events=4000, seed=42), EVENT_TYPE_WEIGHTS_V1
    )
    want = prepare_splits(*split_edges(edges, seed=42))
    got = load_prepared("data/prepared")
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    for name in _FIELDS:
        a, b = np.asarray(_FIELDS[name](got)), np.asarray(JAX_FIELDS[name](want))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_train_cli_edges_csv(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    edges = events_to_edges(
        synthetic_events(n_users=150, n_items=40, n_events=3000, seed=2), EVENT_TYPE_WEIGHTS_V1
    )
    edges.to_csv("edges.csv", index=False)
    train_cli.main(["--edges", "edges.csv", "-e", "1", *TINY])
    assert os.path.exists("model-checkpoints/LightGCN_best/checkpoint.npz")
    got = load_prepared("data/prepared")
    want = prepare_splits(*split_edges(edges, seed=42))
    np.testing.assert_array_equal(got.edge_weight, want.edge_weight)
    assert len([r for r in read_log() if "epoch" in r]) == 1


def test_train_cli_edges_csv_missing_column(tmp_path):
    path = tmp_path / "edges.csv"
    path.write_text("user_id,item_id\n1,2\n")
    with pytest.raises(SystemExit, match="edges CSV missing columns"):
        train_cli.main(["--edges", str(path), "-e", "1", *TINY])


def test_train_cli_movielens(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    n = 3000
    rows = np.stack([rng.integers(1, 200, n), rng.integers(1, 60, n), rng.integers(1, 6, n),
                     np.full(n, 881250949)], axis=1)
    udata = tmp_path / "u.data"
    np.savetxt(udata, rows, fmt="%d", delimiter="\t")
    monkeypatch.chdir(tmp_path)
    train_cli.main(["--movielens", str(udata), "-e", "1", *TINY])
    assert os.path.exists("model-checkpoints/LightGCN_best/checkpoint.npz")
    assert len([r for r in read_log() if "epoch" in r]) == 1


def test_framework_config_yaml_roundtrip(tmp_path):
    cfg = FrameworkConfig(weight_scheme="v2")
    cfg.train.epochs = 7
    path = tmp_path / "fw.yaml"
    cfg.dump(str(path))
    loaded = FrameworkConfig.load(str(path))
    assert loaded.train.epochs == 7
    assert loaded.weights()["view"] == 0.15
    assert loaded == cfg


def test_framework_config_rejects_unknown_keys(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("weight_scheme: v1\nnot_a_key: 3\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        FrameworkConfig.load(str(path))
    path.write_text("train:\n  not_a_field: 1\n")
    with pytest.raises(ValueError, match="unknown train config keys"):
        FrameworkConfig.load(str(path))


def test_config_without_yaml_raises_clearly(tmp_path, monkeypatch):
    path = tmp_path / "fw.yaml"
    path.write_text("weight_scheme: v2\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        train_cli.main(["--config", str(path), "--synthetic", "-e", "1", *TINY])
    with pytest.raises(RuntimeError, match="PyYAML"):
        FrameworkConfig().dump(str(tmp_path / "out.yaml"))
    assert FrameworkConfig().weights()["view"] == 0.01


@pytest.mark.parametrize(
    "argv,env,match",
    [
        (["--num-processes", "2", "--process-id", "0"], {}, "go together"),
        (["--process-id", "1"], {}, "go together"),
        ([], {"JAX_COORDINATOR_ADDRESS": "h0:9999"}, "JAX_COORDINATOR_ADDRESS"),
        (["--distributed"], {}, "needs a world"),
        (["--coordinator", "h0:9999"], {}, "go together"),
        ([], {"WORLD_SIZE": "2"}, "partial torch.distributed environment"),
        (["--num-processes", "2"], {}, "go together"),
        ([], {"MASTER_ADDR": "h0", "RANK": "1"}, "partial torch.distributed environment"),
    ],
)
def test_train_cli_refuses_every_multi_host_signal(tmp_path, monkeypatch, argv, env, match):
    """Every multi-host signal reaches the bootstrap, and a partial world
    raises before any ETL or training: no host trains as a job of its own."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    with pytest.raises((ValueError, SystemExit), match=match):
        train_cli.main(["--synthetic", "-e", "1", *TINY, *argv])
    assert not os.path.exists("data") and not os.path.exists("model-checkpoints")


def test_train_cli_mesh_raises(tmp_path, monkeypatch):
    """A mesh larger than the world (here no world: one rank) raises."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="mesh_devices=2, but the torch.distributed world has 1"):
        train_cli.main(["--synthetic", "-e", "1", "--mesh", "2", *TINY])
