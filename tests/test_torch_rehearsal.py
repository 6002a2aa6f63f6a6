"""The Day-0 rehearsal (``runs/real_data_rehearsal.py``) on the CPU, against
``scripts/real_data_rehearsal.py`` (loaded unedited; its ``main`` writes
into the repo and is never called) and the JAX package's CLIs on the same
files.

- ``fabricate`` at 3,000 rows and seed 42 writes JAX's files line for line
  but for the last field (the sessions, from unseeded UUIDs), with the same
  rows sharing a session; the pandas dialect's corner cases are in them.
- The concatenation is pandas' round trip of the same files, byte for byte.
- On those files the port's ``cli.eda`` and ``cli.preprocess`` give JAX's
  counts and JAX's bytes.
- ``run`` at 6,000 rows, quick, passes every stage with the TPU file's keys
  plus the card and the launches, 20 items in the REST answer, and writes
  nothing outside ``--work``; ``--raw-dir`` skips fabrication; ``main``
  holds its bars.
- The sampler clamps the negative of a user who ignores every item, as
  JAX's gathers clamp its out-of-range index.
"""
import glob
import importlib.util
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gnn_ecommerce_tpu.cli import eda as jax_eda
from gnn_ecommerce_tpu.cli import preprocess as jax_preprocess
from gnn_ecommerce_tpu.sampling import bpr as jax_bpr
from gnn_ecommerce_tpu_torch.cli import eda as eda_cli
from gnn_ecommerce_tpu_torch.cli import preprocess as preprocess_cli
from gnn_ecommerce_tpu_torch.runs import bars
from gnn_ecommerce_tpu_torch.runs import real_data_rehearsal as rehearsal
from gnn_ecommerce_tpu_torch.sampling import bpr

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TPU_FILE = ROOT / "scripts" / "real_data_rehearsal.json"
ROWS = 3_000


def _script():
    spec = importlib.util.spec_from_file_location(
        "_rehearsal_script", ROOT / "scripts" / "real_data_rehearsal.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fabricated(tmp_path_factory):
    """(the port's raw dir, JAX's raw dir), both at ROWS rows and seed 42."""
    base = tmp_path_factory.mktemp("fabricated")
    port, jax_dir = base / "port", base / "jax"
    written = rehearsal.fabricate(str(port), ROWS)
    assert written == _script().fabricate(str(jax_dir), ROWS)
    assert sum(written.values()) == ROWS
    return port, jax_dir


def _lines(path) -> list:
    return pathlib.Path(path).read_text().splitlines()


@pytest.mark.parametrize("month", rehearsal.MONTHS)
def test_fabricate_matches_jax_but_the_sessions(fabricated, month):
    port, jax_dir = fabricated
    mine, theirs = _lines(port / f"{month}.csv"), _lines(jax_dir / f"{month}.csv")
    assert mine[0] == theirs[0] == ",".join(rehearsal.KAGGLE_COLUMNS)
    assert len(mine) == len(theirs) == ROWS // 5 + 1
    assert [m.rsplit(",", 1)[0] for m in mine] == [t.rsplit(",", 1)[0] for t in theirs]


def test_fabricate_groups_rows_into_the_same_sessions(fabricated):
    port, jax_dir = fabricated

    def groups(d):
        sessions = pd.concat(pd.read_csv(d / f"{m}.csv")["user_session"] for m in rehearsal.MONTHS)
        return pd.factorize(sessions)[0]

    np.testing.assert_array_equal(groups(port), groups(jax_dir))


def test_rows_digest_matches_jax(fabricated):
    port, jax_dir = fabricated
    assert rehearsal.rows_digest(str(port)) == rehearsal.rows_digest(str(jax_dir))


@pytest.mark.parametrize("a", [1.3, 1.2])
def test_zipf_is_numpy_2_0s(a):
    """The draws and the stream left behind equal numpy 2.0's zipf (this
    host's numpy, whose draws the TPU file's counts come from)."""
    mine, theirs = np.random.default_rng(42), np.random.default_rng(42)
    np.testing.assert_array_equal(rehearsal.zipf(mine, a, 50_000), theirs.zipf(a, 50_000))
    assert mine.random() == theirs.random()


@pytest.mark.parametrize("field", ['"co, ltd"', '"jas,""pro"""', '"accessories.bag,""hand"""',
                                   ",,", "UTC,", ".0,", ",14875800000000000"])
def test_fabricate_writes_the_pandas_dialect(fabricated, field):
    """Quoted commas with doubled quotes, empty fields for empty strings, a
    price of whole units as ``x.0``, the category id as an integer."""
    port, _ = fabricated
    assert any(field in (port / f"{m}.csv").read_text() for m in rehearsal.MONTHS)


def test_concat_is_pandas_round_trip(fabricated, tmp_path):
    port, _ = fabricated
    files = sorted(glob.glob(str(port / "*.csv")))
    out = tmp_path / "events_all.csv"
    assert rehearsal.concat(files, str(out)) == (ROWS, True)
    want = tmp_path / "pandas.csv"
    pd.concat((pd.read_csv(f) for f in files), ignore_index=True).to_csv(want, index=False)
    assert out.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("text,match", [
    ("user_id,item_id,event_type\n1,2,view\n", "header"),
    (",".join(rehearsal.KAGGLE_COLUMNS) + "\n1,2,3\n", "3 fields"),
])
def test_concat_refuses_another_schema(tmp_path, text, match):
    (tmp_path / "a.csv").write_text(text)
    with pytest.raises(ValueError, match=match):
        rehearsal.concat([str(tmp_path / "a.csv")], str(tmp_path / "out.csv"))


def test_raw_dir_without_csvs_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        rehearsal.run(str(tmp_path / "work"), raw_dir=str(tmp_path), device="cpu")


def test_eda_and_preprocess_match_jax(fabricated, tmp_path):
    port, _ = fabricated
    concat = str(tmp_path / "events_all.csv")
    rehearsal.concat(sorted(glob.glob(str(port / "*.csv"))), concat)
    outs = {}
    for name, eda, prep in (("port", eda_cli, preprocess_cli), ("jax", jax_eda, jax_preprocess)):
        d = tmp_path / name
        d.mkdir()
        eda.main(["--events", concat, "--item-col", "product_id", "--stats", str(d / "stats.json"),
                  "--out-events", str(d / "uie.csv")])
        prep.main(["--events", str(d / "uie.csv"), "-o", str(d / "edges.csv"), "--scheme", "v1"])
        outs[name] = d
    stats = {n: json.loads((d / "stats.json").read_text()) for n, d in outs.items()}
    for key in ("n_events", "n_users", "n_items"):
        assert stats["port"][key] == stats["jax"][key]
    assert stats["port"]["n_events"] == ROWS
    for name in ("uie.csv", "edges.csv"):
        assert (outs["port"] / name).read_bytes() == (outs["jax"] / name).read_bytes()
    assert len(pd.read_csv(outs["port"] / "edges.csv")) > 0


@pytest.fixture(scope="module")
def quick_line(tmp_path_factory):
    """``main`` at 6,000 rows, quick, from a working directory of its own."""
    base = tmp_path_factory.mktemp("quick")
    cwd, work, out = base / "cwd", base / "work", base / "line.json"
    cwd.mkdir()
    before = os.getcwd()
    os.chdir(cwd)
    try:
        assert rehearsal.main(["--rows", "6000", "--quick", "--device", "cpu", "--work", str(work),
                               "--out", str(out)]) == 0
        assert os.getcwd() == str(cwd)
    finally:
        os.chdir(before)
    return json.loads(out.read_text()), cwd, work


def test_run_passes_every_stage_with_the_tpu_keys(quick_line):
    line, _, _ = quick_line
    tpu = json.loads(TPU_FILE.read_text())
    assert set(line) == set(tpu) | rehearsal.EXTRA_KEYS
    assert line["rows_requested"] == 6000 and line["concat"] == {**line["concat"], "rows": 6000, "files": 5}
    assert sum(line["fabricate"]["per_month"].values()) == 6000
    assert line["eda"]["n_users"] > 0 and line["preprocess"]["unique_edges"] > 0
    assert (line["train"]["dim"], line["train"]["layers"], line["train"]["epochs"]) == (16, 2, 2)
    assert line["serve"]["n_items"] == 20 and len(line["serve"]["items"]) == 5
    assert set(line["launches"]) == {"fabricate", "concat", "eda", "preprocess", "train", "infer", "serve"}
    assert line["device"] == "cpu"
    # A quick run holds only the answer's bar; the TPU's counts are the full run's.
    assert [b["what"] for b in line["bars"]] == ["items in the REST answer"]


def test_run_writes_only_under_work(quick_line):
    _, cwd, work = quick_line
    assert list(cwd.iterdir()) == []
    for name in ("raw", "events_all.csv", "stats.json", "profile.html", "user_item_event.csv",
                 "u_i_weight.csv", "data", "model-checkpoints", "recs"):
        assert (work / name).exists(), name


def test_raw_dir_skips_fabrication(fabricated, tmp_path):
    port, _ = fabricated
    line = rehearsal.run(str(tmp_path / "work"), rows=123, quick=True, raw_dir=str(port), device="cpu")
    assert "fabricate" not in line and not (tmp_path / "work" / "raw").exists()
    assert line["concat"]["rows"] == ROWS and line["serve"]["n_items"] == 20


def _tpu_line(**train) -> dict:
    line = json.loads(TPU_FILE.read_text())
    line["train"].update(dim=32, layers=3, epochs=5, **train)
    line["serve"]["n_items"] = 20
    return line


@pytest.mark.parametrize("where,key,delta", [
    ("concat", "rows", 1), ("concat", "files", 1), ("eda", "n_users", -1), ("eda", "n_items", 1),
    ("preprocess", "unique_edges", 1), ("train", "val_recall", 0.021), ("serve", "n_items", -1),
])
def test_rehearsal_bars(where, key, delta):
    line = _tpu_line()
    held = bars.hold(line, bars.real_data_rehearsal(line))["bars"]
    assert len(held) == 7 and all(b["held"] for b in held)
    line[where][key] += delta
    with pytest.raises(bars.BarMissed):
        bars.hold(line, bars.real_data_rehearsal(line))


def test_sampler_clamps_a_user_who_ignores_every_item():
    """User 0 ignores all 3 items: JAX's map gives node 5 (n_users +
    n_items), one past the table, which its gathers clamp to node 4."""
    n_users, n_items = 2, 3
    data = bpr.BprSamplerData(
        users=torch.tensor([0, 1]), pos_indptr=torch.tensor([0, 3, 4]),
        pos_flat=torch.tensor([2, 3, 4, 3]), ign_indptr=torch.tensor([0, 3, 4]),
        ign_flat=torch.tensor([2, 3, 4, 3]), n_users=n_users, n_items=n_items,
    )
    users, _, neg = bpr.sample_batch(torch.Generator().manual_seed(0), data, 64)
    assert (neg[users == 0] == n_users + n_items - 1).all()
    assert set(neg[users == 1].tolist()) <= {2, 4} and (neg < n_users + n_items).all()
    jax_neg = int(jax_bpr._rank_to_allowed_item(
        jnp.asarray([2, 3, 4], jnp.int32), jnp.zeros(1, jnp.int32), jnp.full(1, 3, jnp.int32),
        jnp.zeros(1, jnp.int32), n_users)[0])
    assert jax_neg == n_users + n_items
    assert int(jnp.arange(n_users + n_items)[jax_neg]) == n_users + n_items - 1
