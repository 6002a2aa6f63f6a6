"""The port's EDA (``data/eda.py``, ``data/profile.py``, ``cli/eda.py``)
against the JAX package's on the same inputs: ``event_stats`` equal to
JAX's on ``tests/test_svd_and_eda.py``'s cases, ``profile_frame`` equal to
JAX's on CSVs read by each package's reader (counts, labels and the sample
table exact, floats to 1e-12), and ``cli.eda``'s three outputs byte-equal to
JAX's on ``tests/test_cli.py::test_eda_cli``'s CSV."""
import json

import numpy as np
import pandas as pd
import pytest
import torch

from gnn_ecommerce_tpu.cli import eda as jax_eda_cli
from gnn_ecommerce_tpu.data.eda import event_stats as jax_event_stats
from gnn_ecommerce_tpu.data.profile import _profile_datetime as jax_profile_datetime
from gnn_ecommerce_tpu.data.profile import profile_frame as jax_profile_frame
from gnn_ecommerce_tpu.data.profile import profile_report as jax_profile_report
from gnn_ecommerce_tpu.data.synthetic import synthetic_events as jax_synthetic_events
from gnn_ecommerce_tpu_torch.cli import eda as eda_cli
from gnn_ecommerce_tpu_torch.data.eda import event_stats
from gnn_ecommerce_tpu_torch.data.events import Events
from gnn_ecommerce_tpu_torch.data.frame import read_frame
from gnn_ecommerce_tpu_torch.data.profile import (
    head_html, memory_bytes, profile_frame, profile_report,
)
from gnn_ecommerce_tpu_torch.data.synthetic import synthetic_events

torch.set_num_threads(1)


def test_event_stats_small_case_matches_jax():
    users = [1, 1, 1, 2, 2, 3]
    items = [10, 11, 10, 10, 12, 11]
    types = ["view", "cart", "purchase", "view", "view", "view"]
    ref = jax_event_stats(pd.DataFrame({"user_id": users, "item_id": items, "event_type": types}))
    got = event_stats(Events(np.array(users), np.array(items), np.array(types)))
    assert got == ref


@pytest.mark.parametrize("kwargs", [
    {"n_users": 500, "n_items": 100, "n_events": 10000},
    {"n_users": 80, "n_items": 30, "n_events": 900, "seed": 3},
    {"n_users": 300, "n_items": 50, "n_events": 4000, "seed": 5, "n_clusters": 4, "n_pairs": 1500},
])
def test_event_stats_synthetic_matches_jax(kwargs):
    """Equal dicts, key order and float bits included (the event types are
    codes here, names in JAX's frame)."""
    got = event_stats(synthetic_events(**kwargs))
    ref = jax_event_stats(jax_synthetic_events(**kwargs))
    assert json.dumps(got) == json.dumps(ref)


def test_event_stats_ties_keep_first_seen_order():
    types = np.array(["cart", "view", "view", "cart", "purchase"])
    got = event_stats(Events(np.arange(5), np.arange(5), types))
    ref = jax_event_stats(pd.DataFrame({"user_id": np.arange(5), "item_id": np.arange(5), "event_type": types}))
    assert list(got["event_type_counts"]) == list(ref["event_type_counts"]) == ["cart", "view", "purchase"]


def _write(tmp_path, name, frame: pd.DataFrame) -> str:
    path = str(tmp_path / name)
    frame.to_csv(path, index=False)
    return path


def _cli_csv(tmp_path) -> str:
    """``tests/test_cli.py::test_eda_cli``'s raw CSV."""
    ev = jax_synthetic_events(n_users=80, n_items=30, n_events=900, seed=3)
    ev = ev.rename(columns={"item_id": "product_id"})
    ev["price"] = 1.5
    return _write(tmp_path, "raw.csv", ev)


def _mixed_csv(tmp_path, n=600, seed=0) -> str:
    """Missing numbers and strings, negatives, ties, a bool column, a
    constant column and floats of every magnitude."""
    rng = np.random.default_rng(seed)
    price = np.round(rng.lognormal(3, 1, n), 2)
    price[rng.random(n) < 0.1] = np.nan
    brand = rng.choice(["acme", "b&o", "<none>", "zeta", "ü-brand"] + [f"x{i}" for i in range(20)], n)
    brand = np.where(rng.random(n) < 0.15, None, brand)
    return _write(tmp_path, "mixed.csv", pd.DataFrame({
        "user_id": rng.integers(0, 50, n),
        "delta": rng.integers(-5, 5, n),
        "price": price,
        "tiny": rng.random(n) * 1e-8,
        "big": rng.random(n) * 1e9,
        "flag": rng.random(n) < 0.3,
        "const": np.full(n, 0.1),
        "brand": brand,
        "code": rng.choice(["a", "b"], n),
    }))


def _assert_close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a != a:
            assert b != b
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    else:
        assert a == b and type(a) is type(b)


def _assert_profile_equal(got: dict, ref: dict):
    for key, v in ref["overview"].items():
        _assert_close(got["overview"][key], v)
    assert list(got["variables"]) == list(ref["variables"])
    for name, rv in ref["variables"].items():
        gv = got["variables"][name]
        assert (gv["kind"], gv["dtype"], gv["missing"], gv["distinct"]) == (
            rv["kind"], rv["dtype"], rv["missing"], rv["distinct"]
        ), name
        _assert_close(gv["missing_pct"], rv["missing_pct"])
        assert [k for k, _ in gv["stats"]] == [k for k, _ in rv["stats"]]
        for (_, a), (_, b) in zip(gv["stats"], rv["stats"]):
            _assert_close(a, b)
        assert gv["hist"] == (list(rv["hist"][0]), list(rv["hist"][1])), name
    gc, rc = got["correlations"], ref["correlations"]
    assert bool(gc) == bool(rc)
    if rc:
        assert gc["columns"] == rc["columns"]
        for m in ("pearson", "spearman"):
            np.testing.assert_allclose(np.array(gc[m]), np.array(rc[m]), rtol=1e-12, atol=1e-12)
    assert got["sample_html"] == ref["sample_html"]


@pytest.mark.parametrize("which", ["cli", "mixed"])
@pytest.mark.parametrize("sample_rows", [1_000_000, 250])
def test_profile_frame_matches_jax(tmp_path, which, sample_rows):
    """The whole frame, and a 250-row sample drawn as pandas draws it."""
    path = _cli_csv(tmp_path) if which == "cli" else _mixed_csv(tmp_path)
    got = profile_frame(read_frame(path), sample_rows=sample_rows, seed=7)
    ref = jax_profile_frame(pd.read_csv(path), sample_rows=sample_rows, seed=7)
    _assert_profile_equal(got, ref)


@pytest.mark.parametrize("which", ["cli", "mixed"])
def test_profile_report_html_matches_jax(tmp_path, which):
    path = _cli_csv(tmp_path) if which == "cli" else _mixed_csv(tmp_path)
    headline = {"n_events": 900, "purchase_share": 0.0633, "note": "a<b"}
    got = profile_report(read_frame(path), title="T & t", headline=headline, sample_rows=400)
    ref = jax_profile_report(pd.read_csv(path), title="T & t", headline=headline, sample_rows=400)
    assert got == ref


def test_eda_cli_outputs_equal_jax_bytes(tmp_path, capsys):
    raw = _cli_csv(tmp_path)
    outs = {}
    for name, cli in (("jax", jax_eda_cli), ("port", eda_cli)):
        d = tmp_path / name
        d.mkdir()
        cli.main([
            "--events", raw, "--item-col", "product_id", "--stats", str(d / "stats.json"),
            "--report", str(d / "report.html"), "--out-events", str(d / "user_item_event.csv"),
        ])
        outs[name] = capsys.readouterr().out
    for f in ("stats.json", "report.html", "user_item_event.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert outs["port"] == outs["jax"]


def test_eda_cli_refuses_missing_columns(tmp_path):
    path = _write(tmp_path, "bad.csv", pd.DataFrame({"user_id": [1], "event_type": ["view"]}))
    with pytest.raises(SystemExit, match="missing columns"):
        eda_cli.main(["--events", path])


@pytest.mark.parametrize("n_cols", [3, 31, 40])
def test_head_html_matches_to_html(tmp_path, n_cols):
    """pandas' to_html of the first ten rows, wide frames cut to 30 columns."""
    rng = np.random.default_rng(n_cols)
    cols = {f"c{j}": (rng.random(12) * 10 ** (j % 9 - 3)).round(j % 5) for j in range(n_cols)}
    cols["c1"] = np.where(rng.random(12) < 0.3, np.nan, cols["c1"])
    path = _write(tmp_path, "wide.csv", pd.DataFrame(cols))
    buf = pd.read_csv(path).head(10).to_html(border=0, index=False, max_cols=30)
    assert head_html(read_frame(path)) == buf


def test_memory_bytes_match_pandas(tmp_path):
    path = _mixed_csv(tmp_path, n=333)
    assert memory_bytes(read_frame(path)) == int(pd.read_csv(path).memory_usage(deep=False).sum())


TIMES = ["2019-10-01 00:00:00 UTC", "2019-11-30 23:59:59 UTC", None, "2019-10-15 12:30:00 UTC"]


def test_datetime_column_profiles_as_jax_datetime(tmp_path):
    """A deliberate difference: under pandas >= 3 the JAX profile's test for
    a datetime column (``s.dtype == object``) misses ``str`` columns and
    profiles ``event_time`` as categorical; the port profiles it as a
    datetime, equal to the JAX package's own ``_profile_datetime``."""
    path = _write(tmp_path, "t.csv", pd.DataFrame({"event_time": TIMES * 5, "x": np.arange(20)}))
    got = profile_frame(read_frame(path))["variables"]["event_time"]
    ref = jax_profile_datetime(pd.read_csv(path)["event_time"])
    assert got["kind"] == ref["kind"] == "datetime"
    assert got["stats"] == ref["stats"]
    assert got["hist"] == (list(ref["hist"][0]), list(ref["hist"][1]))
    assert jax_profile_frame(pd.read_csv(path))["variables"]["event_time"]["kind"] == (
        "categorical" if int(pd.__version__.split(".")[0]) >= 3 else "datetime"
    )


def test_datetime_column_of_another_format_raises(tmp_path):
    path = _write(tmp_path, "t.csv", pd.DataFrame({"event_time": ["2019/10/01", "2019/10/02"]}))
    with pytest.raises(ValueError, match="YYYY-MM-DD HH:MM:SS UTC"):
        profile_frame(read_frame(path))
