"""The port's numpy ETL against the JAX package's pandas ETL, with exact
equality: the native groupby and CSV reader, the event weights, the
synthetic generator, the split, every array of prepare_splits, the
MovieLens loader, the popularity baseline and CsrList.row."""
import numpy as np
import pandas as pd
import pytest
import torch

from gnn_ecommerce_tpu import native as jax_native
from gnn_ecommerce_tpu.data import events as jax_events
from gnn_ecommerce_tpu.data.artifacts import _FIELDS as JAX_FIELDS
from gnn_ecommerce_tpu.data.movielens import load_movielens as jax_load_movielens
from gnn_ecommerce_tpu.data.prepare import prepare_splits as jax_prepare_splits
from gnn_ecommerce_tpu.data.prepare import split_edges as jax_split_edges
from gnn_ecommerce_tpu.data.synthetic import synthetic_events as jax_synthetic_events
from gnn_ecommerce_tpu.eval.baselines import popularity_recall_at_k as jax_popularity
from gnn_ecommerce_tpu_torch import native
from gnn_ecommerce_tpu_torch.data import events
from gnn_ecommerce_tpu_torch.data.artifacts import _FIELDS
from gnn_ecommerce_tpu_torch.data.events import EVENT_TYPES, Edges, Events
from gnn_ecommerce_tpu_torch.data.movielens import load_movielens
from gnn_ecommerce_tpu_torch.data.prepare import prepare_splits, split_edges
from gnn_ecommerce_tpu_torch.data.synthetic import synthetic_events
from gnn_ecommerce_tpu_torch.eval.baselines import popularity_recall_at_k

torch.set_num_threads(1)

SCHEMES = {
    "v1": events.EVENT_TYPE_WEIGHTS_V1,
    "v2": events.EVENT_TYPE_WEIGHTS_V2,
    "explicit": {"view": 0.2, "cart": 0.3, "remove_from_cart": -0.45, "purchase": 0.9},
}


def assert_same(port: np.ndarray, ref) -> None:
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def assert_edges(port: Edges, frame: pd.DataFrame) -> None:
    assert list(frame.columns) == ["user_id", "item_id", "weight"]
    for col in frame.columns:
        assert_same(getattr(port, col), frame[col].to_numpy())


def random_events(seed: int, n: int = 3000, as_codes: bool = True) -> Events:
    """Events with many repeated pairs and every type, ids sparse."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(4, n, p=[0.5, 0.2, 0.15, 0.15]).astype(np.int8)
    user = rng.permutation(900)[rng.integers(0, 60, n)]
    item = rng.permutation(500)[rng.integers(0, 25, n)] + 10_000
    et = codes if as_codes else np.asarray(EVENT_TYPES)[codes]
    return Events(user, item, et)


def jax_frame(ev: Events) -> pd.DataFrame:
    if ev.event_type.dtype.kind in "iu":
        et = pd.Categorical.from_codes(ev.event_type, categories=list(EVENT_TYPES))
    else:
        et = ev.event_type.astype(object)
    return pd.DataFrame({"user_id": ev.user_id, "item_id": ev.item_id, "event_type": et})


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_groupby_edges_matches_jax(path, monkeypatch):
    rng = np.random.default_rng(7)
    n, n_u, n_i = 5000, 80, 40
    u, i = rng.integers(0, n_u, n), rng.integers(0, n_i, n)
    w = rng.standard_normal(n) * 0.3
    p = (rng.random(n) < 0.1).astype(np.uint8)
    if path == "fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    else:
        assert native._load() is not None and jax_native._load() is not None
    got = native.groupby_edges(u, i, w, p, n_u, n_i)
    want = jax_native.groupby_edges(u, i, w, p, n_u, n_i)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_groupby_edges_fallback_equals_native(monkeypatch):
    rng = np.random.default_rng(8)
    n = 4000
    args = (rng.integers(0, 50, n), rng.integers(0, 30, n), rng.random(n) * 0.7,
            (rng.random(n) < 0.2).astype(np.uint8), 50, 30)
    native_out = native.groupby_edges(*args)
    monkeypatch.setattr(native, "_load", lambda: None)
    for a, b in zip(native.groupby_edges(*args), native_out):
        assert_same(a, b)


def test_read_events_csv_matches_jax(tmp_path):
    path = tmp_path / "raw.csv"
    path.write_text(
        'event_time,event_type,product_id,category,user_id\n'
        '2019-10-01,view,"5",cat,"17"\n'
        '2019-10-01,cart,6,"a,b",18\r\n'
        '2019-10-02,purchase,7.0,x,19\n'
        '2019-10-02,view,abc,x,20\n'
        '2019-10-03,"remove_from_cart",8,,21\n'
        '2019-10-03,view,9,y,-22\n'
    )
    got = native.read_events_csv(str(path), "user_id", "product_id")
    want = jax_native.read_events_csv(str(path), "user_id", "product_id")
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    assert got[2].dtype.kind == "U"
    assert got[2].tolist() == want[2].tolist()
    # "abc" and the negative id -22 do not parse as ids: both rows drop.
    assert got[2].tolist() == ["view", "cart", "purchase", "remove_from_cart"]
    assert got[0].tolist() == [17, 18, 19, 21] and got[1].tolist() == [5, 6, 7, 8]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("as_codes", [True, False], ids=["codes", "names"])
def test_event_weights_match_jax(scheme, as_codes):
    ev = random_events(11, as_codes=as_codes)
    weights = SCHEMES[scheme]
    raw = events.raw_edge_weight(ev, weights)
    jraw = jax_events.raw_edge_weight(jax_frame(ev), weights)
    for col in ("user_id", "item_id", "weight", "purchased"):
        assert_same(getattr(raw, col), jraw[col].to_numpy())
    assert_edges(events.proper_edge_weight(raw), jax_events.proper_edge_weight(jraw))
    assert_edges(events.events_to_edges(ev, weights), jax_events.events_to_edges(jax_frame(ev), weights))


def test_purchase_with_remove_from_cart_is_not_a_positive():
    ev = Events(
        np.array([1, 1, 2, 2, 2]), np.array([5, 5, 6, 6, 6]),
        np.array(["purchase", "remove_from_cart", "purchase", "cart", "cart"]),
    )
    edges = events.events_to_edges(ev, events.EVENT_TYPE_WEIGHTS_V1)
    want = jax_events.events_to_edges(jax_frame(ev), events.EVENT_TYPE_WEIGHTS_V1)
    assert_edges(edges, want)
    assert edges.weight[0] == 1.0 - 0.09 and edges.weight[1] == 1.0


def test_unknown_event_type_raises_as_jax():
    ev = Events(np.array([1, 2, 3]), np.array([4, 5, 6]), np.array(["view", "wishlist", "like"]))
    with pytest.raises(ValueError) as want:
        jax_events.events_to_edges(jax_frame(ev), events.EVENT_TYPE_WEIGHTS_V1)
    with pytest.raises(ValueError) as got:
        events.events_to_edges(ev, events.EVENT_TYPE_WEIGHTS_V1)
    assert str(got.value) == str(want.value) == "unknown event types: ['like', 'wishlist']"
    partial = {"view": 0.01, "cart": 0.1, "purchase": 1.0}
    with pytest.raises(ValueError, match=r"unknown event types: \['remove_from_cart'\]"):
        events.events_to_edges(random_events(3), partial)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_users=500, n_items=80, n_events=6000, seed=3),
        dict(n_users=500, n_items=80, n_events=6000, seed=4, n_clusters=9, affinity=0.85,
             item_skew=0.9),
        dict(n_users=700, n_items=90, n_events=9000, seed=42, n_clusters=12, affinity=0.85,
             item_skew=0.9, n_pairs=4000),
        dict(n_users=300, n_items=3, n_events=2000, seed=5, n_clusters=8, n_pairs=500),
    ],
    ids=["plain", "clusters", "clusters_pairs", "empty_clusters"],
)
def test_synthetic_events_match_jax(kwargs):
    got = synthetic_events(**kwargs)
    want = jax_synthetic_events(**kwargs)
    assert len(got) == len(want)
    assert_same(got.user_id, want["user_id"].to_numpy())
    assert_same(got.item_id, want["item_id"].to_numpy())
    assert_same(got.event_type, want["event_type"].cat.codes.to_numpy())
    assert list(want["event_type"].cat.categories) == list(EVENT_TYPES)


def corpus(seed: int = 42):
    """(port edges, JAX edges) of one clustered corpus of about 2,000 users."""
    kw = dict(n_users=2000, n_items=150, n_events=24000, seed=seed, n_clusters=12,
              affinity=0.85, item_skew=0.9, n_pairs=12000)
    port = events.events_to_edges(synthetic_events(**kw), events.EVENT_TYPE_WEIGHTS_V1)
    ref = jax_events.events_to_edges(jax_synthetic_events(**kw), events.EVENT_TYPE_WEIGHTS_V1)
    assert_edges(port, ref)
    return port, ref


@pytest.fixture(scope="module")
def prepared_pair():
    port, ref = corpus()
    return prepare_splits(*split_edges(port, seed=42)), jax_prepare_splits(*jax_split_edges(ref, seed=42))


@pytest.mark.parametrize("test_size", [0.05, 0.2])
def test_split_edges_matches_jax(test_size):
    port, ref = corpus(7)
    for got, want in zip(split_edges(port, seed=3, test_size=test_size),
                         jax_split_edges(ref, seed=3, test_size=test_size)):
        assert_edges(got, want)


@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_prepare_splits_arrays_match_jax(prepared_pair, field):
    got, want = prepared_pair
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    assert len(got.val.user_ids) > 20 and len(got.test.user_ids) > 20
    assert_same(np.asarray(_FIELDS[field](got)), JAX_FIELDS[field](want))


def test_csr_list_row_matches_jax(prepared_pair):
    got, want = prepared_pair
    for split, jsplit in ((got.val, want.val), (got.test, want.test)):
        for r in range(len(split.user_ids)):
            assert_same(split.truth.row(r), jsplit.truth.row(r))
            assert_same(split.train_mask.row(r), jsplit.train_mask.row(r))
    assert len(got.val.truth.row(0)) == got.val.truth.lengths()[0]


@pytest.mark.parametrize("split", ["val", "test"])
def test_popularity_recall_matches_jax(prepared_pair, split):
    got, want = prepared_pair
    for k in (5, 20):
        a = popularity_recall_at_k(got, getattr(got, split), k)
        b = jax_popularity(want, getattr(want, split), k)
        assert abs(a - b) <= 1e-12 and 0.0 < a < 1.0


def test_load_movielens_fixture_matches_jax():
    assert_edges(load_movielens("data/ml100k_synth_u.data"), jax_load_movielens("data/ml100k_synth_u.data"))


@pytest.mark.parametrize(
    "name,text",
    [
        ("ratings.tsv", "user_id\titem_id\trating\ttimestamp\n1\t10\t5\t99\n2\t11\t2\t99\n3\t10\t4\t9\n"),
        ("ratings.dat", "1::10::5::978300760\n2::11::3::978302109\n2::12::4::978301968\n"),
        ("ratings.csv", "userId,movieId,rating,timestamp\n1,10,4.5,99\n2,11,2.5,99\n"),
        ("u.csv", "1,10,1,99\n7,3,4,98\n"),
    ],
)
def test_load_movielens_formats_match_jax(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    assert_edges(load_movielens(str(path)), jax_load_movielens(str(path)))


READ_CSV_CASES = {
    "numeric": "user_id,item_id,weight\n1,2,0.5\n3,4,0.30000000000000004\n",
    "float_after_int": "a,b\n1,2\n3.0,4\n",
    "quoted": 'a,b\n"1",2.5\n3,4\n',
    "blank_line": "a,b\n1,2.5\n\n3,4\n",
    "string_column": "a,b\nx,1\ny,2\n",
    "past_int64": "a,b\n9223372036854775808,1\n",
    "int64_min": "a,b\n-9223372036854775808,1\n",
    "header_only": "a,b\n",
    "spaces": "a, b\n1, 2.5\n 3 ,4\n",
    "missing_field_value": "a,b\n1,\n2,3\n",
}


def read_csv_module(path) -> dict:
    """The edges reader's result, parsed row by row by the csv module."""
    import csv

    with open(path, newline="") as f:
        header, *rows = [row for row in csv.reader(f) if row]
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {name.strip(): events._column(values) for name, values in zip(header, cols)}


@pytest.mark.parametrize("case", sorted(READ_CSV_CASES))
def test_read_csv_numeric_path_equals_csv_module(tmp_path, case):
    """read_csv's one-pass numeric parse gives the csv module's columns,
    dtypes included, or leaves the file to it."""
    path = tmp_path / "in.csv"
    path.write_text(READ_CSV_CASES[case])
    got, want = events.read_csv(str(path)), read_csv_module(path)
    assert list(got) == list(want)
    for name in want:
        assert_same(got[name], want[name])
    if case == "numeric":  # the edges CSV as JAX's cli/train reads it
        frame = pd.read_csv(path, float_precision="round_trip")
        for name in frame.columns:
            assert_same(got[name], frame[name].to_numpy())


def test_read_csv_wrong_field_count_raises(tmp_path):
    path = tmp_path / "in.csv"
    path.write_text("a,b\n1,2\n3\n")
    with pytest.raises(ValueError, match="1 fields, header has 2"):
        events.read_csv(str(path))


@pytest.mark.parametrize("kwargs", [
    {"seed": 42},  # the ML-100K shape
    {"n_users": 100, "n_items": 300, "n_ratings": 2100, "seed": 1},  # the truncation branch
])
def test_synthetic_movielens_matches_jax(kwargs):
    """``tests/test_cli.py``'s cases: every column equal to JAX's frame."""
    from gnn_ecommerce_tpu.data.movielens import synthetic_movielens as jax_synthetic_movielens
    from gnn_ecommerce_tpu_torch.data.movielens import synthetic_movielens

    got, ref = synthetic_movielens(**kwargs), jax_synthetic_movielens(**kwargs)
    assert got.columns == list(ref.columns) == ["user_id", "item_id", "rating"]
    for name in got.columns:
        np.testing.assert_array_equal(got[name], ref[name].to_numpy())
        assert got[name].dtype == ref[name].dtype


def test_synthetic_movielens_refuses_an_unreachable_target():
    from gnn_ecommerce_tpu_torch.data.movielens import synthetic_movielens

    with pytest.raises(ValueError, match="unreachable"):
        synthetic_movielens(n_users=100, n_items=300, n_ratings=1000, seed=1)
