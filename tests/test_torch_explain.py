"""The port's shortest-path explanations on the CPU against the JAX
package's: the native BFS node for node, the numpy BFS, the hit-path
table's CSV bytes on the committed prepared fixture, the fallback without
the native library, the plot's nodes and colours, and the Frame's CSV
writer against pandas.

Tolerances: none. Distances, paths and CSV bytes are compared exactly."""
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from gnn_ecommerce_tpu import native as jax_native
from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
from gnn_ecommerce_tpu.explain import paths as jax_paths
from gnn_ecommerce_tpu_torch import native
from gnn_ecommerce_tpu_torch.data.frame import Frame
from gnn_ecommerce_tpu_torch.explain import (
    build_adjacency,
    bfs_paths,
    hit_paths_frame,
    plot_user_paths,
)

torch.set_num_threads(1)

DATA = "data/prepared"


@pytest.fixture(scope="module")
def prepared():
    return jax_load_prepared(DATA)


@pytest.fixture(scope="module")
def adj(prepared):
    return build_adjacency(
        prepared.edge_user, prepared.edge_item_node, prepared.n_users, prepared.n_items
    )


def bfs_case(prepared, seed: int, n_sources: int = 40):
    """Sources (buyers, one repeated), and per source a few targets: random
    items, the source itself, and nodes of another component or beyond the
    cutoff where the graph has them."""
    rng = np.random.default_rng(seed)
    sources = rng.choice(prepared.sampler.users, n_sources, replace=False).astype(np.int64)
    sources[-1] = sources[0]
    counts = rng.integers(0, 6, n_sources)
    targets = [
        np.concatenate([
            prepared.n_users + rng.integers(0, prepared.n_items, c),
            [s] if c % 3 == 0 else [],
        ]).astype(np.int64)
        for s, c in zip(sources, counts)
    ]
    t_indptr = np.cumsum([0] + [len(t) for t in targets]).astype(np.int64)
    return sources, t_indptr, np.concatenate(targets).astype(np.int64)


@pytest.mark.parametrize("cutoff", [1, 2, 3, 8])
def test_bfs_batch_matches_jax_native_node_for_node(prepared, adj, cutoff):
    assert native.available() and jax_native.available()
    sources, t_indptr, targets = bfs_case(prepared, seed=cutoff)
    want_d, want_p = jax_native.bfs_batch(
        adj.indptr, adj.indices, sources, t_indptr, targets, cutoff
    )
    for threads in (1, 3):
        got_d, got_p = native.bfs_batch(
            adj.indptr, adj.indices, sources, t_indptr, targets, cutoff, n_threads=threads
        )
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(got_p, want_p)
    if cutoff == 1:
        assert (want_d == -1).any()  # some target beyond one hop


def test_bfs_batch_agrees_with_numpy_bfs(prepared, adj):
    """Native and numpy BFS: equal distances; every native path starts at
    its source, ends at its target and walks real edges (the parents of the
    two may differ where a node has several shortest parents)."""
    sources, t_indptr, targets = bfs_case(prepared, seed=11)
    dist, paths = native.bfs_batch(adj.indptr, adj.indices, sources, t_indptr, targets, 8)
    edges = set(zip(prepared.edge_user.tolist(), prepared.edge_item_node.tolist()))
    for s_idx, s in enumerate(sources):
        lo, hi = t_indptr[s_idx], t_indptr[s_idx + 1]
        for t, (d, path) in zip(range(lo, hi), bfs_paths(adj, int(s), targets[lo:hi], 8)):
            assert dist[t] == d
            if d < 0:
                continue
            got = paths[t, : d + 1].tolist()
            assert got[0] == s and got[-1] == targets[t] and path[-1] == targets[t]
            for a, b in zip(got[:-1], got[1:]):
                assert (a, b) in edges or (b, a) in edges


def test_bfs_paths_simple_cases():
    # users 0, 1; items -> nodes 2, 3. Edges u0-i2, u1-i2, u1-i3.
    adj = build_adjacency(np.array([0, 1, 1]), np.array([2, 2, 3]), n_users=2, n_items=2)
    [(d1, p1), (d2, p2)] = bfs_paths(adj, 0, np.array([2, 3]))
    assert d1 == 1 and p1 == [0, 2]
    assert d2 == 3 and p2 == [0, 2, 1, 3]
    split = build_adjacency(np.array([0, 1]), np.array([2, 3]), 2, 2)
    assert bfs_paths(split, 0, np.array([3])) == [(-1, None)]
    dist, paths = native.bfs_batch(
        adj.indptr, adj.indices, np.array([0]), np.array([0, 2]), np.array([2, 3]), 8
    )
    assert dist.tolist() == [1, 3] and paths[1, :4].tolist() == [0, 2, 1, 3]


def hit_case(prepared, seed: int):
    """Eval users of the val split, a random top-10 each that contains some
    of their truth, and their truth sets."""
    rng = np.random.default_rng(seed)
    split = prepared.val
    users = split.user_ids
    topk = rng.integers(0, prepared.n_items, (len(users), 10))
    truth = []
    for r in range(len(users)):
        row = split.truth.values[split.truth.indptr[r] : split.truth.indptr[r + 1]]
        if r % 2 == 0:
            topk[r, : len(row[:3])] = row[:3]
        truth.append(set(map(int, row)))
    return users, topk, truth


@pytest.mark.parametrize("cutoff", [2, 8])
def test_hit_paths_frame_csv_matches_jax(prepared, adj, tmp_path, cutoff):
    users, topk, truth = hit_case(prepared, seed=cutoff)
    jax_adj = jax_paths.build_adjacency(
        prepared.edge_user, prepared.edge_item_node, prepared.n_users, prepared.n_items
    )
    np.testing.assert_array_equal(adj.indptr, jax_adj.indptr)
    np.testing.assert_array_equal(adj.indices, jax_adj.indices)
    want = jax_paths.hit_paths_frame(jax_adj, users, topk, truth, cutoff=cutoff)
    got = hit_paths_frame(adj, users, topk, truth, cutoff=cutoff)
    assert got.columns == list(want.columns)
    assert len(got) == len(want) > 0
    want.to_csv(tmp_path / "jax.csv", index=False)
    got.to_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    if cutoff == 2:  # the 3-hop hits are missing: None paths, flagged
        assert (got["path_length"] == -1).any()
        assert got["longer_than_3"][got["path_length"] == -1].all()


def test_hit_paths_frame_falls_back_without_native(prepared, adj, tmp_path, monkeypatch):
    """Without the native library both packages take their numpy BFS, and
    write the same bytes; the distances are the native run's."""
    users, topk, truth = hit_case(prepared, seed=5)
    native_frame = hit_paths_frame(adj, users, topk, truth)
    monkeypatch.setitem(native._STATE, "lib", None)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.bfs_batch(adj.indptr, adj.indices, np.array([0]), np.array([0, 1]), np.array([1]))
    got = hit_paths_frame(adj, users, topk, truth)
    np.testing.assert_array_equal(got["path_length"], native_frame["path_length"])
    np.testing.assert_array_equal(got["item_id_idx"], native_frame["item_id_idx"])
    want = jax_paths.hit_paths_frame(
        jax_paths.build_adjacency(
            prepared.edge_user, prepared.edge_item_node, prepared.n_users, prepared.n_items
        ),
        users, topk, truth,
    )
    want.to_csv(tmp_path / "jax.csv", index=False)
    got.to_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_hit_paths_frame_flags_and_empty(tmp_path):
    adj = build_adjacency(np.array([0, 1, 1]), np.array([2, 2, 3]), 2, 2)
    df = hit_paths_frame(adj, np.array([0]), np.array([[0, 1]]), [{0, 1}])
    assert df["path_length"].tolist() == [1, 3]
    assert df["longer_than_3"].tolist() == [False, False]
    empty = hit_paths_frame(adj, np.array([0]), np.array([[0, 1]]), [set()])
    assert len(empty) == 0
    empty.to_csv(str(tmp_path / "e.csv"))
    want = jax_paths.hit_paths_frame(adj, np.array([0]), np.array([[0, 1]]), [set()])
    want.to_csv(tmp_path / "w.csv", index=False)
    assert (tmp_path / "e.csv").read_bytes() == (tmp_path / "w.csv").read_bytes()


def test_frame_csv_matches_pandas(tmp_path):
    cols = {
        "i": np.array([3, -1, 7], np.int64),
        "f": np.array([1 / 3, 1e-5, 0.0], np.float32),
        "b": np.array([True, False, True]),
        "l": [[1, 2], None, [np.int64(4)]],
        "s": ["a,b", 'q"x', "plain"],
    }
    Frame(cols).to_csv(str(tmp_path / "port.csv"))
    pd.DataFrame(cols).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    with pytest.raises(ValueError, match="unequal"):
        Frame({"a": [1, 2], "b": [1]})


def _captured_draws(monkeypatch, nx):
    """Record the graph nodes and node colours that draw_networkx gets."""
    draws = []
    orig = nx.draw_networkx

    def record(g, *args, **kwargs):
        draws.append((list(g.nodes), list(kwargs["node_color"]), sorted(map(sorted, g.edges))))
        return orig(g, *args, **kwargs)

    monkeypatch.setattr(nx, "draw_networkx", record)
    return draws


def test_plot_user_paths_matches_jax(prepared, adj, tmp_path, monkeypatch):
    nx = pytest.importorskip("networkx")
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    from gnn_ecommerce_tpu.explain import plot_user_paths as jax_plot

    users, topk, truth = hit_case(prepared, seed=8)
    got_df = hit_paths_frame(adj, users, topk, truth)
    want_df = jax_paths.hit_paths_frame(adj, users, topk, truth)
    counts = np.bincount(got_df["user_id_idx"])
    user = int(np.argmax(counts))  # the user with the most hit paths
    assert counts[user] >= 2
    draws = _captured_draws(monkeypatch, nx)
    out = tmp_path / "port.png"
    fig = plot_user_paths(got_df, user, prepared.n_users, out_path=str(out))
    fig_jax = jax_plot(want_df, user, prepared.n_users)
    assert out.exists() and out.stat().st_size > 0
    assert fig.axes[0].get_title() == fig_jax.axes[0].get_title()
    plt.close(fig)
    plt.close(fig_jax)
    assert len(draws) == 2 and draws[0] == draws[1]
    assert "tab:red" in draws[0][1]
    with pytest.raises(ValueError, match="no hit paths"):
        plot_user_paths(got_df, -5, prepared.n_users)


def test_plot_user_paths_names_missing_packages(monkeypatch):
    frame = Frame({"user_id_idx": [0], "item_id_idx": [0], "path": [[0, 2]]})
    for blocked in ("matplotlib", "networkx"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, blocked, None)
            with pytest.raises(ImportError, match="matplotlib and networkx"):
                plot_user_paths(frame, 0, 2)
