"""The port's offline inference on the CPU against the JAX package's:
``combined_eval_split`` array for array, ``mark_frame``'s CSV bytes, and
``cli.infer --device cpu`` against JAX's ``cli.infer`` on the committed
``data/prepared`` + ``model-checkpoints/LightGCN_best`` fixture.

Tolerances: none for the split, the CSVs and the path table (exact bytes).
The two CLIs rank with embeddings propagated in another summation order
(their scores differ by at most 1.5e-8 on the fixture); the CSVs are
byte-equal because no two neighbouring scores of the fixture's top-K are
that close (the tie rule: a pair closer than twice that difference could
swap), which ``test_fixture_topk_has_no_near_ties`` holds."""
import types

import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.cli import infer as jax_infer
from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
from gnn_ecommerce_tpu.eval.metrics import mark_frame as jax_mark_frame
from gnn_ecommerce_tpu_torch.cli import infer as infer_cli
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit
from gnn_ecommerce_tpu_torch.eval.metrics import mark_frame

torch.set_num_threads(1)

DATA, CKPT = "data/prepared", "model-checkpoints"


def assert_split_equal(got, want):
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    assert got.user_ids.dtype == want.user_ids.dtype
    for name in ("truth", "train_mask"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.values, b.values)
        assert a.values.dtype == b.values.dtype


def test_combined_eval_split_matches_jax_on_fixture():
    got = infer_cli.combined_eval_split(load_prepared(DATA))
    want = jax_infer.combined_eval_split(jax_load_prepared(DATA))
    assert_split_equal(got, want)


def random_split(rng, users, n_items, max_len):
    lens = rng.integers(0, max_len, len(users))
    lens[0] = max(lens[0], 1)
    values = np.concatenate([
        np.sort(rng.choice(n_items, n, replace=False)) for n in lens
    ]).astype(np.int64)
    return CsrList(np.append(0, np.cumsum(lens)).astype(np.int64), values)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combined_eval_split_dedups_overlapping_splits(seed):
    """val and test share users and (user, item) pairs; masks reach users
    outside the truth; both packages agree on the union."""
    rng = np.random.default_rng(seed)
    n_items = 12
    pool = np.arange(40)
    splits = []
    for _ in range(2):
        users = np.sort(rng.choice(pool, 25, replace=False)).astype(np.int64)
        truth = random_split(rng, users, n_items, 4)
        lens = np.diff(truth.indptr)
        users = users[lens > 0]
        truth = CsrList(np.append(0, np.cumsum(lens[lens > 0])), truth.values)
        splits.append(EvalSplit(users, truth, random_split(rng, users, n_items, 6)))
    fake = types.SimpleNamespace(val=splits[0], test=splits[1])
    got = infer_cli.combined_eval_split(fake)
    want = jax_infer.combined_eval_split(fake)
    assert_split_equal(got, want)
    both = set(splits[0].user_ids) & set(splits[1].user_ids)
    assert both and len(got.user_ids) == len(set(splits[0].user_ids) | set(splits[1].user_ids))


@pytest.mark.parametrize("k", [3, 10])
def test_mark_frame_csv_matches_jax(tmp_path, k):
    """Truth lists shorter, as long as and longer than K: the overlap's
    cells hold numpy or Python integers as JAX's set intersection leaves
    them, so the bytes agree."""
    rng = np.random.default_rng(k)
    n = 30
    users = np.sort(rng.choice(500, n, replace=False)).astype(np.int64)
    truth = [np.sort(rng.choice(40, rng.integers(1, 2 * k + 2), replace=False)).astype(np.int64)
             for _ in range(n)]
    topk = np.stack([rng.choice(40, k, replace=False) for _ in range(n)]).astype(np.int32)
    hits = np.array([len(set(t.tolist()) & set(g.tolist())) for t, g in zip(topk, truth)])
    recall = (hits / np.array([len(g) for g in truth])).astype(np.float32)
    precision = (hits / k).astype(np.float32)
    got = mark_frame(users, truth, topk, recall, precision)
    want = jax_mark_frame(users, truth, topk, recall, precision)
    assert got.columns == list(want.columns)
    got.to_csv(str(tmp_path / "port.csv"))
    want.to_csv(tmp_path / "jax.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """JAX's cli.infer on the fixture, once per argument list."""
    root = tmp_path_factory.mktemp("jax_infer")
    runs = {}

    def run(*extra):
        if extra not in runs:
            out = root / f"run{len(runs)}"
            jax_infer.main(["-d", DATA, "-c", CKPT, "--out", str(out), *extra])
            runs[extra] = out
        return runs[extra]

    return run


@pytest.mark.parametrize(
    "extra", [(), ("-k", "10"), ("--max-path-users", "5"), ("--no-paths",)],
    ids=["k20", "k10", "max5", "nopaths"],
)
def test_infer_cli_writes_jax_bytes(jax_out, tmp_path, capsys, extra):
    want = jax_out(*extra)
    capsys.readouterr()
    got = tmp_path / "port"
    res = infer_cli.main(["-d", DATA, "-c", CKPT, "--out", str(got), "--device", "cpu", *extra])
    printed = capsys.readouterr().out
    k = extra[1] if extra[:1] == ("-k",) else "20"
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir())
    assert f"metrics_K{k}.csv" in names and ("hit_df.csv" in names) == ("--no-paths" not in extra)
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert f"{res.n_users} eval users: P@{k} {res.precision:.6f}, R@{k} {res.recall:.6f}" in printed
    assert res.final_emb.shape[0] == load_prepared(DATA).n_users + load_prepared(DATA).n_items
    if "--no-paths" not in extra:
        assert f"{res.hit_paths} hit paths ({res.longer_than_3} longer than 3 hops)" in printed
        assert res.hit_paths > 0


def test_fixture_topk_has_no_near_ties():
    """The ranks that the CSVs record are not decided by summation order:
    in each eval user's masked top-21 on the fixture, neighbouring scores
    differ by more than twice the largest difference between the JAX and
    the port scores of any (user, item), so no pair can swap (the smallest
    gap is 6.8e-8, the difference 1.5e-8)."""
    import jax
    import jax.numpy as jnp
    from gnn_ecommerce_tpu.graph import build_graph as jax_build_graph
    from gnn_ecommerce_tpu.models.lightgcn import LightGCNConfig as JaxConfig
    from gnn_ecommerce_tpu.models.lightgcn import get_embedding as jax_get_embedding
    from gnn_ecommerce_tpu_torch.eval.evaluate import build_eval_batch
    from gnn_ecommerce_tpu_torch.graph.build import build_graph
    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, get_embedding
    from gnn_ecommerce_tpu_torch.ops.topk_score import topk_scores
    from gnn_ecommerce_tpu_torch.train.checkpoint import find_leaf, load_checkpoint

    prepared = load_prepared(DATA)
    leaves, meta = load_checkpoint(CKPT)
    emb = np.asarray(find_leaf(leaves, meta, "embedding"))
    layers = meta["hyperparams"]["n_layers"]
    args = (prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
            prepared.n_users, prepared.n_items)
    final = get_embedding(
        {"embedding": torch.from_numpy(emb)},
        build_graph(*args, items_offset=True, device="cpu"),
        LightGCNConfig(emb.shape[0], emb.shape[1], layers),
    )
    jax_final = jax.jit(lambda p, g: jax_get_embedding(p, g, JaxConfig(emb.shape[0], emb.shape[1], layers)))(
        {"embedding": jnp.asarray(emb)}, jax_build_graph(*args, items_offset=True)
    )
    batch = build_eval_batch(infer_cli.combined_eval_split(prepared), "cpu")
    users = final[batch.user_ids]
    scores = users @ final[prepared.n_users:].T
    jax_users = np.asarray(jax_final)[batch.user_ids.numpy()]
    jax_scores = jax_users @ np.asarray(jax_final)[prepared.n_users:].T
    drift = np.abs(scores.numpy() - jax_scores).max()
    vals, _ = topk_scores(users, final[prepared.n_users:], batch.mask, 21)
    gaps = (vals[:, :-1] - vals[:, 1:]).min().item()
    assert gaps > 2 * drift, (gaps, drift)


def test_infer_cli_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_cli.main(["-d", DATA, "-c", CKPT, "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
