"""The port's top-K, evaluation and prepared-data signatures are the JAX
package's: ``topk_scores`` and ``recommend_users`` called positionally in
JAX's form (``..., k, item_tile, mask_mode``), ``evaluate`` and
``evaluate_bucketed`` with keyword ``item_tile`` and ``topk_impl``, give
JAX's ids on the same numpy inputs for every ``topk_impl``; an unknown one
raises; ``load_prepared(d, verify=False)`` skips the hash and loads what
JAX's does."""
import importlib
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
from gnn_ecommerce_tpu.ops.topk_score import topk_scores as jax_topk_scores
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.eval import evaluate as teval
from gnn_ecommerce_tpu_torch.ops.topk_score import topk_scores

torch.set_num_threads(1)
jeval = importlib.import_module("gnn_ecommerce_tpu.eval.evaluate")

DATA = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "prepared")
IMPLS = ["exact", "tiled", "approx"]


def _scored(seed: int, b: int, n_items: int, d: int = 16, m: int = 12):
    rng = np.random.default_rng(seed)
    users = rng.standard_normal((b, d)).astype(np.float32)
    items = rng.standard_normal((n_items, d)).astype(np.float32)
    mask = rng.integers(0, n_items, (b, m))
    mask[:, -3:] = -1  # padding
    mask[0, 0], mask[1, 0] = 0, n_items - 1
    return users, items, mask


def _assert_same_topk(ours, ref):
    vals, idx = ours
    jvals, jidx = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    scale = np.abs(jvals).max()
    np.testing.assert_allclose(vals.numpy(), jvals, rtol=0, atol=1e-6 * scale)


# 6,000 items take the JAX package's tile-max-pruned path (n > 2·k·128);
# item_tile 1024 gives its tiled top-k six tiles.
@pytest.mark.parametrize("topk_impl", IMPLS)
@pytest.mark.parametrize("mask_mode", ["neginf", "multiply"])
def test_topk_scores_positional_matches_jax(topk_impl, mask_mode):
    users, items, mask = _scored(3, 6, 6000)
    k, item_tile = 20, 1024
    ref = jax_topk_scores(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(mask, jnp.int32),
        k, item_tile, mask_mode, topk_impl,
    )
    ours = topk_scores(
        torch.from_numpy(users), torch.from_numpy(items), torch.from_numpy(mask),
        k, item_tile, mask_mode, topk_impl,
    )
    assert ours[1].dtype == torch.int32
    _assert_same_topk(ours, ref)
    # Five positions, as evaluate.py in the JAX package calls it.
    short = topk_scores(
        torch.from_numpy(users), torch.from_numpy(items), torch.from_numpy(mask),
        k, item_tile, mask_mode,
    )
    _assert_same_topk(short, ref)


def test_unknown_topk_impl_raises():
    users, items, mask = _scored(4, 2, 50)
    args = (torch.from_numpy(users), torch.from_numpy(items), torch.from_numpy(mask), 5)
    with pytest.raises(ValueError, match="unknown topk_impl"):
        topk_scores(*args, 8192, "neginf", "sorted")
    # The old position of mask_mode now holds item_tile: a mode given there
    # is no longer read as one.
    with pytest.raises(ValueError, match="unknown mask_mode"):
        topk_scores(*args, 8192, 8192)


@pytest.mark.parametrize("mask_mode", ["neginf", "multiply"])
def test_recommend_users_positional_matches_jax(mask_mode):
    rng = np.random.default_rng(5)
    n_users, n_items, d = 40, 700, 8
    emb = rng.standard_normal((n_users + n_items, d)).astype(np.float32)
    ids = rng.integers(0, n_users, 9)
    mask = rng.integers(-1, n_items, (9, 6))
    ref = jeval.recommend_users(
        jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(mask, jnp.int32), n_users, 20, 128, mask_mode
    )
    ours = teval.recommend_users(torch.from_numpy(emb), ids, mask, n_users, 20, 128, mask_mode)
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.fixture(scope="module")
def fixture_data():
    return load_prepared(DATA), jax_load_prepared(DATA)


@pytest.mark.parametrize("topk_impl", IMPLS)
def test_evaluate_keywords_match_jax(fixture_data, topk_impl):
    prepared, jprep = fixture_data
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((prepared.n_users + prepared.n_items, 16)).astype(np.float32)
    kw = dict(item_tile=64, topk_impl=topk_impl)
    jb = jeval.build_eval_buckets(jprep.val, width_floor=4)
    tb = teval.build_eval_buckets(prepared.val, width_floor=4, device="cpu")
    ref = jeval.evaluate_bucketed(jnp.asarray(emb), jb, jprep.n_users, 20, 16, **kw)
    out = teval.evaluate_bucketed(torch.from_numpy(emb), tb, prepared.n_users, 20, 16, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    single = teval.evaluate(
        torch.from_numpy(emb), teval.build_eval_batch(prepared.test, "cpu"), prepared.n_users,
        20, 16, **kw,
    )
    jsingle = jeval.evaluate(
        jnp.asarray(emb), jeval.build_eval_batch(jprep.test), jprep.n_users, 20, 16, **kw
    )
    np.testing.assert_array_equal(single[4], jsingle[4])  # top-K ids
    np.testing.assert_array_equal(single[2], jsingle[2])  # per-user recall
    np.testing.assert_allclose(single[:2], jsingle[:2], rtol=1e-6)


def test_evaluate_unknown_topk_impl_raises(fixture_data):
    prepared, _ = fixture_data
    emb = torch.zeros(prepared.n_users + prepared.n_items, 4)
    batch = teval.build_eval_batch(prepared.val, "cpu")
    with pytest.raises(ValueError, match="unknown topk_impl"):
        teval.evaluate(emb, batch, prepared.n_users, topk_impl="sorted")


def test_load_prepared_verify_flag_matches_jax(tmp_path):
    """A tampered npz (one array changed, the manifest's hash kept) is
    refused with verify=True and read as it is with verify=False."""
    d = tmp_path / "prepared"
    shutil.copytree(DATA, d)
    arrays = d / "prepared.npz"
    with np.load(arrays) as f:
        contents = {name: f[name] for name in f.files}
    contents["edge_weight"] = contents["edge_weight"] * 2
    np.savez_compressed(arrays, **contents)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_prepared(str(d))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_prepared(str(d), verify=True)
    ours = load_prepared(str(d), verify=False)
    ref = jax_load_prepared(str(d), verify=False)
    np.testing.assert_array_equal(ours.edge_weight, contents["edge_weight"])
    for name in ("edge_user", "edge_item_node", "edge_weight", "user_classes", "item_classes"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    np.testing.assert_array_equal(ours.sampler.pos_flat, ref.sampler.pos_flat)
    np.testing.assert_array_equal(ours.test.train_mask.values, ref.test.train_mask.values)
    assert (ours.n_users, ours.n_items) == (ref.n_users, ref.n_items)
