"""The port's int8-quantized serving on the CPU against the JAX package's:
``quantize_rows`` exactly, ``topk_scores_int8``'s scores bit for bit and
its ids, the card's padded ``torch._int_mm`` product (run here on the CPU)
against the plain f32 product, the quantized service's masking and the
int8 top-10's overlap with the f32 top-10.

Tolerances: none for the quantization, the scores and the product (exact);
ids equal wherever two scores do not tie; overlap ≥ 0.9, the bound of
``tests/test_eval.py::test_int8_quantized_topk_overlap``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gnn_ecommerce_tpu.serve.quantized import QuantizedCache as JaxQuantizedCache
from gnn_ecommerce_tpu.serve.quantized import quantize_rows as jax_quantize_rows
from gnn_ecommerce_tpu.serve.quantized import topk_scores_int8 as jax_topk_scores_int8
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, init_params
from gnn_ecommerce_tpu_torch.ops.topk_score import topk_scores
from gnn_ecommerce_tpu_torch.serve import RecommenderService
from gnn_ecommerce_tpu_torch.serve.quantized import (
    QuantizedCache,
    int8_product,
    int8_product_int_mm,
    int8_product_plain,
    pad_items,
    quantize_rows,
    topk_scores_int8,
)
from gnn_ecommerce_tpu_torch.serve import quantized

torch.set_num_threads(1)

DATA, CKPT = "data/prepared", "model-checkpoints"


def table(seed: int, n: int, d: int) -> np.ndarray:
    """Normal rows with a zero row, a constant row and exact half-step
    values (x/s lands on k + 0.5, where rounding to even matters)."""
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    x[1] = 0.0
    x[2] = 0.25
    x[3, :] = np.arange(d, dtype=np.float32) - d // 2  # ±0.5 steps of the scale
    x[3, 0] = 127.0
    x[3, 1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    return x


@pytest.mark.parametrize("d", [16, 90])
def test_quantize_rows_matches_jax_exactly(d):
    x = table(d, 300, d)
    q, s = quantize_rows(torch.from_numpy(x))
    jq, js = jax_quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[3, 1:6].tolist() == [0, 2, 2, 0, -2]  # half to even, as jnp.round
    assert (q[1] == 0).all() and s[1] == 1.0


def quantized_case(seed: int, n_users: int, n_items: int, d: int, b: int):
    x = table(seed, n_users + n_items, d)
    rng = np.random.default_rng(seed + 100)
    ids = rng.choice(n_users, b, replace=False)
    mask = np.full((b, 3), -1, np.int32)
    mask[:, 0] = rng.integers(0, n_items, b)
    mask[::2, 1] = rng.integers(0, n_items, len(mask[::2]))
    return x, ids, mask


def assert_same_topk(vals, idx, want_vals, want_idx):
    """Scores bit for bit; ids equal except among equal scores."""
    np.testing.assert_array_equal(vals, want_vals)
    for r in range(len(vals)):
        for v in np.unique(vals[r]):
            sel = vals[r] == v
            assert set(idx[r][sel]) == set(want_idx[r][sel]) or sel[-1], (r, v)


@pytest.mark.parametrize("b, d, k", [(8, 16, 10), (5, 90, 20), (64, 90, 20)])
def test_topk_scores_int8_matches_jax(b, d, k):
    n_users, n_items = 80, 301
    x, ids, mask = quantized_case(b + d, n_users, n_items, d, b)
    uq, us = quantize_rows(torch.from_numpy(x[:n_users]))
    iq, is_ = quantize_rows(torch.from_numpy(x[n_users:]))
    vals, idx = topk_scores_int8(uq[ids], us[ids], iq, is_, torch.from_numpy(mask), k)
    juq, jus = jax_quantize_rows(jnp.asarray(x[:n_users]))
    jiq, jis = jax_quantize_rows(jnp.asarray(x[n_users:]))
    jvals, jidx = jax_topk_scores_int8(juq[ids], jus[ids], jiq, jis, jnp.asarray(mask), k)
    assert idx.dtype == torch.int32
    assert_same_topk(vals.numpy(), idx.numpy(), np.asarray(jvals), np.asarray(jidx))
    for row, m in zip(idx.numpy(), mask):
        assert not set(row.tolist()) & set(m[m >= 0].tolist())


@pytest.mark.parametrize(
    "b, d, n_items",
    [(1, 90, 54), (8, 90, 301), (16, 90, 300), (17, 96, 296), (64, 5, 301), (512, 90, 1001),
     (5094, 90, 77), (2048, 90, 5457)],
)
def test_int_mm_padding_equals_plain_product(b, d, n_items):
    """The card's product: batch padded to a multiple of 8 of at least 24
    rows, D to a multiple of 8 and I to one of 16, the padding sliced off;
    exact against the f32 product, also with the items padded beforehand
    (as the cache pads them), through both products."""
    rng = np.random.default_rng(b * 7 + d)
    uq = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
    iq = torch.from_numpy(rng.integers(-127, 128, (n_items, d)).astype(np.int8))
    uq[0, :] = 127  # the largest sum: D·127²
    iq[0, :] = 127
    got = int8_product_int_mm(uq, iq)
    want = int8_product_plain(uq, iq)
    assert got.shape == (b, n_items) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert got[0, 0].item() == d * 127 * 127
    assert torch.equal(int8_product(uq, iq), want)  # the CPU takes the plain version
    padded = pad_items(iq)
    assert padded.shape[0] % 16 == 0 and padded.shape[1] % 8 == 0
    assert torch.equal(int8_product_int_mm(uq, padded, n_items), want)
    assert torch.equal(int8_product_plain(uq, padded, n_items), want)
    ref = uq.long() @ iq.long().T
    assert torch.equal(want.long(), ref)


def test_topk_scores_int8_on_the_card_path_equals_plain(monkeypatch):
    """The top-K through the card's product (forced here on the CPU), on
    the cache's padded items, equals the plain top-K on the unpadded ones."""
    n_users, n_items, d, b = 60, 301, 90, 9
    x, ids, mask = quantized_case(3, n_users, n_items, d, b)
    uq, us = quantize_rows(torch.from_numpy(x[:n_users]))
    iq, is_ = quantize_rows(torch.from_numpy(x[n_users:]))
    pvals, pidx = topk_scores_int8(uq[ids], us[ids], iq, is_, torch.from_numpy(mask), 20)
    monkeypatch.setattr(quantized, "int8_product", int8_product_int_mm)
    vals, idx = topk_scores_int8(uq[ids], us[ids], pad_items(iq), is_, torch.from_numpy(mask), 20)
    assert torch.equal(vals, pvals) and torch.equal(idx, pidx)


def test_int8_quantized_topk_overlap():
    """As tests/test_eval.py::test_int8_quantized_topk_overlap: the int8
    top-10 keeps ≥ 90% of the f32 top-10, and masked items never appear;
    the port's cache answers JAX's cache's ids."""
    rng = np.random.default_rng(0)
    n_users, n_items, dim = 40, 300, 16
    emb = torch.from_numpy(rng.standard_normal((n_users + n_items, dim)).astype(np.float32))
    mask = np.full((8, 2), -1, np.int32)
    mask[:, 0] = rng.integers(0, n_items, 8)
    mask.sort(axis=1)
    uids = np.arange(8)
    _, exact = topk_scores(emb[uids], emb[n_users:], torch.from_numpy(mask), k=10)
    cache = QuantizedCache(emb, n_users)
    got = cache.recommend(uids, mask, k=10)
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(exact.numpy(), got)
    ])
    assert overlap >= 0.9
    for row, m in zip(got, mask):
        assert not (set(row.tolist()) & set(m[m >= 0].tolist()))
    jax_got = JaxQuantizedCache(jnp.asarray(emb.numpy()), n_users).recommend(uids, mask, k=10)
    np.testing.assert_array_equal(got, jax_got)


@pytest.fixture(scope="module")
def quantized_service():
    prepared = load_prepared(DATA)
    cfg = LightGCNConfig(prepared.n_users + prepared.n_items, 16, 2)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return prepared, params, RecommenderService(prepared, params, cfg, k=10, quantized=True, device="cpu")


def test_quantized_service_recommend_masks_purchases(quantized_service):
    """As tests/test_serve_and_explain.py::test_quantized_service_recommend."""
    prepared, _, svc = quantized_service
    assert svc.stats()["quantized"] is True
    users = np.asarray(prepared.sampler.users[:4])
    recs = svc.recommend(users)
    assert recs.shape == (4, 10)
    s = prepared.sampler
    for row, u in zip(recs, users):
        slot = np.searchsorted(s.users, u)
        purchased = set((s.pos_flat[s.pos_indptr[slot] : s.pos_indptr[slot + 1]] - prepared.n_users).tolist())
        assert not (set(row.tolist()) & purchased)


def test_quantized_service_answers_from_its_int8_cache(quantized_service):
    """Every version carries a cache quantized from its own f32 rows, and a
    request is ranked on it (with neginf masking) for every batch size."""
    prepared, params, svc = quantized_service
    entry = svc._versions[svc._active]
    qcache = entry["qcache"]
    q, s = quantize_rows(entry["emb"][: prepared.n_users])
    assert torch.equal(qcache.user_q, q) and torch.equal(qcache.user_s, s)
    for b in (1, 8, 64, 100):
        ids = np.arange(b) % prepared.n_users
        mask = svc._request_mask(ids)
        np.testing.assert_array_equal(svc.recommend(ids), qcache.recommend(ids, mask, k=10))
    svc.refresh(params)
    assert svc._versions[svc._active]["qcache"] is not qcache


def test_quantized_service_registers_versions(quantized_service):
    prepared, _, svc = quantized_service
    version = svc.register_version(CKPT, set_default=False)
    try:
        entry = svc._versions[version]
        assert entry["qcache"] is not None
        assert entry["qcache"].item_q.shape == (prepared.n_items, entry["emb"].shape[1])
        assert torch.equal(entry["qcache"].item_mm, pad_items(entry["qcache"].item_q))
    finally:
        svc.unregister_version(version)
