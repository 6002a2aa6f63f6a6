"""The port's serving slice on the CPU: the service's cached embedding and
top-20 against the JAX service on the committed LightGCN_best fixture, the
REST round trip, the batcher, the version registry (the cases of
tests/test_serve_and_explain.py that apply), the generation-stamp fix and
the device rules."""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.data import events_to_edges, prepare_splits, split_edges, synthetic_events
from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
from gnn_ecommerce_tpu.data.artifacts import save_prepared as jax_save_prepared
from gnn_ecommerce_tpu.data.events import EVENT_TYPE_WEIGHTS_V1
from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import init_params as jax_init_params
from gnn_ecommerce_tpu.train.checkpoint import save_checkpoint
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared, save_prepared
from gnn_ecommerce_tpu_torch.serve import BatchingRecommender, RecommenderService, make_server
from gnn_ecommerce_tpu_torch.serve import service as service_mod

torch.set_num_threads(1)

DATA, CKPT = "data/prepared", "model-checkpoints"
HP = {"latent_dim": 8, "n_layers": 2}


@pytest.fixture(scope="module")
def fixture_services():
    """(port service, JAX service) on the committed LightGCN_best fixture."""
    from gnn_ecommerce_tpu.serve import RecommenderService as JaxService

    return (
        RecommenderService.from_artifacts(DATA, CKPT, device="cpu"),
        JaxService.from_artifacts(DATA, CKPT),
    )


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A small prepared dir (written by the JAX package) and checkpoints vA,
    vB, v of dim 8 / 2 layers."""
    root = tmp_path_factory.mktemp("torch_serve")
    events = synthetic_events(n_users=300, n_items=60, n_events=6000, seed=3)
    prepared = prepare_splits(*split_edges(events_to_edges(events, EVENT_TYPE_WEIGHTS_V1), seed=0))
    jax_save_prepared(prepared, str(root / "data"))
    cfg = JaxConfig(prepared.n_users + prepared.n_items, 8, 2)
    opt = optax.adam(1e-3)
    for i, name in enumerate(["vA", "vB", "v"]):
        p = jax_init_params(jax.random.key(i), cfg)
        save_checkpoint(
            str(root / "ckpt"), p, opt.init(p), epoch=i, precision=0.1,
            recall=0.2 + i, hyperparams=HP, name=name,
        )
    return str(root / "data"), str(root / "ckpt"), prepared


def _svc(artifacts, name="vA", k=10):
    data, ckpt, _ = artifacts
    return RecommenderService.from_artifacts(data, ckpt, name, k=k, device="cpu")


def test_cached_embedding_matches_jax_service(fixture_services):
    tsvc, jsvc = fixture_services
    assert tsvc.cfg.embedding_dim == 64 and tsvc.cfg.num_layers == 3
    ref = np.asarray(jsvc.final_emb)
    out = tsvc.final_emb.numpy()
    assert out.shape == ref.shape == (1979 + 300, 64)
    np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-5)


def test_top20_matches_jax_service(fixture_services):
    """Same top-20 sets per user, except where scores tie within 1e-6."""
    tsvc, jsvc = fixture_services
    users = np.arange(0, 1979, 31)
    got, want = tsvc.recommend(users), jsvc.recommend(users)
    assert got.shape == want.shape == (len(users), 20)
    emb = np.asarray(jsvc.final_emb, dtype=np.float64)
    n_users = tsvc.prepared.n_users
    for u, g, w in zip(users, got, want):
        scores = emb[n_users:] @ emb[u]
        if set(g) == set(w):
            continue
        # Differences may only be items tied with the 20th score.
        kth = np.sort(scores[w])[0]
        for item in set(g) ^ set(w):
            assert abs(scores[item] - kth) <= 1e-6, (u, item)


def test_rest_server_roundtrip(artifacts):
    svc = _svc(artifacts)
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/ping") as r:
            assert json.load(r)["status"] == "Healthy"
        with urllib.request.urlopen(f"{base}/v1/models/lightgcn_recommender") as r:
            stats = json.load(r)
            assert stats["n_users"] == svc.prepared.n_users and stats["device"] == "cpu"
        req = urllib.request.Request(
            f"{base}/v1/models/lightgcn_recommender:predict",
            data=json.dumps([0, 1]).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            items = json.load(r)["items"]
            assert items == svc.recommend([0, 1]).tolist()
        with urllib.request.urlopen(f"{base}/metrics") as r:
            counts = {
                line.split()[0]: float(line.split()[1])
                for line in r.read().decode().splitlines()
                if line and not line.startswith("#")
            }
            assert counts["lightgcn_requests_total"] >= 1
            assert counts["lightgcn_users_total"] >= 2
        bad = urllib.request.Request(f"{base}/v1/models/lightgcn_recommender:predict", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
        refresh = urllib.request.Request(
            f"{base}/v1/models/lightgcn_recommender:refresh", data=b""
        )
        with urllib.request.urlopen(refresh) as r:
            assert json.load(r)["status"] == "refreshed"
    finally:
        server.shutdown()


def test_service_masks_purchases_and_rejects_bad_users(artifacts):
    svc = _svc(artifacts)
    prepared = svc.prepared
    users = np.asarray(prepared.sampler.users[:5])
    recs = svc.recommend(users)
    assert recs.shape == (5, 10)
    for row, u in zip(recs, users):
        slot = np.searchsorted(prepared.sampler.users, u)
        lo, hi = prepared.sampler.pos_indptr[slot], prepared.sampler.pos_indptr[slot + 1]
        assert not set(row.tolist()) & set((prepared.sampler.pos_flat[lo:hi] - prepared.n_users).tolist())
    with pytest.raises(ValueError, match="out of range"):
        svc.recommend([prepared.n_users + 5])


def test_batching_recommender_coalesces(artifacts):
    svc = _svc(artifacts)
    batcher = BatchingRecommender(svc, max_wait_s=0.05)
    users = np.asarray(svc.prepared.sampler.users)
    reqs = [users[i : i + 3] for i in range(0, 24, 3)]
    expected = [svc.recommend(r) for r in reqs]
    results = [None] * len(reqs)

    def call(i):
        results[i] = batcher.recommend(reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for got, want in zip(results, expected):
        np.testing.assert_array_equal(got, want)
    m = batcher.metrics()
    assert m["batched_requests_total"] == len(reqs)
    assert m["batches_total"] < len(reqs)
    with pytest.raises(ValueError, match="out of range"):
        batcher.recommend([svc.prepared.n_users + 7])


def test_registry_register_set_default_unregister(artifacts):
    data, ckpt, _ = artifacts
    svc = _svc(artifacts)
    users = np.asarray(svc.prepared.sampler.users[:4])
    rec_a = svc.recommend(users)
    assert [v["version"] for v in svc.list_versions()] == ["1"]
    assert svc.register_version(ckpt, "vB") == "2"
    assert svc.stats()["active_version"] == "2"
    assert not np.array_equal(svc.recommend(users), rec_a)
    svc.set_default_version("1")
    np.testing.assert_array_equal(svc.recommend(users), rec_a)
    with pytest.raises(ValueError, match="is active"):
        svc.unregister_version("1")
    svc.unregister_version("2")
    assert [v["version"] for v in svc.list_versions()] == ["1"]
    with pytest.raises(KeyError):
        svc.set_default_version("2")


def test_register_version_cap_and_cheap_rejects(artifacts, monkeypatch):
    _, ckpt, _ = artifacts
    svc = _svc(artifacts, "v", k=5)
    monkeypatch.setattr(RecommenderService, "MAX_VERSIONS", 3)
    loads = []
    real_load = service_mod.load_checkpoint
    monkeypatch.setattr(
        service_mod, "load_checkpoint",
        lambda *a, **k: (loads.append(a), real_load(*a, **k))[1],
    )
    with pytest.raises(ValueError, match="already registered"):
        svc.register_version(ckpt, "v", version="1")
    assert loads == []
    svc.register_version(ckpt, "v")  # "2"
    svc.register_version(ckpt, "v")  # "3", at the cap
    n_loads = len(loads)
    with pytest.raises(ValueError, match="registry full"):
        svc.register_version(ckpt, "v")
    assert len(loads) == n_loads
    svc.unregister_version("2")
    assert svc.register_version(ckpt, "v") == "4"


def test_register_autoversion_skips_taken_ids(artifacts, monkeypatch):
    _, ckpt, _ = artifacts
    svc = _svc(artifacts, "v", k=5)
    monkeypatch.setattr(RecommenderService, "MAX_VERSIONS", 8)
    svc.register_version(ckpt, "v", version="2")
    marker = svc._versions["2"]
    assert svc.register_version(ckpt, "v") == "3"
    assert svc._versions["2"] is marker
    assert set(svc._versions) == {"1", "2", "3"}


def test_refresh_pinned_version_and_unregister_race(artifacts):
    _, ckpt, _ = artifacts
    svc = _svc(artifacts, "vA", k=5)
    svc.register_version(ckpt, "vB")  # "2", now default
    emb2_before = svc._versions["2"]["emb"]
    params = {"embedding": svc._checkpoint_params(*service_mod.load_checkpoint(ckpt, "v"), svc.cfg, "cpu")["embedding"]}
    svc.refresh(params, version="1")
    assert svc._versions["2"]["emb"] is emb2_before
    assert svc._active == "2"

    orig_build = svc._build_cache

    def build_and_unregister(p, c):
        out = orig_build(p, c)
        svc.unregister_version("1")
        return out

    svc._build_cache = build_and_unregister
    svc.refresh(params, version="1")
    assert "1" not in svc._versions
    assert svc._active == "2"


def test_refresh_drops_result_when_version_was_reregistered(artifacts):
    """The deliberate difference from the JAX service: a version that is
    unregistered AND re-registered under the same id while a refresh
    propagates keeps its new registration (the JAX refresh overwrites it
    with the stale result)."""
    _, ckpt, _ = artifacts
    svc = _svc(artifacts, "vA", k=5)
    svc.register_version(ckpt, "vB", version="x", set_default=False)
    stale = svc._checkpoint_params(*service_mod.load_checkpoint(ckpt, "vA"), svc.cfg, "cpu")
    orig_build = svc._build_cache
    fresh = {}

    def build_then_reregister(p, c):
        out = orig_build(p, c)
        svc._build_cache = orig_build
        svc.unregister_version("x")
        svc.register_version(ckpt, "v", version="x", set_default=False)
        fresh["entry"] = svc._versions["x"]
        return out

    svc._build_cache = build_then_reregister
    svc.refresh(stale, version="x")
    assert svc._versions["x"] is fresh["entry"]
    assert svc._versions["x"]["source"] == (ckpt, "v")


def test_artifacts_interchange_with_jax(artifacts, tmp_path):
    data, _, prepared = artifacts
    ours = load_prepared(data)
    np.testing.assert_array_equal(ours.edge_user, prepared.edge_user)
    np.testing.assert_array_equal(ours.sampler.pos_flat, prepared.sampler.pos_flat)
    np.testing.assert_array_equal(ours.val.truth.values, prepared.val.truth.values)
    save_prepared(ours, str(tmp_path / "again"))
    back = jax_load_prepared(str(tmp_path / "again"))
    np.testing.assert_array_equal(back.test.train_mask.indptr, prepared.test.train_mask.indptr)
    arrays = tmp_path / "again" / "prepared.npz"
    raw = arrays.read_bytes()
    arrays.write_bytes(raw[:-1] + bytes([raw[-1] ^ 1]))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_prepared(str(tmp_path / "again"))


def test_entry_points_need_cuda_unless_cpu_is_asked(artifacts, monkeypatch):
    from gnn_ecommerce_tpu_torch.cli import serve as cli_serve

    data, ckpt, _ = artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecommenderService.from_artifacts(data, ckpt, "vA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["-d", data, "-c", ckpt, "--checkpoint-name", "vA"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["-d", data, "-c", ckpt, "--checkpoint-name", "vA", "--quantized"])
    quantized = RecommenderService.from_artifacts(data, ckpt, "vA", quantized=True, device="cpu")
    assert quantized.stats()["quantized"] is True
    served = []
    monkeypatch.setattr(cli_serve, "serve_forever", lambda svc, host, port: served.append(svc))
    cli_serve.main(["-d", data, "-c", ckpt, "--checkpoint-name", "vA", "--device", "cpu", "-k", "7"])
    cli_serve.main([
        "-d", data, "-c", ckpt, "--checkpoint-name", "vA", "--device", "cpu", "-k", "7",
        "--quantized",
    ])
    assert isinstance(served[0], BatchingRecommender)
    assert served[0].recommend([0]).shape == (1, 7)
    assert served[1].stats()["quantized"] is True
    assert served[1].recommend([0, 1]).shape == (2, 7)
