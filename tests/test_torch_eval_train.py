"""The port's evaluation, checkpoints and training driver on the CPU:
``evaluate_bucketed`` against the JAX package on the committed fixtures,
checkpoint interchange both ways, ``train()`` on every branch, resume, the
BEST/LAST policy, the async writer, and the deliberate difference in the
epoch log."""
import importlib
import json
import os
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
from gnn_ecommerce_tpu.graph import build_graph as jax_build_graph
from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import get_embedding as jax_get_embedding
from gnn_ecommerce_tpu.train import checkpoint as jckpt
from gnn_ecommerce_tpu_torch.convert import adam_state_to_numpy, adam_state_to_torch
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.eval import evaluate as teval
from gnn_ecommerce_tpu_torch.train import checkpoint as tckpt
from gnn_ecommerce_tpu_torch.train import driver
from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train
from gnn_ecommerce_tpu_torch.train.step import AdamState

torch.set_num_threads(1)
# The JAX package's eval/__init__ exports the function ``evaluate`` under
# the module's name.
jeval = importlib.import_module("gnn_ecommerce_tpu.eval.evaluate")

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA, CKPT = str(ROOT / "data" / "prepared"), str(ROOT / "model-checkpoints")
JAX_LEAF_PATHS = [
    "[0]['embedding']", "[1][0].count", "[1][0].mu['embedding']", "[1][0].nu['embedding']",
]


@pytest.fixture(scope="module")
def prepared():
    return load_prepared(DATA)


def _small(tmp, **kw):
    base = dict(
        latent_dim=8, n_layers=2, epochs=2, batch_size=256, batches_per_epoch=4,
        checkpoint_dir=str(tmp),
    )
    return TrainConfig(**{**base, **kw})


# ---------------------------------------------------------------- evaluation


@pytest.fixture(scope="module")
def final_emb():
    """LightGCN_best's propagated embedding, by the JAX package."""
    prep = jax_load_prepared(DATA)
    leaves, meta = jckpt.load_checkpoint(CKPT)
    emb = jckpt.find_leaf(leaves, meta, "embedding")
    graph = jax_build_graph(
        prep.edge_user, prep.edge_item_node, prep.edge_weight, prep.n_users, prep.n_items,
        items_offset=True,
    )
    hp = meta["hyperparams"]
    cfg = JaxConfig(graph.num_nodes, hp["latent_dim"], hp["n_layers"])
    return prep, np.array(jax_get_embedding({"embedding": jnp.asarray(emb)}, graph, cfg))


def test_recall_precision_divide_as_jax_and_host():
    """Per-user recall and precision equal JAX's and the host's f32 true
    divisions bit for bit (K divides as a tensor, not a Python scalar)."""
    from gnn_ecommerce_tpu.eval.metrics import recall_precision_at_k as jax_rp
    from gnn_ecommerce_tpu_torch.eval.metrics import recall_precision_at_k

    rng = np.random.default_rng(11)
    k = 7
    idx = rng.integers(0, 30, (64, k))
    truth = np.stack([rng.choice(30, 5, replace=False) for _ in range(64)])
    truth[np.arange(5)[None, :] >= rng.integers(0, 6, 64)[:, None]] = -1
    rec, prec = recall_precision_at_k(torch.from_numpy(idx), torch.from_numpy(truth), k)
    jrec, jprec = jax_rp(jnp.asarray(idx), jnp.asarray(truth), k)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    np.testing.assert_array_equal(prec.numpy(), np.asarray(jprec))
    hits = (idx[:, :, None] == truth[:, None, :]).any(2).sum(1).astype(np.float32)
    np.testing.assert_array_equal(prec.numpy(), hits / np.float32(k))
    np.testing.assert_array_equal(
        rec.numpy(), hits / np.maximum((truth >= 0).sum(1), 1).astype(np.float32)
    )


@pytest.mark.parametrize("split", ["val", "test"])
def test_evaluate_bucketed_matches_jax(final_emb, prepared, split):
    jprep, emb = final_emb
    jb = jeval.build_eval_buckets(getattr(jprep, split), width_floor=4)
    tb = teval.build_eval_buckets(getattr(prepared, split), width_floor=4, device="cpu")
    assert len(tb) == len(jb) > 1
    ref = jeval.evaluate_bucketed(jnp.asarray(emb), jb, jprep.n_users, 20)
    out = teval.evaluate_bucketed(torch.from_numpy(emb), tb, prepared.n_users, 20)
    # Means of the same per-user hits, in f32: a few ulps.
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    # User-weighted: the buckets give the single-batch means.
    single = teval.evaluate(
        torch.from_numpy(emb), teval.build_eval_batch(getattr(prepared, split), "cpu"),
        prepared.n_users, 20,
    )
    np.testing.assert_allclose(out, single[:2], rtol=1e-6)
    jsingle = jeval.evaluate(jnp.asarray(emb), jeval.build_eval_batch(getattr(jprep, split)), jprep.n_users, 20)
    np.testing.assert_array_equal(single[2], jsingle[2])  # per-user recall
    np.testing.assert_array_equal(single[4], jsingle[4])  # top-K ids


# ---------------------------------------------------------------- checkpoints


def _state(n=37, d=5, step=7):
    rng = np.random.default_rng(step)
    emb, mu, nu = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(3))
    return emb, mu, np.abs(nu), step


def test_port_checkpoint_restores_in_jax(tmp_path):
    emb, mu, nu, step = _state()
    state = AdamState(step, {"embedding": torch.from_numpy(mu)}, {"embedding": torch.from_numpy(nu)})
    tckpt.save_checkpoint(
        str(tmp_path), {"embedding": torch.from_numpy(emb)}, state,
        epoch=3, precision=0.1, recall=0.2, name=tckpt.LAST_NAME,
    )
    leaves, meta = jckpt.load_checkpoint(str(tmp_path), jckpt.LAST_NAME)
    assert meta["leaf_paths"] == JAX_LEAF_PATHS and meta["epoch"] == 3
    template = {"embedding": jnp.zeros_like(emb)}
    params, opt_state = jckpt.restore_into(template, optax.adam(0.1).init(template), leaves)
    np.testing.assert_array_equal(np.asarray(params["embedding"]), emb)
    assert int(opt_state[0].count) == step
    np.testing.assert_array_equal(np.asarray(opt_state[0].mu["embedding"]), mu)
    np.testing.assert_array_equal(np.asarray(opt_state[0].nu["embedding"]), nu)
    # The same state through convert.py gives optax's fields.
    fields = adam_state_to_numpy(state)
    assert int(fields["count"]) == step
    np.testing.assert_array_equal(fields["nu"]["embedding"], nu)


def test_jax_checkpoint_resumes_in_port_driver(tmp_path, prepared):
    """A JAX save (LAST and BEST at epoch 0) resumes in the port's driver:
    the run starts at epoch 1, continues the Adam count, and, since its
    window does not beat the saved BEST (recall 0.99), tests and returns
    those saved params."""
    n = prepared.n_users + prepared.n_items
    rng = np.random.default_rng(0)
    emb = rng.uniform(-0.1, 0.1, (n, 8)).astype(np.float32)
    jp = {"embedding": jnp.asarray(emb)}
    mu, nu = (rng.standard_normal((n, 8)).astype(np.float32) * 1e-3 for _ in range(2))
    jstate = (optax.ScaleByAdamState(jnp.int32(11), {"embedding": jnp.asarray(mu)},
                                     {"embedding": jnp.asarray(np.abs(nu))}), optax.EmptyState())
    for name in (jckpt.LAST_NAME, jckpt.BEST_NAME):
        jckpt.save_checkpoint(str(tmp_path), jp, jstate, epoch=0, precision=0.05, recall=0.99, name=name)
    cfg = _small(tmp_path, resume=True, batches_per_epoch=3)
    result = train(prepared, cfg, verbose=False, device="cpu")
    assert [h["epoch"] for h in result.history] == [1]
    assert result.best_epoch == 0 and result.best_val_recall == pytest.approx(0.99)
    np.testing.assert_array_equal(result.params["embedding"].numpy(), emb)
    leaves, meta = tckpt.load_checkpoint(str(tmp_path), tckpt.LAST_NAME)
    assert meta["epoch"] == 1 and int(leaves[1]) == 11 + 3
    assert json.load(open(tmp_path / tckpt.BEST_NAME / "meta.json"))["recall"] == pytest.approx(0.99)
    restored = adam_state_to_torch(jstate, "cpu")
    assert restored.step == 11
    np.testing.assert_array_equal(restored.exp_avg["embedding"].numpy(), mu)


# ---------------------------------------------------------------- driver


@pytest.fixture(scope="module")
def branch_runs(prepared, tmp_path_factory):
    runs = {}
    for fast in ("off", "f32", "bf16"):
        d = tmp_path_factory.mktemp(f"train_{fast}")
        cfg = _small(d, fast_bipartite=fast, heavy_users=40 if fast == "bf16" else 0)
        runs[fast] = (d, train(prepared, cfg, verbose=False, device="cpu"))
    return runs


@pytest.mark.parametrize("fast", ["off", "f32", "bf16"])
def test_train_branch_runs_and_saves(branch_runs, fast):
    d, result = branch_runs[fast]
    assert [h["epoch"] for h in result.history] == [0, 1]
    for h in result.history:
        assert np.isfinite(h["loss"]) and h["dropped_arcs"] == 0.0 and h["epoch_s"] > 0
        assert 0.0 <= h["val_recall"] <= 1.0
    assert 0.0 <= result.test_recall <= 1.0
    for name in (tckpt.BEST_NAME, tckpt.LAST_NAME):
        leaves, meta = tckpt.load_checkpoint(str(d), name)
        assert meta["leaf_paths"] == JAX_LEAF_PATHS and leaves[0].shape[1] == 8
    log = [json.loads(line) for line in open(d / "train_log.jsonl")]
    assert [r["epoch"] for r in log if "epoch" in r and "loss" in r] == [0, 1]
    np.testing.assert_array_equal(
        tckpt.load_checkpoint(str(d), tckpt.BEST_NAME)[0][0], result.params["embedding"].numpy()
    )


def test_fast_f32_branch_follows_the_layered_branch(branch_runs):
    """Same seed, same batches: the exact fast branch and the layered branch
    differ only in summation order."""
    off, f32 = branch_runs["off"][1], branch_runs["f32"][1]
    for a, b in zip(off.history, f32.history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    np.testing.assert_allclose(off.params["embedding"].numpy(), f32.params["embedding"].numpy(), atol=1e-5)


def test_equal_seeds_give_equal_runs(prepared, tmp_path):
    a = train(prepared, _small(tmp_path / "a", fast_bipartite="bf16", heavy_users=40), verbose=False, device="cpu")
    b = train(prepared, _small(tmp_path / "b", fast_bipartite="bf16", heavy_users=40), verbose=False, device="cpu")
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert torch.equal(a.params["embedding"], b.params["embedding"])


def test_resume_continues_and_keeps_a_better_best(prepared, tmp_path):
    r1 = train(prepared, _small(tmp_path), verbose=False, device="cpu")
    r2 = train(prepared, _small(tmp_path, epochs=3, resume=True), verbose=False, device="cpu")
    assert [h["epoch"] for h in r2.history] == [2]
    assert r2.best_val_recall >= r1.best_val_recall
    # A BEST the resumed window cannot beat stays on disk and is what the
    # final test evaluates.
    leaves, _ = tckpt.load_checkpoint(str(tmp_path), tckpt.BEST_NAME)
    params = {"embedding": torch.from_numpy(leaves[0])}
    state = AdamState(int(leaves[1]), {"embedding": torch.from_numpy(leaves[2])},
                      {"embedding": torch.from_numpy(leaves[3])})
    tckpt.save_checkpoint(str(tmp_path), params, state, epoch=1, precision=0.5, recall=1.0)
    r3 = train(prepared, _small(tmp_path, epochs=4, resume=True), verbose=False, device="cpu")
    assert [h["epoch"] for h in r3.history] == [3]
    assert r3.best_epoch == 1 and r3.best_val_recall == 1.0
    meta = json.load(open(tmp_path / tckpt.BEST_NAME / "meta.json"))
    assert meta["recall"] == 1.0 and meta["epoch"] == 1
    np.testing.assert_array_equal(r3.params["embedding"].numpy(), leaves[0])


def test_epoch_record_logged_when_save_raises(prepared, tmp_path, monkeypatch):
    """Deliberate difference (JAX driver.py:1003 logs after the save block
    and loses the record): the record reaches the JSONL, the error
    propagates."""

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(driver, "save_checkpoint", fail)
    with pytest.raises(OSError, match="disk full"):
        train(prepared, _small(tmp_path, async_saves=False), verbose=False, device="cpu")
    records = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    epoch0 = [r for r in records if r.get("epoch") == 0 and "val_recall" in r]
    assert len(epoch0) == 1 and "save_s" not in epoch0[0]


def test_async_save_banded_snapshot(prepared, tmp_path, monkeypatch):
    """``tests/test_train_e2e.py::test_async_save_banded_snapshot``: with a
    1 KB band every table leaf is copied in bands, and the checkpoint is
    byte-identical to a synchronous, unbanded save."""
    monkeypatch.setattr(driver, "SNAPSHOT_BAND_BYTES", 1024)
    writers = []
    real_writer = driver.CheckpointWriter

    def recording_writer(*a, **k):
        writers.append(real_writer(*a, **k))
        return writers[-1]

    monkeypatch.setattr(driver, "CheckpointWriter", recording_writer)
    r_async = train(prepared, _small(tmp_path / "a", epochs=1), verbose=False, device="cpu")
    r_sync = train(prepared, _small(tmp_path / "s", epochs=1, async_saves=False), verbose=False, device="cpu")
    for name in ("LightGCN_best", "LightGCN_last"):
        a = (tmp_path / "a" / name / "checkpoint.npz").read_bytes()
        assert a == (tmp_path / "s" / name / "checkpoint.npz").read_bytes()
    assert r_async.best_val_recall == r_sync.best_val_recall
    (w,) = writers
    leaf_bytes = r_async.params["embedding"].numel() * 4
    bands = driver._snapshot_bands(r_async.params["embedding"])
    assert bands == -(-leaf_bytes // 1024)
    # One snapshot (BEST and LAST of the one epoch share it): three banded
    # leaves (params and both moments).
    assert w.stats["snapshot_copies"] == 3 * bands


def test_snapshot_bands_follow_the_jax_rule():
    """Leaves up to twice the band are one copy; larger ones are cut into
    ceil(bytes / band) bands of equal rows (the last shorter)."""
    band = driver.SNAPSHOT_BAND_BYTES
    for rows, cols, want in ((10, 4, 1), (2 * band // 16, 4, 1), (2 * band // 16 + 1, 4, 3)):
        assert driver._snapshot_bands(torch.empty(rows, cols)) == want
    assert driver._snapshot_bands(torch.empty(())) == 1


def test_async_save_duty_cycle(prepared, tmp_path, monkeypatch):
    """``tests/test_train_e2e.py::test_async_save_duty_cycle``: at duty 0.05
    each 0.3 s write earns a 5.7 s idle, yet the final flush cuts it short:
    the newest LAST lands, the run stays fast, and the flush record carries
    the writer's busy and idle seconds and bytes."""
    import time as _time

    real_save = driver.save_checkpoint
    written = []

    def slow_save(*args, **kwargs):
        _time.sleep(0.3)
        written.append((kwargs.get("name"), kwargs.get("epoch")))
        return real_save(*args, **kwargs)

    monkeypatch.setattr(driver, "save_checkpoint", slow_save)
    n_epochs = 4
    cfg = _small(tmp_path, epochs=n_epochs, batches_per_epoch=2, async_save_duty=0.05, checkpoint_every=1)
    t0 = _time.perf_counter()
    train(prepared, cfg, verbose=False, device="cpu")
    wall = _time.perf_counter() - t0
    assert json.load(open(tmp_path / "LightGCN_last" / "meta.json"))["epoch"] == n_epochs - 1
    assert max(e for name, e in written if name == "LightGCN_last") == n_epochs - 1
    records = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    (stats,) = [r for r in records if "flush_s" in r]
    assert stats["written"] >= 2
    assert stats["writer_bytes"] > 0
    assert stats["writer_busy_s"] > 0
    assert stats["writer_idle_s"] > 0  # the writer did idle between writes
    assert any("save_s" in r for r in records if "epoch_s" in r)
    assert wall < 30.0


def test_writer_idles_in_proportion_and_flush_cuts_it(tmp_path, monkeypatch):
    """After a write of T seconds the writer idles T·(1-d)/d: at d = 0.5 a
    0.2 s write delays the next write by about 0.2 s; a flush ends the
    idle at once."""
    import time as _time

    real_save = driver.save_checkpoint
    starts = []

    def timed_save(*a, **k):
        starts.append(_time.monotonic())
        _time.sleep(0.2)
        return real_save(*a, **k)

    monkeypatch.setattr(driver, "save_checkpoint", timed_save)
    writer = driver.CheckpointWriter(str(tmp_path), {}, duty=0.5)
    try:
        p, s = _tiny_state()
        writer.save(p, s, [("A", dict(epoch=0, precision=0, recall=0))])
        while not starts:
            _time.sleep(0.01)
        writer.save(p, s, [("B", dict(epoch=1, precision=0, recall=0))])
        writer.flush()
        gap_flushed = starts[1] - starts[0]
        writer.save(p, s, [("C", dict(epoch=2, precision=0, recall=0))])
        while len(starts) < 3:
            _time.sleep(0.01)
        writer.save(p, s, [("D", dict(epoch=3, precision=0, recall=0))])
        while len(starts) < 4:
            _time.sleep(0.01)
        gap_idle = starts[3] - starts[2]
        writer.flush()
    finally:
        writer.stop(timeout=30)
    assert gap_flushed < 0.35  # 0.2 s write, no idle: the flush cut it
    assert gap_idle >= 0.38  # 0.2 s write + about 0.2 s idle
    assert writer.stats["written"] == 4
    low = driver.CheckpointWriter(str(tmp_path), {}, duty=0.0)
    low.stop(timeout=30)
    assert low.duty == 0.05


def _tiny_state():
    p = {"embedding": torch.ones(3, 2)}
    return p, AdamState(1, {"embedding": torch.zeros(3, 2)}, {"embedding": torch.zeros(3, 2)})


def test_async_writer_coalesces_superseded_saves(tmp_path, monkeypatch):
    entered, release = threading.Event(), threading.Event()
    real = driver.save_checkpoint

    def slow_first(*a, **k):
        if not entered.is_set():
            entered.set()
            assert release.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(driver, "save_checkpoint", slow_first)
    writer = driver.CheckpointWriter(str(tmp_path), {})
    try:
        p, s = _tiny_state()
        writer.save(p, s, [("A", dict(epoch=0, precision=0, recall=0))])
        assert entered.wait(30)  # the writer holds save 1
        writer.save(p, s, [("B", dict(epoch=1, precision=0, recall=0))])
        writer.save(p, s, [("B", dict(epoch=2, precision=0, recall=0))])  # replaces the queued B
        p["embedding"].fill_(5.0)  # the snapshot was taken: this is not saved with A
        writer.save(p, s, [("A", dict(epoch=3, precision=0, recall=0))])
        release.set()
        writer.flush()
    finally:
        writer.stop(timeout=30)
    assert writer.stats["requested"] == 4 and writer.stats["coalesced"] == 1
    assert writer.stats["written"] == 3
    assert json.load(open(tmp_path / "B" / "meta.json"))["epoch"] == 2
    leaves, meta = tckpt.load_checkpoint(str(tmp_path), "A")
    assert meta["epoch"] == 3 and (leaves[0] == 5.0).all()


def test_async_writer_surfaces_failures(prepared, tmp_path, monkeypatch):
    def fail(*a, **k):
        raise OSError("no space")

    monkeypatch.setattr(driver, "save_checkpoint", fail)
    writer = driver.CheckpointWriter(str(tmp_path), {})
    try:
        writer.save(*_tiny_state(), [("A", dict(epoch=0, precision=0, recall=0))])
        with pytest.raises(RuntimeError, match="async checkpoint write.*no space"):
            writer.flush()
    finally:
        writer.stop(timeout=30)
    # Through the driver, the failure ends the run.
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        train(prepared, _small(tmp_path / "run"), verbose=False, device="cpu")


def test_operator_build_retried_once_on_oom(prepared, tmp_path, monkeypatch):
    real, calls = driver.build_fast_bipartite, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(*a, **k)

    monkeypatch.setattr(driver, "build_fast_bipartite", flaky)
    monkeypatch.setattr(driver, "RETRY_WAIT_S", 0.0)
    result = train(prepared, _small(tmp_path, fast_bipartite="f32", epochs=1), verbose=False, device="cpu")
    assert len(calls) == 2 and len(result.history) == 1
    assert "retrying once" in open(tmp_path / "train_log.jsonl").read()


def test_device_rules_and_profiler(prepared, tmp_path):
    # Without a torch.distributed world, a mesh of 2 has no second rank.
    with pytest.raises(ValueError, match="mesh_devices must be the world's size"):
        train(prepared, _small(tmp_path, mesh_devices=2), verbose=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(prepared, _small(tmp_path), verbose=False)
    prof = tmp_path / "prof"
    train(prepared, _small(tmp_path / "p", profile_dir=str(prof), batches_per_epoch=1),
          verbose=False, device="cpu")
    assert os.path.exists(prof / "train_epoch1.json")
