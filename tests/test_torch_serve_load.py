"""The serving runs (``gnn_ecommerce_tpu_torch/runs/``) on the CPU.

- ``_load.interleaved_ab`` and the windowed summary give the numbers of the
  JAX scripts' ``interleaved_ab`` (``scripts/serve_r5.py``) and ``run_load``
  (``scripts/serve_r4.py``) on the same fixed slices and latencies, each
  script loaded from ``scripts/`` unedited with its ``run_slice`` (or its
  clock and its HTTP call) replaced.
- Each run runs short windows with a few clients on two checkpoints of a
  small corpus (``init_params`` keys 0 and 1, dim 8, 2 layers): no failed
  request, and every answer it checked equals the JAX
  ``RecommenderService``'s top-20 for those ids (the quantized service's for
  an int8 answer), except items tied with the 20th score (within
  ``F32_RTOL`` relative in f32, exactly in int8). The register sequence's
  answers equal JAX's for the first, the second and again the first version.
- Each run's JSON keys are the JAX file's (``SERVE_r3.json``'s
  ``sustained_http_load``, ``SERVE_r4.json``, ``SERVE_r5.json``,
  ``scripts/serve_register_r5.json``) plus the run's ``EXTRA_KEYS``.
  ``SERVE_r4.json``'s windows predate the script's ``errors`` field: a
  window's keys are held to the script's ``run_load``.
- The answer check fails on a planted wrong answer and on a planted mix of
  two versions; each run's command line raises without a card unless
  ``--device cpu`` is given.
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.data import events_to_edges, prepare_splits, split_edges, synthetic_events
from gnn_ecommerce_tpu.data.artifacts import save_prepared as jax_save_prepared
from gnn_ecommerce_tpu.data.events import EVENT_TYPE_WEIGHTS_V1
from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import init_params as jax_init_params
from gnn_ecommerce_tpu.serve import RecommenderService as JaxService
from gnn_ecommerce_tpu.train.checkpoint import save_checkpoint
from gnn_ecommerce_tpu_torch.runs import _load, serve_r4, serve_r5, serve_register_r5, serve_sustained_r3
from gnn_ecommerce_tpu_torch.serve import RecommenderService
from gnn_ecommerce_tpu_torch.train.checkpoint import BEST_NAME, LAST_NAME

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
HP = {"latent_dim": 8, "n_layers": 2}
K = 20
# Short protocols: windows and slices of 0.3 s, 2-4 clients.
WINDOW_S = 0.3
BIG, SMALL = (2, 40), (3, 2)  # (clients, users): 40 >= the batcher's solo_min


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_serve_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_keys(path: str, key: str | None = None) -> set:
    data = json.loads((ROOT / path).read_text())
    return set(data[key] if key else data)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A small prepared dir (written by the JAX package) and two checkpoints
    of dim 8 / 2 layers: LightGCN_best (key 0) and LightGCN_last (key 1)."""
    root = tmp_path_factory.mktemp("torch_serve_load")
    events = synthetic_events(n_users=300, n_items=60, n_events=6000, seed=3)
    prepared = prepare_splits(*split_edges(events_to_edges(events, EVENT_TYPE_WEIGHTS_V1), seed=0))
    jax_save_prepared(prepared, str(root / "data"))
    cfg = JaxConfig(prepared.n_users + prepared.n_items, 8, 2)
    opt = optax.adam(1e-3)
    for i, name in enumerate([BEST_NAME, LAST_NAME]):
        p = jax_init_params(jax.random.key(i), cfg)
        save_checkpoint(
            str(root / "ckpt"), p, opt.init(p), epoch=i, precision=0.1, recall=0.2 + i,
            hyperparams=HP, name=name,
        )
    return str(root / "data"), str(root / "ckpt")


@pytest.fixture(scope="module")
def services(artifacts):
    """The port's f32 and quantized services on the best checkpoint."""
    data, ckpt = artifacts
    svc = RecommenderService.from_artifacts(data, ckpt, BEST_NAME, device="cpu")
    svc_q, _ = serve_r5.build_quantized(svc, ckpt, BEST_NAME)
    return svc, svc_q


@pytest.fixture(scope="module")
def jax_tops(artifacts):
    """JAX's top-20 and scores of every user, by (checkpoint, quantized)."""
    data, ckpt = artifacts
    out = {}
    for name in (BEST_NAME, LAST_NAME):
        for quantized in (False, True):
            jsvc = JaxService.from_artifacts(data, ckpt, name, quantized=quantized)
            users = np.arange(jsvc.prepared.n_users)
            top = np.asarray(jsvc.recommend(users))
            if quantized:
                qc = jsvc._versions[jsvc._active]["qcache"]
                scores = (np.asarray(qc.user_q, np.float64) @ np.asarray(qc.item_q, np.float64).T)
                scores = (scores.astype(np.float32) * np.asarray(qc.user_s)[:, None]
                          * np.asarray(qc.item_s)[None, :])
            else:
                emb = np.asarray(jsvc.final_emb, np.float64)
                scores = emb[: len(users)] @ emb[len(users):].T
            out[name, quantized] = (top, scores)
    return out


def _hold_to_jax(ids, items, top, scores, rtol):
    """Each answer row is JAX's top-20 as a set, except items tied with its
    20th score."""
    for u, row in zip(np.asarray(ids), items):
        want = set(top[u].tolist())
        assert len(row) == K and len(set(row)) == K
        if set(row) == want:
            continue
        kth = np.sort(scores[u, list(want)])[0]
        for item in set(row) ^ want:
            assert abs(scores[u, item] - kth) <= rtol * abs(kth) + 1e-7, (u, item)


@pytest.fixture
def checked(monkeypatch):
    """Every (answers, refs) that a run's AnswerCheck is given."""
    seen = []
    real = _load.AnswerCheck.check

    def spy(self, answers, refs):
        seen.append((answers, refs))
        return real(self, answers, refs)

    monkeypatch.setattr(_load.AnswerCheck, "check", spy)
    return seen


def _hold_checked_to_jax(seen, jax_tops, version_names):
    """Every checked answer equals JAX's top-20 (int8 or f32) of one of the
    versions it was held to, in all its rows. Returns the answers."""
    n = 0
    for answers, refs in seen:
        tops = [jax_tops[version_names.get(v, BEST_NAME), ref.qcache is not None] + (ref.rtol,)
                for v, ref in refs.items()]
        for a in answers:
            fits = []
            for top, scores, rtol in tops:
                try:
                    _hold_to_jax(a.ids, a.items, top, scores, rtol)
                    fits.append(True)
                except AssertionError:
                    fits.append(False)
            assert any(fits), (a.ids[:4], list(refs))
            n += 1
    return n


def test_sustained_run(services, jax_tops, checked):
    svc, _ = services
    out = serve_sustained_r3.run(svc, window_s=WINDOW_S, clients=2, batch=16, profile_s=WINDOW_S)
    assert set(out) == _jax_keys("SERVE_r3.json", "sustained_http_load") | serve_sustained_r3.EXTRA_KEYS
    assert out["requests"] >= 1 and out["device"] == "cpu"
    assert out["answers"]["checked"] == out["requests"] + out["profile"]["requests"]
    assert out["profile"]["copy_wait_ms_per_request"] == "not measured"
    assert _hold_checked_to_jax(checked, jax_tops, {}) == out["answers"]["checked"]


def test_serve_r4_run(services, jax_tops, checked):
    svc, _ = services
    out = serve_r4.run(svc, 1.0, "ckpt", window_s=WINDOW_S, clients=BIG[0], batch=BIG[1],
                       small_clients=SMALL[0], small_batch=SMALL[1])
    assert set(out) == _jax_keys("SERVE_r4.json") | serve_r4.EXTRA_KEYS
    assert [w["label"] for w in out["windows"]] == [
        f"{wl}-{mode}" for wl in ("big", "small") for mode in ("unbatched", "batched") * 2
    ]
    run_load_keys = {"label", "clients", "batch", "window_s", "requests", "errors", "requests_per_s",
                     "users_per_s", "latency_ms"}
    assert all(set(w) == run_load_keys and w["errors"] == 0 for w in out["windows"])
    assert set(out["summary"]) == {"big", "small"}
    assert set(out["summary"]["big"]) == set(json.loads((ROOT / "SERVE_r4.json").read_text())["summary"]["big"])
    # Only the small requests ride the batcher.
    small = sum(w["requests"] for w in out["windows"] if w["label"] == "small-batched")
    assert out["batcher"]["batched_requests_total"] >= small > 0
    assert out["answers"]["checked"] == sum(w["requests"] for w in out["windows"])
    assert _hold_checked_to_jax(checked, jax_tops, {}) == out["answers"]["checked"]


def test_serve_r5_run(services, jax_tops, checked):
    svc, svc_q = services
    out = serve_r5.run(svc, svc_q, "ckpt", slice_s=WINDOW_S, reps=1, big=BIG, small=SMALL)
    jax_r5 = json.loads((ROOT / "SERVE_r5.json").read_text())
    assert set(out) == set(jax_r5) | serve_r5.EXTRA_KEYS
    for key in ("small_batched_vs_unbatched", "big_bypass_vs_coalesce", "big_int8_vs_f32",
                "small_batched_int8_vs_f32"):
        assert set(out[key]) == set(jax_r5[key]), key
        for name, cfg in out[key].items():
            if isinstance(cfg, dict):
                assert set(cfg) == set(jax_r5[key][name]) and cfg["errors"] == 0
                assert len(cfg["slices_users_per_s"]) == 1
    assert set(out["conclusions"]) == set(jax_r5["conclusions"])
    assert set(out["int8_accuracy"]) == set(jax_r5["int8_accuracy"])
    assert out["int8_accuracy"]["top20_overlap_mean"] > 0.5
    assert _hold_checked_to_jax(checked, jax_tops, {}) == out["answers"]["checked"] > 0
    assert any(ref.qcache is not None for _, refs in checked for ref in refs.values())


def test_register_run(artifacts, services, jax_tops, checked):
    svc, _ = services
    _, ckpt = artifacts
    out = serve_register_r5.run(svc, ckpt, 1.0, load_clients=BIG[0], load_batch=BIG[1],
                                lead_s=WINDOW_S, tail_s=WINDOW_S)
    assert set(out) == _jax_keys("scripts/serve_register_r5.json") | serve_register_r5.EXTRA_KEYS
    assert out["rollback_exact"] is True and out["under_load"]["rollback_exact"] is True
    load = out["under_load"]
    assert load["errors"] == 0 and load["requests"] >= 1
    assert sum(load["answers_by_version"].values()) == load["requests"]
    assert load["register_window"]["requests"] + load["outside_register"]["requests"] == load["requests"]
    assert [v["version"] for v in svc.list_versions()] == ["1"]
    # Version "1" serves the best checkpoint; the registered ones the last.
    names = {"1": BEST_NAME}
    names.update({v: LAST_NAME for _, refs in checked for v in refs if v != "1"})
    _hold_checked_to_jax(checked, jax_tops, names)


def test_register_sequence_answers_equal_jax(artifacts, services, jax_tops):
    svc, _ = services
    _, ckpt = artifacts
    ids = list(range(0, 300, 7))
    server = _load.Server(svc)
    try:
        seq = serve_register_r5.swap_sequence(server.base, svc, ids, ckpt, LAST_NAME)
    finally:
        server.close()
    for key, name in (("before", BEST_NAME), ("swapped", LAST_NAME), ("back", BEST_NAME)):
        _hold_to_jax(ids, seq[key], *jax_tops[name, False], _load.F32_RTOL)
    assert seq["back"] == seq["before"] != seq["swapped"]


# --- the protocol's arithmetic against the scripts' -------------------------

SLICES = {
    # (users/s of config A, of B) per rep, and each slice's latencies (s).
    "a_wins": ([(500.0, 200.0), (480.5, 210.25), (520.0, 190.0), (470.0, 230.0)], 0.05),
    "a_wash": ([(100.0, 90.0), (300.0, 95.0), (50.0, 140.0), (120.0, 100.0)], 0.2),
}


@pytest.mark.parametrize("case", sorted(SLICES))
def test_interleaved_ab_matches_script(case, monkeypatch):
    script = _script("serve_r5")
    ups, base = SLICES[case]
    reps = len(ups) - 1
    lat = {(port, rep): [base * (1 + port) + 0.001 * i * (rep + 1) for i in range(7 + rep)]
           for port in (0, 1) for rep in range(len(ups))}
    monkeypatch.setattr(script, "REPS", reps)
    monkeypatch.setattr(script, "run_slice", lambda port, n_users, clients, batch, seed: (
        ups[seed][port], lat[port, seed], 0))
    monkeypatch.setattr(_load, "run_slice", lambda port, n_users, batch, seconds, seeds: (
        _load.Slice(lat[port, seeds[0] // 1000], [], 0, None, seconds, ups[seeds[0] // 1000][port])))
    want = script.interleaved_ab("a", 0, "b", 1, 100, 3, 4)
    got = _load.interleaved_ab((("a", 0), ("b", 1)), 100, 3, 4, lambda name, answers: None, reps, 1.0)
    assert got == want


class _FakeClock:
    """A clock that moves only when a request is answered."""

    def __init__(self, latencies):
        self.now, self.latencies = 1000.0, list(latencies)

    def perf_counter(self):
        return self.now

    def answer(self):
        self.now += self.latencies.pop(0) if self.latencies else 100.0


LATENCIES = {
    "few": [0.101, 0.0423, 0.3, 0.0999],
    "many": [0.01 + 0.0007 * ((7 * i) % 113) for i in range(300)],
    "tail": [0.02] * 150 + [1.25, 3.0],
}


@pytest.mark.parametrize("case", sorted(LATENCIES))
def test_window_summary_matches_script(case, monkeypatch):
    script = _script("serve_r4")
    lat = LATENCIES[case]
    clock = _FakeClock([0.0] * 3 + lat)  # three warm requests first
    window = sum(lat) - 1e-9  # the last request starts inside the window
    monkeypatch.setattr(script, "WINDOW_S", window)
    monkeypatch.setattr(script.time, "perf_counter", clock.perf_counter)

    class Resp:
        def __enter__(self):
            clock.answer()
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b'{"items": []}'

    monkeypatch.setattr(script.urllib.request, "urlopen", lambda req, timeout: Resp())
    want = script.run_load(1, 100, "big-batched", clients=1, batch=8)
    got = _load.window_summary(lat, sum(lat), 1, 8)
    assert {"label": "big-batched", "errors": 0, **got} == want


# --- the answer check -------------------------------------------------------

def _true_answers(ref, ids, k=K):
    with torch.no_grad():
        return torch.topk(ref.scores(ids), k, dim=1).indices.numpy()


PLANTS = ("wrong_item", "purchased_item", "duplicate_item", "mixed_versions")


@pytest.mark.parametrize("plant", PLANTS)
def test_answer_check_fails_on_planted_answers(plant, artifacts, services):
    svc, _ = services
    _, ckpt = artifacts
    ids = np.arange(0, 120, 3)
    ref1 = _load.Reference.of(svc)
    svc.register_version(ckpt, LAST_NAME, version="x", set_default=False)
    try:
        ref2 = _load.Reference.of(svc, "x")
    finally:
        svc.unregister_version("x")
    top1, top2 = _true_answers(ref1, ids), _true_answers(ref2, ids)
    rows = [r for r in range(20) if set(top1[r]) != set(top2[r])]
    assert len(rows) >= 2, "the two versions agree on all but one user"
    good = [_load.Answer(ids[:20], top1[:20].tolist(), 0, 0), _load.Answer(ids[20:], top2[20:].tolist(), 0, 0)]
    check = _load.AnswerCheck(K)
    assert check.check(good, {"1": ref1, "x": ref2}) in ({"1": 1, "x": 1}, {"1": 1, "1|x": 1})
    r = rows[0]
    bad = top1[:20].copy()
    if plant == "wrong_item":  # the lowest score that is not a purchase
        s = ref1.scores(ids[r:r + 1])[0]
        bad[r, 0] = int(torch.where(torch.isinf(s), float("inf"), s).argmin())
    elif plant == "purchased_item":
        rows_p, cols_p = _load.purchases(svc.prepared, ids[:20])
        bad[rows_p[0], 0] = cols_p[0]
    elif plant == "duplicate_item":
        bad[r, 1] = bad[r, 0]
    else:  # row r from the second version, the others from the first
        bad[r] = top2[r]
    with pytest.raises(_load.WrongAnswer):
        check.check([_load.Answer(ids[:20], bad.tolist(), 0, 0)], {"1": ref1, "x": ref2})


def test_answer_check_accepts_exact_ties(services):
    """An answer that swaps the plain top-20's 20th item for another of
    exactly its score passes, counted as a tie; the same row with an item
    scored below it fails (test_answer_check_fails_on_planted_answers)."""
    svc, _ = services
    n_users = svc.prepared.n_users
    ids = np.arange(0, 60, 3)
    ref = _load.Reference.of(svc)
    top = _true_answers(ref, ids)
    s = ref.scores(ids[:1])[0]
    a = int(top[0, -1])  # the 20th item of the first user
    b = next(i for i in range(svc.prepared.n_items) if i not in set(top[0]) and torch.isfinite(s[i]))
    emb = ref.emb.clone()
    emb[n_users + b] = emb[n_users + a]  # b now scores exactly what a does, for every user
    tied = _load.Reference(svc.prepared, emb)
    answer = _true_answers(tied, ids)
    row = answer[0].tolist()
    assert (a in row) != (b in row)
    answer[0] = [b if i == a else a if i == b else i for i in row]
    check = _load.AnswerCheck(K)
    assert check.check([_load.Answer(ids, answer, 0, 0)], {"1": tied}) == {"1": 1}
    assert check.tie_rows == 1
    # Both tied items, but without the best one: not a top-20.
    answer[0] = [a, b] + [i for i in row if i not in (a, b)][1:]
    with pytest.raises(_load.WrongAnswer):
        check.check([_load.Answer(ids, answer, 0, 0)], {"1": tied})


@pytest.mark.parametrize("module", [serve_sustained_r3, serve_r4, serve_r5, serve_register_r5])
def test_runs_need_cuda_unless_cpu_is_asked(module, artifacts, monkeypatch):
    data, ckpt = artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["-d", data, "-c", ckpt])


def test_cli_prints_and_writes_one_json_line(artifacts, tmp_path, capsys, monkeypatch):
    data, ckpt = artifacts
    real = serve_sustained_r3.run
    monkeypatch.setattr(serve_sustained_r3, "run", lambda svc: real(
        svc, window_s=WINDOW_S, clients=2, batch=8, profile_s=WINDOW_S))
    out = tmp_path / "sustained.json"
    assert serve_sustained_r3.main(["-d", data, "-c", ckpt, "--device", "cpu", "--out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == json.loads(out.read_text())
    assert json.loads(printed[0])["device"] == "cpu"


def test_load_counts_failed_requests_and_raises():
    """A client whose request fails goes on; the window then raises."""
    sl = _load.run_slice(1, 10, 4, 0.2, [0, 1])  # nothing listens on port 1
    assert sl.errors >= 2 and not sl.latencies and not sl.answers
    with pytest.raises(RuntimeError, match="failed requests"):
        sl.raise_errors("dead server")


def test_server_backlog_holds_concurrent_connects(services):
    """The port's server listens with a backlog of LISTEN_BACKLOG (the
    stdlib's 5 drops handshakes beyond it and resets some connections: a
    deliberate difference from the JAX server); 32 clients connecting at
    once all get their answers."""
    from gnn_ecommerce_tpu_torch.serve.server import LISTEN_BACKLOG

    svc, _ = services
    server = _load.Server(svc)
    try:
        assert server.httpd.request_queue_size == LISTEN_BACKLOG >= 32
        sl = _load.run_slice(server.port, svc.prepared.n_users, 2, WINDOW_S, range(32))
    finally:
        server.close()
    assert sl.errors == 0 and len(sl.answers) >= 32
