"""The load that the serving runs share, and the check of its answers.

The JAX scripts each carry a copy of this: one HTTP caller for ``:predict``,
``clients`` threads that each send requests of ``batch`` random users for a
fixed window (``scripts/serve_r5.py:run_slice``, client ``i`` of slice
``seed`` seeded ``seed * 1000 + i``; ``scripts/serve_r4.py:run_load``,
client ``i`` seeded ``i``), the windowed summary (requests/s, users/s,
p50/p90/p99) and the interleaved A/B protocol (``interleaved_ab``). The
summaries here are those scripts' arithmetic, rounding included.

One addition is a check, not a feature. The scripts' clients count only
exceptions; these also keep each request's ids and answer, and after the
window :class:`AnswerCheck` holds every answer against the plain top-K of
the version that served it: the f32 scores of the cached embedding, or the
int8 product of its quantized rows, with the user's train purchases masked
(:class:`Reference`). An answer may differ from it only by items tied with
its K-th score: within ``F32_RTOL`` of it in f32, exactly in int8. When two
versions may have served a window (a register or a rollback under load),
every answer must be one version's top-K in all of its rows, never a mix.
``:predict`` answers ``{"items": ...}`` without the version, so the check
tries each version. The check runs after the window and adds no time to it.

Everything runs in one process, as the JAX protocol did: the HTTP server's
threads, the client threads and the batcher's dispatch workers share one
interpreter lock (``host``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from ..device import mm_f32
from ..serve.quantized import int8_product_plain
from ..serve.server import MODEL_NAME, make_server

PREDICT = f"/v1/models/{MODEL_NAME}:predict"
# The scripts' client timeout for one request.
CALL_TIMEOUT_S = 120
# A management call (a register loads a checkpoint and propagates it).
MANAGE_TIMEOUT_S = 600
# Ties: an f32 answer may swap items whose plain scores lie within this
# relative distance of the K-th score (cuBLAS may sum a batch of another
# size in another order); int8 scores are exact, so int8 ties are exact.
F32_RTOL = 1e-6
# Rows of plain scores computed at once by the answer check.
CHECK_CHUNK = 4096


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def host() -> dict:
    return {
        "cpu_count": os.cpu_count(),
        "process": "one process: the HTTP server's threads, the client threads and the "
                   "batcher's dispatch workers share one interpreter lock",
    }


def request(base: str, method: str, path: str, body=None, timeout: float = MANAGE_TIMEOUT_S):
    """One JSON call to the server at ``base``; an HTTP error raises."""
    req = urllib.request.Request(
        f"{base}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method=method,
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def predict(base: str, ids) -> list:
    """``:predict`` for ``ids``: the answer's item rows."""
    return request(base, "POST", PREDICT, [int(i) for i in ids], timeout=CALL_TIMEOUT_S)["items"]


class Server:
    """``make_server(handler)`` on an ephemeral port, served from a thread."""

    def __init__(self, handler):
        self.httpd = make_server(handler, port=0)
        self.port = self.httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=30)


@dataclasses.dataclass
class Answer:
    ids: np.ndarray
    items: list
    t0: float  # perf_counter at send and at the parsed answer
    t1: float


@dataclasses.dataclass
class Slice:
    """One window of load: each request's latency (s) and answer, the
    failed requests and the wall seconds from the clients' start to their
    end."""

    latencies: list
    answers: list
    errors: int
    first_error: str | None
    wall: float
    users_per_s: float

    def raise_errors(self, what: str) -> None:
        if self.errors:
            raise RuntimeError(f"{what}: {self.errors} failed requests, the first: {self.first_error}")


class Load:
    """One client thread for each of ``seeds``, each sending ``:predict``
    requests of ``batch`` users drawn by ``np.random.default_rng(seed)``,
    one after the other, from :meth:`start` until ``seconds`` have passed or
    :meth:`stop`."""

    def __init__(self, port: int, n_users: int, batch: int, seeds, seconds=float("inf")):
        self.base = f"http://127.0.0.1:{port}"
        self.n_users, self.batch = n_users, batch
        self.seeds = list(seeds)
        self.seconds = seconds
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.latencies, self.answers = [], []
        self.errors, self.first_error = 0, None

    def _client(self, seed: int, stop_at: float) -> None:
        rng = np.random.default_rng(seed)
        while not self._stop.is_set() and time.perf_counter() < stop_at:
            ids = rng.integers(0, self.n_users, self.batch)
            t0 = time.perf_counter()
            try:
                items = predict(self.base, ids)
            except Exception as e:  # a failed request must not end its client
                with self._lock:
                    self.errors += 1
                    self.first_error = self.first_error or f"{type(e).__name__}: {e}"
                continue
            t1 = time.perf_counter()
            try:  # kept as an array: millions of small lists would slow the collector
                items = np.array(items, dtype=np.int64)
            except (TypeError, ValueError):
                pass  # a malformed answer, which the answer check rejects
            with self._lock:
                self.latencies.append(t1 - t0)
                self.answers.append(Answer(ids, items, t0, t1))

    def start(self) -> "Load":
        stop_at = time.perf_counter() + self.seconds
        self._threads = [
            threading.Thread(target=self._client, args=(s, stop_at), daemon=True) for s in self.seeds
        ]
        self._t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def join(self) -> Slice:
        for t in self._threads:
            t.join()
        wall = time.perf_counter() - self._t0
        return Slice(self.latencies, self.answers, self.errors, self.first_error, wall,
                     len(self.latencies) * self.batch / wall)

    def stop(self) -> Slice:
        self._stop.set()
        return self.join()


def run_slice(port: int, n_users: int, batch: int, seconds: float, seeds) -> Slice:
    """One fixed window of load, a client for each of ``seeds``."""
    return Load(port, n_users, batch, seeds, seconds).start().join()


def pct_ms(lat: np.ndarray, q: float) -> float:
    """The scripts' percentile of sorted seconds ``lat`` (the element at
    ``int(len * q)``, at most the last), in ms to 0.1."""
    return round(float(lat[min(len(lat) - 1, int(len(lat) * q))]) * 1e3, 1)


def window_summary(latencies, wall: float, clients: int, batch: int) -> dict:
    """The windowed summary of ``scripts/serve_sustained_r3.py`` and
    ``serve_r4.py:run_load`` (without the latter's label and errors)."""
    lat = np.sort(np.array(latencies))
    out = {"clients": clients, "batch": batch, "window_s": round(wall, 1), "requests": len(lat)}
    if len(lat) == 0:
        return {**out, "requests_per_s": 0.0, "users_per_s": 0.0,
                "latency_ms": {"p50": None, "p90": None, "p99": None}}
    return {
        **out,
        "requests_per_s": round(len(lat) / wall, 1),
        "users_per_s": round(len(lat) * batch / wall, 1),
        "latency_ms": {"p50": pct_ms(lat, 0.5), "p90": pct_ms(lat, 0.9), "p99": pct_ms(lat, 0.99)},
    }


def interleaved_ab(configs, n_users: int, clients: int, batch: int, verify, reps: int = 6,
                   slice_s: float = 5.0) -> dict:
    """``scripts/serve_r5.py:interleaved_ab``: ``reps`` + 1 interleaved
    slice pairs over ``configs`` ((name, port), (name, port)), the first
    (warm) pair discarded; per config the slices' users/s, their mean, spread
    and stdev, the errors and the pooled p50/p99; the effect of A over B and
    whether it exceeds twice the larger stdev. ``verify(name, answers)``
    checks each slice's answers after the slice; a failed request raises."""
    names = [name for name, _ in configs]
    per = {name: [] for name in names}
    lats = {name: [] for name in names}
    errs = {name: 0 for name in names}
    for rep in range(reps + 1):
        for name, port in configs:
            sl = run_slice(port, n_users, batch, slice_s, [rep * 1000 + i for i in range(clients)])
            sl.raise_errors(f"{name} slice {rep}")
            verify(name, sl.answers)
            if rep == 0:
                continue  # warm slice: first-touch path effects, discarded
            per[name].append(round(sl.users_per_s, 1))
            lats[name].extend(sl.latencies)
            errs[name] += sl.errors
        log(f"  rep {rep}: " + ", ".join(f"{n}={per[n][-1] if per[n] else 'warm'}" for n in names))
    out = {}
    for name in names:
        v = np.array(per[name])
        lat = np.sort(np.array(lats[name]))
        out[name] = {
            "slices_users_per_s": per[name],
            "mean_users_per_s": round(float(v.mean()), 1),
            "spread_users_per_s": round(float(v.max() - v.min()), 1),
            "stdev_users_per_s": round(float(v.std()), 1),
            "errors": errs[name],
            "p50_ms": pct_ms(lat, 0.5),
            "p99_ms": pct_ms(lat, 0.99),
        }
    a, b = out[names[0]], out[names[1]]
    effect = a["mean_users_per_s"] / max(b["mean_users_per_s"], 1e-9)
    spread = max(a["stdev_users_per_s"], b["stdev_users_per_s"])
    sep = abs(a["mean_users_per_s"] - b["mean_users_per_s"])
    out["effect_a_over_b"] = round(effect, 2)
    out["effect_exceeds_spread"] = bool(sep > 2 * spread)
    return out


class Reference:
    """The plain top-K of one served version: the f32 product of its cached
    embedding (``emb``), or, for a quantized version (``qcache``), the f32
    product of its int8 rows (exact) rescaled as ``topk_scores_int8`` does;
    the user's train purchases at -inf; ``torch.topk``."""

    def __init__(self, prepared, emb: torch.Tensor | None = None, qcache=None):
        self.prepared, self.emb, self.qcache = prepared, emb, qcache
        self.rtol = F32_RTOL if qcache is None else 0.0

    @classmethod
    def of(cls, svc, version: str | None = None) -> "Reference":
        """The reference of ``svc``'s ``version`` (default: the active one)
        as it stands now: the cache the service ranks on."""
        with svc._lock:
            entry = svc._versions[version if version is not None else svc._active]
        return cls(svc.prepared, entry["emb"], entry["qcache"])

    @property
    def device(self) -> torch.device:
        return (self.emb if self.qcache is None else self.qcache.user_q).device

    def scores(self, ids: np.ndarray) -> torch.Tensor:
        """[B, I] f32 scores of ``ids``, purchases at -inf."""
        dev, n_users = self.device, self.prepared.n_users
        ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        if self.qcache is None:
            scores = mm_f32(self.emb[ids_t], self.emb[n_users:].T)
        else:
            qc = self.qcache
            scores = int8_product_plain(qc.user_q[ids_t], qc.item_q) * qc.user_s[ids_t][:, None]
            scores = scores * qc.item_s[None, :]
        rows, cols = purchases(self.prepared, ids)
        scores[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)] = -float("inf")
        return scores


def purchases(prepared, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, local item) of every train purchase of the users ``ids``."""
    s = prepared.sampler
    slots = np.minimum(np.searchsorted(s.users, ids), len(s.users) - 1)
    rows = np.flatnonzero(s.users[slots] == ids)
    lo, hi = s.pos_indptr[slots[rows]], s.pos_indptr[slots[rows] + 1]
    n = hi - lo
    flat = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
    return np.repeat(rows, n), s.pos_flat[flat] - prepared.n_users


class WrongAnswer(AssertionError):
    """An answer that is no version's top-K."""


class AnswerCheck:
    """Holds answers to the plain top-``k`` of the versions that may have
    served them, and counts what it checked and the seconds it took."""

    def __init__(self, k: int = 20):
        self.k = k
        self.answers = self.rows = self.tie_rows = 0
        self.seconds = 0.0

    def stats(self) -> dict:
        return {"checked": self.answers, "rows": self.rows, "rows_differing_by_ties": self.tie_rows,
                "seconds": round(self.seconds, 3)}

    def rows_ok(self, ref: Reference, ids: np.ndarray, items: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per row: the answer is ``ref``'s top-K as a set, up to ties (its
        K distinct items, and every item of it or of the plain top-K that
        the other lacks scores within ``ref.rtol`` of the plain K-th score),
        and whether it needed a tie to be."""
        ok = np.zeros(len(ids), dtype=bool)
        tie = np.zeros(len(ids), dtype=bool)
        for lo in range(0, len(ids), CHECK_CHUNK):
            hi = min(lo + CHECK_CHUNK, len(ids))
            got = items[lo:hi]
            with torch.inference_mode():
                scores = ref.scores(ids[lo:hi])
                n_items = scores.shape[1]
                vals, idx = torch.topk(scores, self.k, dim=1)
                at = torch.as_tensor(np.clip(got, 0, n_items - 1), device=scores.device)
                s_got = scores.gather(1, at).double().cpu().numpy()
                vals, idx = vals.double().cpu().numpy(), idx.cpu().numpy()
            srt = np.sort(got, 1)
            same = (srt == np.sort(idx, 1)).all(1)
            valid = (got >= 0).all(1) & (got < n_items).all(1) & (srt[:, 1:] != srt[:, :-1]).all(1)
            kth = vals[:, -1:]
            tol = ref.rtol * np.abs(kth)
            in_want = (got[:, :, None] == idx[:, None, :]).any(2)
            in_got = (idx[:, :, None] == got[:, None, :]).any(2)
            extra_near = (in_want | (np.abs(s_got - kth) <= tol)).all(1)
            missing_near = (in_got | (np.abs(vals - kth) <= tol)).all(1)
            ok[lo:hi] = same | (valid & extra_near & missing_near)
            tie[lo:hi] = ok[lo:hi] & ~same
        return ok, tie

    def check(self, answers: list, refs: dict) -> dict:
        """Every answer is, in all its rows, the top-K of one of ``refs``
        ({version: Reference}), up to ties; raises :class:`WrongAnswer`
        otherwise. Returns how many answers each version (or several,
        ``"a|b"``, where they agree) explains."""
        if not answers:
            return {}
        t0 = time.perf_counter()
        ids = np.concatenate([np.asarray(a.ids, dtype=np.int64) for a in answers])
        lens = np.array([len(a.ids) for a in answers])
        rows = []
        for a in answers:
            try:
                got = np.asarray(a.items, dtype=np.int64)
            except (TypeError, ValueError) as e:  # ragged or not integers
                raise WrongAnswer(f"a malformed answer for users {np.asarray(a.ids)[:8].tolist()}: {e}") from e
            if got.shape != (len(a.ids), self.k):
                raise WrongAnswer(f"an answer of shape {got.shape} for {len(a.ids)} users, top-{self.k}")
            rows.append(got)
        items = np.concatenate(rows)
        names = list(refs)
        ok = np.zeros((len(ids), len(names)), dtype=bool)
        tie = np.zeros_like(ok)
        for j, name in enumerate(names):
            ok[:, j], tie[:, j] = self.rows_ok(refs[name], ids, items)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        whole = np.logical_and.reduceat(ok, starts, axis=0)  # [answers, versions]
        bad = np.flatnonzero(~whole.any(1))
        if len(bad):
            a = answers[bad[0]]
            raise WrongAnswer(
                f"{len(bad)} of {len(answers)} answers are no version's top-{self.k} "
                f"(versions {names}); the first, for users {np.asarray(a.ids)[:8].tolist()}..., "
                f"matches them in {ok[starts[bad[0]]:starts[bad[0]] + lens[bad[0]]].sum(0).tolist()} "
                f"of its {lens[bad[0]]} rows"
            )
        self.answers += len(answers)
        self.rows += len(ids)
        # A row differs by ties if no version it matches gives it exactly.
        self.tie_rows += int((ok.any(1) & ~(ok & ~tie).any(1)).sum())
        by = {}
        for row in whole:
            key = "|".join(n for n, hit in zip(names, row) if hit)
            by[key] = by.get(key, 0) + 1
        self.seconds += time.perf_counter() - t0
        return by


def profile_window(port: int, n_users: int, clients: int, batch: int, seconds: float,
                   device: torch.device) -> tuple[Slice, dict]:
    """One window of load under ``torch.profiler`` (every thread): the host
    time that requests spend in the CUDA runtime's copies and stream waits
    (``cudaMemcpyAsync``; ``cudaStreamSynchronize``, which a pageable copy
    ends with), per request and as a share of the window's summed latency;
    the card's busy share (kernels and copies over the window); the
    heaviest host-side operators. Device numbers are "not measured" on the
    CPU. The profiler's own cost inflates this window's latencies. Returns
    the window's :class:`Slice` and that summary."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        sl = run_slice(port, n_users, batch, seconds, range(clients))
        if cuda:
            torch.cuda.synchronize(device)
    sl.raise_errors("profiled window")
    events = prof.key_averages()
    n = max(len(sl.latencies), 1)
    lat_ms = sum(sl.latencies) * 1e3
    out = {
        "window_s": round(sl.wall, 3),
        "requests": len(sl.latencies),
        "latency_ms_mean": round(lat_ms / n, 3),
        "latency_ms_p99": pct_ms(np.sort(np.array(sl.latencies)), 0.99) if sl.latencies else None,
    }
    host_ops = sorted(
        (e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::")),
        key=lambda e: e.cpu_time_total, reverse=True,
    )
    out["top_host_ops_ms_per_request"] = {e.key: round(e.cpu_time_total / 1e3 / n, 4) for e in host_ops[:6]}
    if not cuda:
        for key in ("copy_wait_ms_per_request", "copy_wait_share_of_latency", "copies_per_request",
                    "device_busy_share"):
            out[key] = "not measured"
        return sl, out
    runtime = {e.key: e for e in events if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize")}
    wait_ms = sum(e.cpu_time_total for e in runtime.values()) / 1e3
    device_ms = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    memcpy = {e.key: e.count for e in events if e.device_type == DeviceType.CUDA and e.key.startswith("Memcpy")}
    out.update({
        "copy_wait_ms_per_request": round(wait_ms / n, 4),
        "copy_wait_share_of_latency": round(wait_ms / lat_ms, 4) if lat_ms else None,
        "copies_per_request": {k: round(c / n, 3) for k, c in memcpy.items()},
        "runtime_calls_per_request": {k: round(e.count / n, 3) for k, e in runtime.items()},
        "device_busy_share": round(device_ms / (sl.wall * 1e3), 4),
        "device_ms_per_request": round(device_ms / n, 4),
    })
    return sl, out
