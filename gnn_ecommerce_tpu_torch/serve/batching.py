"""Cross-request batching for the serving path.

Counterpart of ``gnn_ecommerce_tpu/serve/batching.py`` (numpy and threads
only). Small requests (< ``solo_min`` users) validate their ids, enqueue and
block; ``parallelism`` worker threads each gather what queued within a short
linger window (or until ``max_users`` fills), make one service call on the
concatenated ids and scatter rows back per request. Large requests and
explicit-k requests bypass the queue.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .service import RecommenderService


class _Pending:
    __slots__ = ("ids", "k", "event", "result", "error", "t_enq")

    def __init__(self, ids: np.ndarray, k):
        self.ids = ids
        self.k = k
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enq = time.perf_counter()


class BatchingRecommender:
    """Wraps a :class:`RecommenderService` with cross-request coalescing.

    Only requests using the service's default ``k`` ride shared batches;
    requests of ``solo_min`` or more users are already efficient batches and
    go straight to the service. Batched dispatches run on up to
    ``parallelism`` worker threads, resizable with :meth:`set_parallelism`.
    """

    def __init__(
        self,
        service: RecommenderService,
        max_wait_s: float = 0.004,
        max_users: int | None = None,
        solo_min: int = 32,
        parallelism: int = 2,
    ):
        self.service = service
        self.max_wait_s = max_wait_s
        self.max_users = max_users or max(service.BATCH_BUCKETS)
        self.solo_min = solo_min
        self._cond = threading.Condition()
        self._pending: list[_Pending] = []
        self._stats_lock = threading.Lock()  # dispatches run concurrently
        self._batches = 0
        self._batched_users = 0
        self._batched_requests = 0
        self._queue_wait_s = 0.0  # each batched request's enqueue → its batch's take
        self._dispatch_s = 0.0  # each batch's dispatch: ids joined, service call, rows split
        # Worker pool: each worker loops take_batch -> dispatch, so up to
        # `parallelism` coalesced device calls are in flight (no per-batch
        # thread churn, no semaphore leak path). Resizable at runtime
        # (set_parallelism — the TorchServe scale-workers analog): growth
        # starts threads; shrink retires surplus workers the next time they
        # look for work (in-flight dispatches always complete).
        self._live = 0     # workers currently alive (under _cond)
        self._target = 0   # desired pool size (under _cond)
        self._worker_seq = 0
        self.set_parallelism(parallelism)

    def set_parallelism(self, n: int) -> int:
        """Resize the dispatch worker pool at runtime; returns the new size."""
        n = max(1, int(n))
        with self._cond:
            self._target = n
            while self._live < self._target:
                self._worker_seq += 1
                t = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"serve-batcher-{self._worker_seq}",
                )
                # Count the worker live only once it actually started: a
                # failed start() (thread exhaustion) would otherwise leave a
                # phantom _live count that makes a REAL worker retire later.
                t.start()
                self._live += 1
            # Surplus workers blocked in take_batch wake and retire.
            self._cond.notify_all()
        return n

    @property
    def parallelism(self) -> int:
        with self._cond:
            return self._target

    # -- request side -------------------------------------------------------
    def recommend(self, user_ids, k: int | None = None) -> np.ndarray:
        if k is not None and k != self.service.k:
            return self.service.recommend(user_ids, k=k)  # solo path
        # Validate BEFORE enqueueing (shared definition with the service):
        # a bad id must fail only its own request, never a shared batch.
        from .service import validate_user_ids

        ids = validate_user_ids(user_ids, self.service.prepared.n_users)
        if len(ids) >= self.solo_min:
            return self.service.recommend(ids)  # already an efficient batch
        p = _Pending(ids, None)
        with self._cond:
            self._pending.append(p)
            self._cond.notify()
        p.event.wait()
        if p.error is not None:
            # Fresh exception per rider: concurrently re-raising the ONE
            # shared instance from several handler threads races on its
            # __traceback__ and garbles the logged stacks.
            raise RuntimeError(
                f"batched request failed: "
                f"{type(p.error).__name__}: {p.error}"
            ) from p.error
        return p.result

    # -- collector side -----------------------------------------------------
    def _take_batch(self) -> list[_Pending] | None:
        """Next coalesced batch, or None when this worker should retire
        (pool shrunk below the number of live workers)."""
        with self._cond:
            while True:
                if self._live > self._target:
                    self._live -= 1
                    return None
                while not self._pending:
                    self._cond.wait()
                    if self._live > self._target:
                        self._live -= 1
                        return None
                # Linger anchored to the OLDEST request's arrival: leftovers
                # from a capacity-cut batch (or requests that queued during
                # the previous device call) have already aged past the
                # window and dispatch immediately instead of paying a fresh
                # linger.
                deadline = self._pending[0].t_enq + self.max_wait_s
                while self._pending:
                    total = sum(len(p.ids) for p in self._pending)
                    remaining = deadline - time.perf_counter()
                    if total >= self.max_users or remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                if not self._pending:
                    # Another worker drained the list while this one
                    # lingered — never hand an empty batch to dispatch.
                    continue
                # Take whole requests up to the cap (never split one).
                batch, total = [], 0
                for p in self._pending:
                    if batch and total + len(p.ids) > self.max_users:
                        break
                    batch.append(p)
                    total += len(p.ids)
                del self._pending[: len(batch)]
                now = time.perf_counter()
                wait = sum(now - p.t_enq for p in batch)
                with self._stats_lock:
                    self._queue_wait_s += wait
                return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return  # retired by set_parallelism
            self._dispatch(batch)

    def _dispatch(self, batch):
        n_users = 0
        t0 = time.perf_counter()
        try:
            ids = np.concatenate([p.ids for p in batch])
            n_users = len(ids)
            out = self.service.recommend(ids)
            lo = 0
            for p in batch:
                p.result = out[lo : lo + len(p.ids)]
                lo += len(p.ids)
        except Exception as e:  # pragma: no cover - device failure
            for p in batch:
                p.error = e
        finally:
            seconds = time.perf_counter() - t0
            with self._stats_lock:
                self._batches += 1
                self._batched_users += n_users
                self._batched_requests += len(batch)
                self._dispatch_s += seconds
            for p in batch:
                p.event.set()

    # -- passthroughs -------------------------------------------------------
    def metrics(self) -> dict:
        m = self.service.metrics()
        with self._stats_lock:
            batches, reqs, users = (
                self._batches, self._batched_requests, self._batched_users
            )
            wait_s, dispatch_s = self._queue_wait_s, self._dispatch_s
        m.update(
            {
                "batches_total": batches,
                "batched_requests_total": reqs,
                "batched_users_total": users,
                "users_per_batch_avg": round(users / batches, 3)
                if batches
                else 0.0,
                "queue_wait_seconds_total": round(wait_s, 6),
                "dispatch_seconds_total": round(dispatch_s, 6),
            }
        )
        return m

    def stats(self) -> dict:
        return {
            **self.service.stats(),
            "batching": True,
            "max_wait_s": self.max_wait_s,
            "max_batch_users": self.max_users,
            "batch_workers": self.parallelism,
        }

    def refresh_from_checkpoint(self) -> float:
        return self.service.refresh_from_checkpoint()

    def refresh(self, params: dict) -> float:
        return self.service.refresh(params)

    def register_version(self, *args, **kwargs) -> str:
        return self.service.register_version(*args, **kwargs)

    def set_default_version(self, version: str) -> None:
        self.service.set_default_version(version)

    def unregister_version(self, version: str) -> None:
        self.service.unregister_version(version)

    def list_versions(self) -> list:
        return self.service.list_versions()

    @property
    def prepared(self):
        return self.service.prepared
