"""Embedding-cache recommender service.

Counterpart of ``gnn_ecommerce_tpu/serve/service.py``. The graph and the
parameters are static between checkpoint refreshes, so the service
propagates once at load/refresh time and answers each request with a
matmul, a mask and a top-K against the cached final embeddings.

Propagation runs the fast bipartite forward (``ops/bipartite.py``) in its
exact f32 mode: f32 messages and no heavy-user head, so every user→item arc
goes through the CUDA segment reduce on the card. The service builds an f32
B_ii, and the chain applies it as its two sparse factors (K1 and the ELL
gather), the layered propagation's own order. The JAX service runs the
layered ``get_embedding``; the two are equal up to summation order.

With ``quantized=True`` each version also carries a
:class:`~.quantized.QuantizedCache` of its f32 cache, built after each
propagation, and requests are ranked on the int8 rows (``serve/quantized.py``).

One deliberate difference from the JAX service: each registry entry carries
a generation stamp, and a refresh writes back only if the entry it started
from is still there. The JAX ``refresh`` checks only that the version id is
still registered, so an unregister plus a re-register under the same id
during its propagation is overwritten by the stale result.
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import torch

from ..convert import params_to_torch
from ..data.artifacts import load_prepared
from ..data.prepare import PreparedData
from ..device import resolve_device
from ..eval.evaluate import recommend_users
from ..graph.build import build_graph
from ..models.lightgcn import LightGCNConfig
from ..ops.bipartite import build_fast_bipartite, fast_get_embedding
from ..tracing import span
from ..train.checkpoint import BEST_NAME, find_leaf, load_checkpoint, model_config
from .quantized import QuantizedCache


def validate_user_ids(user_ids, n_users: int) -> np.ndarray:
    """Coerce + validate request user ids (shared by the service and the
    batcher, which must reject bad ids before they can join a shared
    batch)."""
    ids = np.asarray(user_ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError(f"user_ids must be 1-D, got shape {ids.shape}")
    if ((ids < 0) | (ids >= n_users)).any():
        bad = ids[(ids < 0) | (ids >= n_users)]
        raise ValueError(f"user ids out of range [0, {n_users}): {bad[:5]}")
    return ids


class RecommenderService:
    """Holds cached final embeddings + per-user purchased-item masks on a
    device (``cuda`` unless the caller passes ``device="cpu"``)."""

    # Warm-up batch sizes (and the batcher's largest coalesced batch).
    BATCH_BUCKETS = (8, 64, 512)
    # Version-registry bound: each registered version pins a full [N, D]
    # cache on the device. Registration beyond the cap is refused.
    MAX_VERSIONS = 4

    def __init__(
        self,
        prepared: PreparedData,
        params: dict,
        cfg: LightGCNConfig,
        k: int = 20,
        mask_mode: str = "neginf",
        warm: bool = True,
        quantized: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.prepared = prepared
        self.cfg = cfg
        self.k = k
        self.mask_mode = mask_mode
        self.quantized = bool(quantized)
        self._lock = threading.Lock()
        self._req_count = 0
        self._user_count = 0
        self._req_seconds = 0.0
        # The graph is built on the host; only the operators and plans
        # derived from it go to the device (one f32 FastBipartite per graph).
        graph = build_graph(
            prepared.edge_user,
            prepared.edge_item_node,
            prepared.edge_weight,
            prepared.n_users,
            prepared.n_items,
            items_offset=True,
            device="cpu",
        )
        # no_grad, not inference_mode: the operators may also carry a
        # gradient (chip_smoke.py differentiates through this FastBipartite).
        with torch.no_grad():
            self.fast_bipartite = build_fast_bipartite(graph, fast_ops=True, device=self.device)
        # Host-side CSR of train purchases per user (LOCAL item space), for
        # request-time exclusion masks.
        s = prepared.sampler
        self._mask_users = np.asarray(s.users)
        self._mask_indptr = np.asarray(s.pos_indptr)
        self._mask_items = np.asarray(s.pos_flat) - prepared.n_users
        self._mask_width = max(1, int(np.diff(self._mask_indptr).max(initial=0)))
        # Model-version registry: each version holds its own propagated
        # cache; requests read the ACTIVE version. register / unregister /
        # set-default swap atomically under the lock. ``gen`` stamps each
        # entry so a refresh can tell its entry from a re-registration.
        self._versions: dict = {}
        self._gens = itertools.count()
        self._active: str = "1"
        self._next_version = 2
        self.refresh(params)
        self.warmup_s = 0.0
        if warm:
            # Warm every batch size before traffic; warm-up calls do not
            # count in the serving metrics.
            t0 = time.perf_counter()
            for b in self.BATCH_BUCKETS:
                self.recommend(np.zeros((b,), dtype=np.int64))
            self.warmup_s = time.perf_counter() - t0
            with self._lock:
                self._req_count = self._user_count = 0
                self._req_seconds = 0.0

    @classmethod
    def from_artifacts(
        cls,
        data_dir: str,
        checkpoint_dir: str,
        checkpoint_name: str = BEST_NAME,
        k: int = 20,
        mask_mode: str = "neginf",
        quantized: bool = False,
        device: str | torch.device = "cuda",
    ) -> "RecommenderService":
        dev = resolve_device(device)
        prepared = load_prepared(data_dir)
        leaves, meta = load_checkpoint(checkpoint_dir, checkpoint_name)
        cfg = cls._config(meta, prepared, LightGCNConfig(0))
        params = cls._checkpoint_params(leaves, meta, cfg, dev)
        svc = cls(
            prepared, params, cfg, k=k, mask_mode=mask_mode, quantized=quantized,
            device=dev,
        )
        svc.checkpoint_meta = meta
        svc._checkpoint_source = (checkpoint_dir, checkpoint_name)
        with svc._lock:
            svc._versions[svc._active]["meta"] = meta
            svc._versions[svc._active]["source"] = (checkpoint_dir, checkpoint_name)
        return svc

    @staticmethod
    def _config(meta: dict, prepared: PreparedData, default: LightGCNConfig) -> LightGCNConfig:
        return model_config(meta, prepared.n_users + prepared.n_items, default)

    @staticmethod
    def _checkpoint_params(leaves, meta, cfg: LightGCNConfig, device) -> dict:
        """The embedding, located by name through the keyed leaf manifest."""
        emb = find_leaf(leaves, meta, "embedding")
        if emb.shape != (cfg.num_nodes, cfg.embedding_dim):
            raise ValueError(
                f"checkpoint embedding {emb.shape} != "
                f"{(cfg.num_nodes, cfg.embedding_dim)}"
            )
        return params_to_torch({"embedding": emb}, device)

    def refresh_from_checkpoint(self) -> float:
        """Reload the checkpoint the ACTIVE version came from and
        re-propagate."""
        with self._lock:
            active = self._active
            ver = self._versions.get(active)
            source = (ver["source"] if ver else None) or getattr(
                self, "_checkpoint_source", None
            )
            cfg = ver["cfg"] if ver else self.cfg
        if source is None:
            raise RuntimeError(
                "service was not built from a checkpoint directory "
                "(use from_artifacts, or call refresh(params) directly)"
            )
        leaves, meta = load_checkpoint(*source)
        # Pinned to the version captured above: a concurrent set-default
        # must not make another version serve this checkpoint's embeddings.
        secs = self.refresh(
            self._checkpoint_params(leaves, meta, cfg, self.device), version=active
        )
        with self._lock:
            if active in self._versions:
                self._versions[active]["meta"] = meta
            if self._active == active:
                self.checkpoint_meta = meta
        return secs

    def _build_cache(self, params: dict, cfg: LightGCNConfig):
        """The fast f32 forward over this graph's FastBipartite, and its
        quantized view when the service is quantized: (emb, qcache). The
        two are the spans ``serve.refresh.propagate`` and
        ``serve.refresh.cache``, in a registration too."""
        with torch.inference_mode():
            with span("serve.refresh.propagate"):
                emb = fast_get_embedding(params, self.fast_bipartite, cfg.num_layers,
                                         alpha=cfg.alphas(params["embedding"].device))
            with span("serve.refresh.cache"):
                qcache = QuantizedCache(emb, self.prepared.n_users) if self.quantized else None
                if emb.is_cuda:
                    torch.cuda.synchronize(emb.device)
        return emb, qcache

    @property
    def final_emb(self) -> torch.Tensor:
        with self._lock:
            return self._versions[self._active]["emb"]

    def refresh(self, params: dict, version: str | None = None) -> float:
        """(Re)propagate and swap one version's cached final embeddings
        (default: the version active at call time); returns seconds.

        The target id, its cfg and its generation are captured under the
        lock before the (unlocked) propagation, and the result is written
        back to that same entry. If the entry was unregistered, or replaced
        by a new registration, while the propagation ran, the result is
        dropped. The call is the span ``serve.refresh``, parent of
        ``serve.refresh.propagate``, ``.cache`` and ``.swap``."""
        with span("serve.refresh"):
            t0 = time.perf_counter()
            with self._lock:
                target = version if version is not None else self._active
                ver = self._versions.get(target)
                cfg = ver["cfg"] if ver else self.cfg
                meta = (ver["meta"] if ver else getattr(self, "checkpoint_meta", {})) or {}
                source = ver["source"] if ver else getattr(self, "_checkpoint_source", None)
            emb, qcache = self._build_cache(params, cfg)
            with span("serve.refresh.swap"), self._lock:
                current = self._versions.get(target)
                if ver is not None and (current is None or current["gen"] != ver["gen"]):
                    self.last_refresh_s = time.perf_counter() - t0
                    return self.last_refresh_s
                self._versions[target] = {
                    "emb": emb,
                    "qcache": qcache,
                    "meta": meta,
                    "source": source,
                    "cfg": cfg,
                    "gen": next(self._gens),
                }
            self.last_refresh_s = time.perf_counter() - t0
            return self.last_refresh_s

    def register_version(
        self,
        checkpoint_dir: str,
        checkpoint_name: str = BEST_NAME,
        version: str | None = None,
        set_default: bool = True,
    ) -> str:
        """Load a checkpoint as a NEW model version (its own propagated
        cache), warm it, and optionally make it the default atomically. The
        old version stays registered for rollback. Cheap rejections
        (duplicate id, registry full) happen before the checkpoint load."""
        with self._lock:
            self._check_register_locked(version)
        leaves, meta = load_checkpoint(checkpoint_dir, checkpoint_name)
        cfg = self._config(meta, self.prepared, self.cfg)
        params = self._checkpoint_params(leaves, meta, cfg, self.device)
        t0 = time.perf_counter()
        emb, qcache = self._build_cache(params, cfg)
        self._warm_version(emb, qcache)
        with self._lock:
            self._check_register_locked(version)  # may have raced another
            if version is None:
                # Skip ids taken by explicit registrations.
                while str(self._next_version) in self._versions:
                    self._next_version += 1
                version = str(self._next_version)
                self._next_version += 1
            self._versions[version] = {
                "emb": emb,
                "qcache": qcache,
                "meta": meta,
                "source": (checkpoint_dir, checkpoint_name),
                "cfg": cfg,
                "gen": next(self._gens),
            }
            if set_default:
                self._activate_locked(version)
        self.last_refresh_s = time.perf_counter() - t0
        return version

    def _check_register_locked(self, version: str | None) -> None:
        if version is not None and version in self._versions:
            raise ValueError(f"version {version!r} already registered")
        if len(self._versions) >= self.MAX_VERSIONS:
            raise ValueError(
                f"version registry full ({self.MAX_VERSIONS}); each version "
                "pins a full device cache — unregister an idle one first"
            )

    def _warm_version(self, emb: torch.Tensor, qcache: QuantizedCache | None) -> None:
        """Run every batch bucket against a not-yet-active version's cache
        before it can take traffic."""
        for b in self.BATCH_BUCKETS:
            ids = np.zeros((b,), dtype=np.int64)
            self._rank(emb, qcache, ids, self._request_mask(ids), self.k)

    def _rank(self, emb, qcache, ids: np.ndarray, mask: np.ndarray, k: int) -> np.ndarray:
        """Top-K local item ids from one version's cache: the int8 rows when
        it has a quantized view, else the f32 rows."""
        with torch.inference_mode():
            if qcache is not None:
                return qcache.recommend(ids, mask, k=k)
            return recommend_users(
                emb, ids, mask, self.prepared.n_users, k=k, mask_mode=self.mask_mode
            )

    def _activate_locked(self, version: str) -> None:
        v = self._versions[version]
        self._active = version
        self.cfg = v["cfg"]
        self.checkpoint_meta = v["meta"]
        if v["source"] is not None:
            self._checkpoint_source = v["source"]

    def set_default_version(self, version: str) -> None:
        """Atomically route new requests to ``version`` (rollback included)."""
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown version {version!r}")
            self._activate_locked(version)

    def unregister_version(self, version: str) -> None:
        """Drop a version's cache. Refuses the ACTIVE version."""
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown version {version!r}")
            if version == self._active:
                raise ValueError(
                    f"version {version!r} is active; set another default first"
                )
            del self._versions[version]

    def list_versions(self) -> list:
        with self._lock:
            return [
                {
                    "version": vid,
                    "active": vid == self._active,
                    "epoch": (v["meta"] or {}).get("epoch"),
                    "recall": (v["meta"] or {}).get("recall"),
                    "embedding_dim": int(v["cfg"].embedding_dim),
                    "num_layers": int(v["cfg"].num_layers),
                }
                for vid, v in sorted(self._versions.items())
            ]

    def _request_mask(self, user_ids: np.ndarray) -> np.ndarray:
        """Per-request [B, M] exclusion mask (-1 padded, local item space);
        M is the service-wide max purchase count."""
        slots = np.searchsorted(self._mask_users, user_ids)
        slots = np.clip(slots, 0, len(self._mask_users) - 1)
        known = self._mask_users[slots] == user_ids
        lens = np.where(known, self._mask_indptr[slots + 1] - self._mask_indptr[slots], 0)
        out = np.full((len(user_ids), self._mask_width), -1, dtype=np.int32)
        rows = np.repeat(np.arange(len(user_ids)), lens)
        starts = np.repeat(self._mask_indptr[slots], lens)
        flat = np.arange(int(lens.sum()), dtype=np.int64)
        cols = flat - np.repeat(np.cumsum(np.append(0, lens[:-1])), lens)
        out[rows, cols] = self._mask_items[starts + cols]
        return out

    def recommend(self, user_ids, k: int | None = None) -> np.ndarray:
        """Top-K LOCAL item ids per requested (relabelled) user id."""
        t_req = time.perf_counter()
        k = k or self.k
        ids = validate_user_ids(user_ids, self.prepared.n_users)
        mask = self._request_mask(ids)
        with self._lock:
            v = self._versions[self._active]
            emb, qcache = v["emb"], v["qcache"]
        out = self._rank(emb, qcache, ids, mask, k)
        with self._lock:
            self._req_count += 1
            self._user_count += len(ids)
            self._req_seconds += time.perf_counter() - t_req
        return out

    def metrics(self) -> dict:
        """Serving counters."""
        with self._lock:
            c, u, s = self._req_count, self._user_count, self._req_seconds
        return {
            "requests_total": c,
            "users_total": u,
            "request_seconds_total": round(s, 6),
            "request_seconds_avg": round(s / c, 6) if c else 0.0,
            "last_refresh_seconds": round(self.last_refresh_s, 4),
        }

    def stats(self) -> dict:
        return {
            "n_users": int(self.prepared.n_users),
            "n_items": int(self.prepared.n_items),
            "num_edges": int(len(self.prepared.edge_user)),
            "embedding_dim": int(self.cfg.embedding_dim),
            "num_layers": int(self.cfg.num_layers),
            "k": self.k,
            "quantized": bool(self.quantized),
            "device": str(self.device),
            "last_refresh_s": round(self.last_refresh_s, 4),
            "versions": [v["version"] for v in self.list_versions()],
            "active_version": self._active,
        }
