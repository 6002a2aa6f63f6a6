"""ctypes bindings for the native host-side graph kernels.

Compiles ``graph_core.cpp`` with ``g++`` on first use (cached by source hash,
see ``_sharedlib``) and exposes numpy wrappers. Every entry point but the
CSV reader and the BFS keeps a numpy fallback for a host without a compiler
(the reader's callers fall back to the ``csv`` module, the BFS's to
``explain.paths.bfs_paths``); the B_ii build at full scale needs the native
``pair_aggregate`` (its fallback loops over users in Python).
"""
from __future__ import annotations

import ctypes
import gc
import mmap
import os
import subprocess
import threading

import numpy as np

from .._sharedlib import build_shared_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_core.cpp")
_LOCK = threading.Lock()
_STATE: dict = {}


def _load():
    """Compile (if needed) and load the shared library; None on failure."""
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        try:
            path, _ = build_shared_library(
                _SRC, "graph_core", ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
            )
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            _STATE["lib"] = None
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.groupby_edges.argtypes = [
            i64p, i64p, f64p, u8p, i64, i64, i64, i64p, i64p, f64p, u8p,
        ]
        lib.groupby_edges.restype = i64
        lib.read_events_csv.argtypes = [
            ctypes.c_void_p, i64, i64, i64, i64, i64,
            i64p, i64p, u8p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.read_events_csv.restype = i64
        lib.coo_sort_by_dst.argtypes = [i64p, i64, i64, i64p, i64p]
        lib.coo_sort_by_dst.restype = None
        lib.pair_aggregate.argtypes = [i64p, i64, i64p, f32p, i64, i64, i64p, i64p, f64p]
        lib.pair_aggregate.restype = i64
        lib.pair_count.argtypes = [i64p, i64, i64]
        lib.pair_count.restype = i64
        lib.ell_sort_by_degree.argtypes = [i64p, i64, i64p]
        lib.ell_sort_by_degree.restype = i64
        lib.ell_fill_bin.argtypes = [i64p, i32p, f32p, i64p, i64, i64, i32p, f32p]
        lib.ell_fill_bin.restype = None
        lib.bfs_batch.argtypes = [
            i64p, i64p, i64, i64p, i64, i64p, i64p, i64, i64, i64p, i64p,
        ]
        lib.bfs_batch.restype = None
        _STATE["lib"] = lib
        return lib


def coo_sort_by_dst(dst: np.ndarray, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort permutation over destinations + CSR indptr.

    Returns (order [E], indptr [num_nodes+1]); ``dst[order]`` is ascending.
    """
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    lib = _load()
    if lib is None:
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, dst + 1, 1)
        return order, np.cumsum(indptr)
    order = np.empty(len(dst), dtype=np.int64)
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    lib.coo_sort_by_dst(dst, len(dst), num_nodes, order, indptr)
    return order, indptr


def groupby_edges(
    u_codes: np.ndarray,
    i_codes: np.ndarray,
    weights: np.ndarray,
    purchased: np.ndarray,
    n_u: int,
    n_i: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate (user, item) pairs: (sum weight, any purchased), sorted by
    (user, item). Inputs are factorized integer codes. Both the native sort
    and the fallback's stable lexsort keep event order within a pair, so
    the sums are added in the same order and agree bit for bit."""
    u_codes = np.ascontiguousarray(u_codes, dtype=np.int64)
    i_codes = np.ascontiguousarray(i_codes, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    purchased = np.ascontiguousarray(purchased, dtype=np.uint8)
    n = len(u_codes)
    lib = _load()
    if lib is None:
        order = np.lexsort((i_codes, u_codes))
        us, is_, ws, ps = u_codes[order], i_codes[order], weights[order], purchased[order]
        new = np.empty(n, dtype=bool)
        new[:1] = True
        np.not_equal(us[1:], us[:-1], out=new[1:])
        new[1:] |= is_[1:] != is_[:-1]
        group = np.cumsum(new) - 1
        m = int(group[-1]) + 1 if n else 0
        out_w = np.zeros(m)
        np.add.at(out_w, group, ws)
        out_p = np.zeros(m, dtype=np.uint8)
        np.maximum.at(out_p, group, ps)
        return us[new], is_[new], out_w, out_p
    out_u = np.empty(n, dtype=np.int64)
    out_i = np.empty(n, dtype=np.int64)
    out_w = np.empty(n, dtype=np.float64)
    out_p = np.empty(n, dtype=np.uint8)
    m = lib.groupby_edges(
        u_codes, i_codes, weights, purchased, n, n_u, n_i, out_u, out_i, out_w, out_p
    )
    return out_u[:m].copy(), out_i[:m].copy(), out_w[:m].copy(), out_p[:m].copy()


def read_events_csv(
    path: str,
    user_col: str = "user_id",
    item_col: str = "item_id",
    type_col: str = "event_type",
    n_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multithreaded CSV event-log reader (native only: raises
    ``RuntimeError`` without the library). Extracts the integer user and
    item id columns and the event-type column from a CSV with any extra
    columns; rows whose ids do not parse as integers are dropped.

    Returns (user_ids int64 [N], item_ids int64 [N], event types as a numpy
    ``str`` array [N]).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph_core unavailable")
    size = os.path.getsize(path)
    if size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, dtype=str)
    # A private writable mapping: from_buffer needs a writable buffer, and
    # nothing is copied or written back (the C side only reads).
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    try:
        nl = mm.find(b"\n")
        header = mm[: nl if nl >= 0 else size].decode().strip("\r")
        cols = [c.strip().strip('"') for c in header.split(",")]
        try:
            cu, ci, ct = cols.index(user_col), cols.index(item_col), cols.index(type_col)
        except ValueError as e:
            raise ValueError(f"missing column in {cols}: {e}") from None
        off = nl + 1 if nl >= 0 else size
        body_len = size - off
        if body_len:
            body_view = np.frombuffer(mm, dtype=np.uint8, offset=off)
            cap = int((body_view == 0x0A).sum()) + 1
            del body_view
        else:
            cap = 1
        out_u = np.empty(cap, dtype=np.int64)
        out_i = np.empty(cap, dtype=np.int64)
        out_t = np.empty(cap, dtype=np.uint8)
        type_names = ctypes.create_string_buffer(32 * 64)
        n_types = ctypes.c_int64(0)
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        base = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        n = lib.read_events_csv(
            ctypes.c_void_p(base + off), body_len, cu, ci, ct, n_threads,
            out_u, out_i, out_t, type_names, ctypes.byref(n_types),
        )
    finally:
        # from_buffer holds an export on the mapping; drop it before closing.
        base = None
        gc.collect()
        mm.close()
    names = [
        type_names.raw[k * 64 : (k + 1) * 64].split(b"\0")[0].decode()
        for k in range(n_types.value)
    ]
    u, i, t = out_u[:n], out_i[:n], out_t[:n]
    ok = (u >= 0) & (i >= 0) & (t < len(names))
    lut = np.array(names + [""], dtype=str)
    return u[ok], i[ok], lut[t[ok].astype(np.int64)]


def pair_aggregate(
    indptr: np.ndarray,
    items: np.ndarray,
    weights: np.ndarray,
    n_items: int,
    max_deg: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate per-row item co-occurrence pairs into a (a, b, v) COO sorted
    by (a, b): v[a,b] = Σ_rows w_a·w_b over rows with 0 < degree ≤ max_deg."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    lib = _load()
    if lib is None:
        deg = np.diff(indptr)
        keep = (deg <= max_deg) & (deg > 0)
        a_parts, b_parts, v_parts = [], [], []
        for r in np.nonzero(keep)[0]:
            row_i = items[indptr[r] : indptr[r + 1]]
            row_w = weights[indptr[r] : indptr[r + 1]].astype(np.float64)
            a_parts.append(np.repeat(row_i, len(row_i)))
            b_parts.append(np.tile(row_i, len(row_i)))
            v_parts.append(np.outer(row_w, row_w).ravel())
        if not a_parts:
            return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0))
        a = np.concatenate(a_parts)
        b = np.concatenate(b_parts)
        v = np.concatenate(v_parts)
        order = np.lexsort((b, a))
        a, b, v = a[order], b[order], v[order]
        new = np.empty(len(a), dtype=bool)
        new[0] = True
        new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
        group = np.cumsum(new) - 1
        out_v = np.zeros(int(group[-1]) + 1)
        np.add.at(out_v, group, v)
        return a[new], b[new], out_v
    cap = int(lib.pair_count(indptr, len(indptr) - 1, max_deg))
    if cap == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0))
    out_a = np.empty(cap, dtype=np.int64)
    out_b = np.empty(cap, dtype=np.int64)
    out_v = np.empty(cap, dtype=np.float64)
    m = lib.pair_aggregate(
        indptr, len(indptr) - 1, items, weights, n_items, max_deg, out_a, out_b, out_v
    )
    return out_a[:m].copy(), out_b[:m].copy(), out_v[:m].copy()


def ell_sort_by_degree(indptr: np.ndarray) -> np.ndarray:
    """Stable sort of CSR rows by ascending degree: the row order [n_rows]."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    lib = _load()
    if lib is None:
        return np.argsort(np.diff(indptr), kind="stable")
    order = np.empty(len(indptr) - 1, dtype=np.int64)
    lib.ell_sort_by_degree(indptr, len(indptr) - 1, order)
    return order


def ell_fill_bin(
    indptr: np.ndarray, src: np.ndarray, w: np.ndarray, rows: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Densify one ELL degree bin: (ib int32 [nb, W], wb f32 [nb, W]),
    zero-padded, for CSR rows ``rows`` of degree ≤ ``width``."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    nb, width = len(rows), int(width)
    lib = _load()
    if lib is None:
        d = indptr[rows + 1] - indptr[rows]
        ib = np.zeros((nb, width), np.int32)
        wb = np.zeros((nb, width), np.float32)
        flat_rows = np.repeat(np.arange(nb), d)
        flat_cols = np.arange(int(d.sum())) - np.repeat(np.cumsum(np.append(0, d[:-1])), d)
        take = np.repeat(indptr[rows], d) + flat_cols
        ib[flat_rows, flat_cols] = src[take]
        wb[flat_rows, flat_cols] = w[take]
        return ib, wb
    ib = np.empty((nb, width), dtype=np.int32)
    wb = np.empty((nb, width), dtype=np.float32)
    lib.ell_fill_bin(indptr, src, w, rows, nb, width, ib, wb)
    return ib, wb


def available() -> bool:
    """Whether the native library compiles and loads on this host."""
    return _load() is not None


def bfs_batch(
    indptr: np.ndarray,
    indices: np.ndarray,
    sources: np.ndarray,
    target_indptr: np.ndarray,
    targets: np.ndarray,
    cutoff: int = 8,
    n_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Multithreaded per-source BFS over an undirected CSR (native only:
    raises ``RuntimeError`` without the library; ``explain.paths`` then takes
    its numpy BFS). Source ``s`` answers the targets
    ``targets[target_indptr[s]:target_indptr[s + 1]]``.

    Returns (dist [n_targets], paths [n_targets, cutoff+1]); dist -1 means
    unreachable within ``cutoff`` hops, and a path row holds dist+1 node
    ids (-1 after them)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native graph_core unavailable")
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    target_indptr = np.ascontiguousarray(target_indptr, dtype=np.int64)
    targets = np.ascontiguousarray(targets, dtype=np.int64)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    dist = np.empty(len(targets), dtype=np.int64)
    paths = np.full((len(targets), cutoff + 1), -1, dtype=np.int64)
    lib.bfs_batch(
        indptr, indices, len(indptr) - 1, sources, len(sources),
        target_indptr, targets, cutoff, n_threads, dist, paths,
    )
    return dist, paths
