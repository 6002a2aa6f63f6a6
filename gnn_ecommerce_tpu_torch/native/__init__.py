"""ctypes bindings for the native host-side graph kernels.

Compiles ``graph_core.cpp`` with ``g++`` on first use (cached by source hash,
see ``_sharedlib``) and exposes numpy wrappers. Every entry point keeps a
numpy fallback for a host without a compiler; the B_ii build at full scale
needs the native ``pair_aggregate`` (its fallback loops over users in
Python).
"""
from __future__ import annotations

import ctypes
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
                _SRC, "graph_core", ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
            )
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            _STATE["lib"] = None
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
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
