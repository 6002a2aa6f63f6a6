"""Shared small case for the PyTorch port's parity tests.

The same numpy arcs, made from a seed, go into the JAX package and into
``gnn_ecommerce_tpu_torch`` (on the CPU, where its kernels take their plain
versions). Sizes follow ``tests/test_spmm_fast.py``: 400 users, 60 items,
about 3,000 arcs.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def small_arcs(seed: int = 3, n_u: int = 400, n_i: int = 60, e: int = 3000):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_u, e)
    i = rng.integers(0, n_i, e)
    key = np.unique(u * 64 + i)
    u, i = key // 64, key % 64
    i = np.minimum(i, n_i - 1)
    w = rng.random(len(u)).astype(np.float32) + 0.05
    return u, i, w, n_u, n_i


def graphs(u, i, w, n_u, n_i):
    """(JAX BipartiteGraph, port BipartiteGraph on the CPU) of the same arcs."""
    from gnn_ecommerce_tpu.graph import build_graph as jax_build_graph
    from gnn_ecommerce_tpu_torch.graph.build import build_graph

    return (
        jax_build_graph(u, i, w, n_u, n_i),
        build_graph(u, i, w, n_u, n_i, device="cpu"),
    )


def normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
