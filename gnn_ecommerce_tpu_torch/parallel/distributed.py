"""Multi-process bootstrap and the collectives of the mesh paths.

Counterpart of ``gnn_ecommerce_tpu/parallel/distributed.py``. The JAX
package runs one process per host and lets ``jax.distributed`` join them
into one runtime; here every shard is a process of a ``torch.distributed``
world (``parallel/mesh.py``), and the collectives that GSPMD and
``shard_map`` inserted are called by name:

| JAX | here |
|---|---|
| ``psum`` | :func:`all_reduce_sum` |
| an all-gather of row-sharded outputs | :func:`all_gather_rows` |
| GSPMD's copies of a ``model`` band over ``data`` | :func:`broadcast_rows` of its gradient |
| ``all_to_all`` | :func:`all_to_all_rows` |
| ``replicate_tree`` (an all-gather to every host) | a broadcast from rank 0 |
| ``multihost_utils`` barrier / allgather | ``dist.barrier`` / ``dist.all_gather`` |

A JAX program differentiates through its collectives; here the training
steps do so through three autograd Functions, whose backward follows from
whether the forward's input is replicated (the same on every rank, with the
same cotangent everywhere) or this rank's own:

| forward | backward |
|---|---|
| :func:`sum_partials`: an all-reduce of this rank's partial | the cotangent as it is (it is replicated) |
| :func:`sum_grads`: the identity on a replicated input | an all-reduce of each rank's partial cotangent |
| :func:`exchange_rows`: an all-to-all | the reverse all-to-all |

Their results are new tensors: nothing that autograd saved is overwritten.

The backend is NCCL for a world on ``cuda`` and gloo on ``cpu``; a caller
may ask for gloo on ``cuda`` (two ranks sharing one card), and the backend
is never switched behind its back. gloo runs every collective used here on
CUDA tensors itself (it stages them through host memory internally), so no
collective is staged by this module.

Unlike the reference's bootstrap (``distributed.py:52``, which starts a
multi-process runtime from ``process_id`` alone), a partial specification
of the world raises: the address, the world size and the rank come all
together, from the arguments or from torch's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _init_method(address: str) -> str:
    """``host:port`` becomes ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) is taken as it is."""
    return address if "://" in address else f"tcp://{address}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    force: bool = False,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Join this process to its world (idempotent; a no-op for one process).

    The world comes from ``coordinator_address`` (``host:port`` or an init
    URL), ``num_processes`` and ``process_id`` together, or else from the
    environment's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` together. Any of these without the rest of its set raises
    ``ValueError``, and so does ``force=True`` with neither set (there is no
    coordinator to detect). ``backend`` defaults to NCCL on ``cuda`` and
    gloo on ``cpu``. Returns a summary dict for logging."""
    dev = resolve_device(device)
    args = (coordinator_address, num_processes, process_id)
    env = {k: os.environ.get(k) for k in _ENV}
    spec = None
    if any(a is not None for a in args):
        if any(a is None for a in args):
            raise ValueError(
                "coordinator_address, num_processes and process_id go together; "
                f"got {dict(zip(('coordinator_address', 'num_processes', 'process_id'), args))}"
            )
        spec = (_init_method(coordinator_address), int(num_processes), int(process_id))
    elif any(v is not None for v in env.values()):
        missing = [k for k, v in env.items() if v is None]
        if missing:
            raise ValueError(f"partial torch.distributed environment: {missing} unset")
        spec = ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]))
    elif force:
        raise ValueError(
            "force=True needs a world: pass coordinator_address, num_processes "
            "and process_id, or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK"
        )
    if spec is not None and not dist.is_initialized():
        url, world, rank = spec
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("the NCCL backend needs device='cuda'")
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    initialized = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "backend": dist.get_backend() if initialized else None,
        "device": str(dev),
    }


def joined_world() -> bool:
    """Whether this process joined a torch.distributed world (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world_rank() -> tuple[int, int]:
    """(world size, rank) of the initialized torch.distributed world, or
    (1, 0) without one."""
    if joined_world():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """``psum`` over ``axis`` (``None``: the whole mesh), in place; returns
    ``t``. The identity on a mesh with no world."""
    in_world, group = mesh.group(axis)
    if in_world:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) stacked along rows in
    rank order over ``axis``: [n·rows, ...]. The identity on a mesh with no
    world."""
    in_world, group = mesh.group(axis)
    if not in_world:
        return t
    n = mesh.size if axis is None else mesh.shape[axis]
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def broadcast_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` of the rank at index 0 of ``axis`` (every other coordinate
    this rank's), in place on every rank of ``axis``; returns ``t``. The
    identity on a mesh with no world."""
    in_world, group = mesh.group(axis)
    if in_world:
        coords = mesh.coords
        coords[axis] = 0
        src = int(np.ravel_multi_index([coords[a] for a in mesh.axis_names], mesh.axis_sizes))
        dist.broadcast(t, src=src, group=group)
    return t


def all_to_all_rows(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """``all_to_all`` of row blocks: ``t`` [n·rows, ...] holds one block of
    rows for each rank of ``axis`` in rank order; the result holds, in rank
    order, the block every rank addressed to this one. The identity on a
    mesh with no world."""
    in_world, group = mesh.group(axis)
    if not in_world:
        return t
    n = mesh.size if axis is None else mesh.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce_sum(t.clone(memory_format=torch.contiguous_format), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce_sum(g, ctx.mesh, ctx.axis), None, None


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = all_to_all_rows(t, mesh, axis)
        return out.clone() if out is t else out

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g, ctx.mesh, ctx.axis), None, None


def sum_partials(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Differentiable ``psum`` of this rank's partial ``t`` over ``axis``,
    for a result that every rank then uses alike: the cotangent reaches
    ``t`` unchanged (each rank's partial feeds the sum once)."""
    return _SumPartials.apply(t, mesh, axis)


def sum_grads(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """``t`` itself, a replicated tensor that this rank reads in part (its
    arcs, its rows of a batch): the backward all-reduces the ranks' partial
    cotangents over ``axis``, so that every rank gets the whole gradient."""
    return _SumGrads.apply(t, mesh, axis)


def exchange_rows(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Differentiable :func:`all_to_all_rows`: its backward sends every
    cotangent block back to the rank that sent the block."""
    return _ExchangeRows.apply(t, mesh, axis)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate_tree(tree, mesh: Mesh):
    """Make every tensor of ``tree`` (dicts, lists, tuples) rank 0's, in
    place, by a broadcast over the mesh; returns ``tree``. A checkpoint
    writer on rank 0 then writes what every rank holds."""
    in_world, group = mesh.group()
    if in_world:
        for t in _tensors(tree):
            dist.broadcast(t, src=0, group=group)
    return tree


def barrier(name: str = "barrier") -> None:
    """Cross-process synchronization point (a no-op for one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def assert_cross_host_agreement(value, name: str = "metric", atol: float = 0.0) -> None:
    """Raise ``AssertionError`` unless every rank holds the same scalar
    ``value`` (within ``atol``). Free for one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    vals = torch.cat(every)
    lo, hi = float(vals.min()), float(vals.max())
    if hi - lo > atol:
        raise AssertionError(f"cross-host disagreement on {name}: min {lo} max {hi} (atol {atol})")
