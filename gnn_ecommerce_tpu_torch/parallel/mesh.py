"""Device meshes over torch.distributed: one process per shard.

Counterpart of ``gnn_ecommerce_tpu/parallel/mesh.py``. A JAX ``Mesh`` lays
devices out on named axes and GSPMD or ``shard_map`` runs one program over
all of them. Here every shard is a process of a ``torch.distributed`` world
(rank ``r`` owns one device and one shard's data), and a mesh axis is a
process group: the ranks that differ only in their coordinate on that axis.

Ranks are laid out row-major over the axes, as ``np.reshape`` lays JAX's
devices out: on a ``(data 2, model 4)`` mesh rank 6 sits at data 1, model 2,
and its ``model`` group is ranks 4-7.

Axes (as in the JAX package):
- ``data``: BPR batches and eval users are split here;
- ``model``: the user rows of the embedding table are split here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def mesh_factorization(n_devices: int, max_model: int = 4) -> tuple[int, int]:
    """Pick (data, model) axis sizes for n devices: the largest power-of-two
    model axis up to ``max_model`` that divides n; the rest go to data."""
    model = 1
    m = 2
    while m <= max_model and n_devices % m == 0:
        model = m
        m *= 2
    return n_devices // model, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and its process group on each axis.

    ``groups`` maps an axis name to the group of the ranks that share every
    other coordinate with this one (``None`` for an axis that spans the
    world: ``dist.group.WORLD``). ``groups`` itself is None when no world is
    initialized: a one-device mesh, whose collectives are the identity, or
    a mesh made by :func:`mesh_description`, which lays one shard's data out
    on the host and refuses every collective over more than one shard.
    """

    axis_names: tuple
    axis_sizes: tuple
    rank: int
    device: torch.device
    groups: Optional[dict] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis."""
        return dict(zip(self.axis_names, np.unravel_index(self.rank, self.axis_sizes)))

    def index(self, axis: str) -> int:
        return int(self.coords[axis])

    def group(self, axis: Optional[str] = None):
        """``(in_world, group)`` for a collective over ``axis`` (``None``:
        every axis, the whole mesh): ``in_world`` is False where there is
        no world (the collective is the identity), and ``group`` None stands
        for the whole world. Raises on a mesh with no world and more than
        one shard on that axis."""
        if self.groups is None:
            if (self.size if axis is None else self.shape[axis]) > 1:
                raise RuntimeError(
                    "this mesh describes a shard on the host and has no process "
                    "group; build it with make_mesh inside an initialized world"
                )
            return False, None
        return True, (None if axis is None else self.groups[axis])


def mesh_description(
    axis_sizes: Sequence[int],
    rank: int,
    axis_names: Sequence[str] = ("data", "model"),
    device: str | torch.device = "cuda",
) -> Mesh:
    """A mesh with no process group: where ``rank`` sits among
    ``axis_sizes``. It serves to build one shard's plans and rows in any
    process (the host side of a test, a parent preparing its ranks' data)."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if not 0 <= rank < int(np.prod(axis_sizes)):
        raise ValueError(f"rank {rank} outside a mesh of {axis_sizes}")
    return Mesh(tuple(axis_names), axis_sizes, int(rank), resolve_device(device))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    device: str | torch.device = "cuda",
) -> Mesh:
    """The mesh of the initialized world (or of this process alone when no
    world is initialized, which allows only one device).

    ``n_devices`` must equal the world size: each rank is one shard. Every
    rank must call this with the same arguments, in the same order as its
    other group creations (``dist.new_group`` is collective)."""
    in_world = dist.is_initialized()
    world = dist.get_world_size() if in_world else 1
    rank = dist.get_rank() if in_world else 0
    n = n_devices or world
    if n != world:
        raise ValueError(f"requested {n} devices, the world has {world} ranks")
    if axis_sizes is None:
        axis_sizes = mesh_factorization(n)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} do not multiply to {n}")
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for axes {tuple(axis_names)}")
    groups = {} if in_world else None
    if in_world:
        ranks = np.arange(n).reshape(axis_sizes)
        for a, name in enumerate(axis_names):
            if axis_sizes[a] == n:
                groups[name] = None  # the axis spans the world
                continue
            # One group per line of ranks along this axis; every rank creates
            # every group, keeping its own.
            lines = np.moveaxis(ranks, a, -1).reshape(-1, axis_sizes[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(tuple(axis_names), axis_sizes, rank, resolve_device(device), groups)
