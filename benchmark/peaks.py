"""The card's published peaks and the floors of the work a layer must do.

A floor is the least time the card could take for a piece of work: the
larger of its bytes over the HBM rate and its operations over the peak of
the precision it is computed in, each input read once and each output
written once. A share of a floor (``<kernel>_roofline``, the ``mfu``
metrics) is that least time over the time measured, so it cannot pass 100%
unless the bytes or operations are counted too high.

The counts are of the logical work, never of what an implementation chooses
to do (padding, a dense operator, a head of heavy users, plans): the same
inputs give the same floor whatever runs them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit: HBM3 bandwidth, the bf16 tensor-core peak, f32 outside the
# tensor cores (TF32 is off on every f32 product of the program).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"
DTYPE_BYTES = {"bf16": 2, "f32": 4}


def floor_s(nbytes: float, ops: float, dtype: str) -> float:
    """Seconds: the larger of ``nbytes`` at the HBM rate and ``ops`` at the
    peak of ``dtype``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def share_pct(floor_seconds: float, measured_seconds: float) -> float | None:
    """The floor as a percentage of the measured time; None when nothing
    was measured."""
    if not measured_seconds or measured_seconds <= 0:
        return None
    return 100.0 * floor_seconds / measured_seconds


def chain_widths(dim: int, layers: int) -> list:
    """The right-hand widths of the item chain's products: one [I, I] x
    [I, 2·dim] product per two layers from layer 2, one [I, I] x [I, dim]
    for an odd last layer."""
    return [2 * dim if l + 1 <= layers else dim for l in range(2, layers + 1, 2)]


def chain_floor_s(n_items: int, dim: int, layers: int, dtype: str) -> float:
    """The item chain's GEMMs: each reads B_ii [I, I] in ``dtype`` once and
    its right-hand side [I, w] in ``dtype`` once, writes an f32 [I, w] once,
    and does ``2·I·I·w`` operations at the peak of ``dtype``."""
    el = DTYPE_BYTES[dtype]
    return sum(
        floor_s(n_items * n_items * el + n_items * w * (el + 4), 2.0 * n_items * n_items * w, dtype)
        for w in chain_widths(dim, layers)
    )


def spmm_floor_s(rows_read: int, arcs: int, n_out: int, dim: int) -> float:
    """A sparse product over ``arcs``: each f32 source row that an arc reads,
    read once; an int32 index and an f32 weight an arc; the f32 output of
    ``n_out`` rows written once; ``2·dim`` f32 operations an arc."""
    nbytes = rows_read * dim * 4 + arcs * 8 + n_out * dim * 4
    return floor_s(nbytes, 2.0 * arcs * dim, "f32")


def lightgcn_step_floor_s(n_nodes: int, arcs: int, dim: int, layers: int) -> float:
    """One LightGCN training step's model work: ``layers`` products of the
    normalized adjacency over all ``arcs`` (both directions) forward and
    twice that backward, at ``2·dim`` f32 operations an arc; the table and
    Adam's two moments read and written once, and the arcs read once."""
    ops = 3.0 * layers * 2.0 * arcs * dim
    nbytes = 3 * 2 * n_nodes * dim * 4 + arcs * 8
    return floor_s(nbytes, ops, "f32")


def lightgcn_forward_floor_s(n_nodes: int, arcs: int, dim: int, layers: int) -> float:
    """One full LightGCN forward: ``layers`` products of the normalized
    adjacency over all ``arcs``; the table read once, the final embedding
    written once, the arcs read once."""
    return floor_s(2 * n_nodes * dim * 4 + arcs * 8, layers * 2.0 * arcs * dim, "f32")
