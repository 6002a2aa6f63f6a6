"""BPR (user, positive, negative) mini-batch sampler on the device.

Counterpart of ``gnn_ecommerce_tpu/sampling/bpr.py``, with a
``torch.Generator`` on the device in place of a JAX key:

- users: uniform over the train-positive users, with replacement by default
  (``replace=False`` draws without replacement, as the reference's
  ``random.sample`` does);
- positives: a uniform element of the user's positive CSR row;
- negatives: an exact uniform draw over the user's ALLOWED items (all items
  minus the ignore list, train ∪ val ∪ test positives): a uniform rank r
  over the ``n_items - |ignore_u|`` allowed items is mapped through the
  sorted ignore row by a branchless 32-step bisection
  (:func:`_rank_to_allowed_item`). No rejection loop.

Ids are in the unified node space (items offset by ``+n_users``), int64.
JAX's and torch's random streams differ, so the tests hold the rank→item
map exactly and the draws by their distribution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.prepare import SamplerArrays
from ..device import resolve_device
from ..tracing import mark


@dataclasses.dataclass(frozen=True)
class BprSamplerData:
    users: torch.Tensor       # [U] int64 train-positive user ids
    pos_indptr: torch.Tensor  # [U+1] int64
    pos_flat: torch.Tensor    # [P] int64 item node ids
    ign_indptr: torch.Tensor  # [U+1] int64
    ign_flat: torch.Tensor    # [Q] int64 sorted item node ids per row
    n_users: int
    n_items: int


def make_sampler_data(
    arrays: SamplerArrays, n_users: int, n_items: int, device: str | torch.device = "cuda"
) -> BprSamplerData:
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    return BprSamplerData(
        users=put(arrays.users),
        pos_indptr=put(arrays.pos_indptr),
        pos_flat=put(arrays.pos_flat),
        ign_indptr=put(arrays.ign_indptr),
        ign_flat=put(arrays.ign_flat),
        n_users=int(n_users),
        n_items=int(n_items),
    )


def _rank_to_allowed_item(
    flat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, rank: torch.Tensor, n_users: int
) -> torch.Tensor:
    """Map a rank over ALLOWED items to its item node id.

    ``flat[lo[b]:hi[b]]`` is the sorted ignore row. The rank-r allowed id is
    ``n_users + r + k`` with k the number of ignored ids below it; the
    predicate P(k) := ``flat[lo+k-1] < n_users + r + k`` (P(0) true) is
    monotone in k, so 32 halving steps find the largest k in [0, hi-lo]
    with P(k). Each halving step is marked ``train.sample.bisect`` on a
    profiler's timeline (``tracing.mark``, not recorded): its small launches
    leave the device idle between them, and a trace names such a gap by the
    innermost span among the last few hundred host events."""
    size = max(int(flat.shape[0]), 1)
    if flat.numel() == 0:
        flat = torch.zeros(1, dtype=torch.int64, device=rank.device)
    a = torch.zeros_like(rank)
    b = hi - lo  # invariant: P(a) true, P(b + 1) false (b may equal the row length)
    for _ in range(32):
        with mark("train.sample.bisect"):
            mid = torch.div(a + b + 1, 2, rounding_mode="floor")
            idx = (lo + mid - 1).clamp(0, size - 1)
            ok = (mid == 0) | (flat[idx] < n_users + rank + mid)
            a = torch.where(ok, mid, a)
            b = torch.where(ok, b, mid - 1)
    return n_users + rank + a


def sample_batch(
    generator: torch.Generator,
    data: BprSamplerData,
    batch_size: int,
    replace: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw a BPR batch -> (users, pos_item_nodes, neg_item_nodes), each [B]
    int64 on the data's device. ``generator`` must live on that device."""
    dev = data.users.device
    num_u = data.users.shape[0]
    if replace:
        slots = torch.randint(num_u, (batch_size,), generator=generator, device=dev)
    else:
        slots = torch.randperm(num_u, generator=generator, device=dev)[:batch_size]
    users = data.users[slots]

    plo = data.pos_indptr[slots]
    pdeg = data.pos_indptr[slots + 1] - plo
    u01 = torch.rand(batch_size, generator=generator, device=dev)
    poff = torch.minimum((u01 * pdeg).long(), pdeg - 1)  # guards u01*deg rounding up to deg
    pos = data.pos_flat[plo + poff]

    ilo = data.ign_indptr[slots]
    ihi = data.ign_indptr[slots + 1]
    n_allowed = (data.n_items - (ihi - ilo)).clamp(min=1)
    u01 = torch.rand(batch_size, generator=generator, device=dev)
    rank = torch.minimum((u01 * n_allowed).long(), n_allowed - 1)
    neg = _rank_to_allowed_item(data.ign_flat, ilo, ihi, rank, data.n_users)
    # A user who ignores every item has no allowed negative, and the map
    # gives n_users + n_items, one past the last item. JAX's gathers clamp
    # that index to the last item; so does this (on the card an index out
    # of range would abort the kernel).
    neg = neg.clamp(max=data.n_users + data.n_items - 1)
    return users, pos, neg
