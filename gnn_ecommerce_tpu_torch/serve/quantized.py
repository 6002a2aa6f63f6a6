"""Int8-quantized embedding cache for serving.

Counterpart of ``gnn_ecommerce_tpu/serve/quantized.py``: the cached final
embeddings are quantized once per refresh to int8 with one scale per row
(symmetric absmax), and a request is scored by an int8 × int8 product with
int32 sums, rescaled in f32:

    q = round(clip(x / s, -127, 127)),  s = absmax(x) / 127 per row
    score[u, i] = f32(q_u · q_i) · s_u · s_i

then masked as ``ops/topk_score.py`` masks with ``"neginf"`` (the JAX
quantized path ignores the service's ``mask_mode``) and ranked by an exact
top-K. ``torch.round`` rounds half to even, as ``jnp.round`` does.

The product. On the card it is ``torch._int_mm`` (cuBLASLt's int8 GEMM),
the counterpart of XLA's ``dot_general`` with an int32 result, whose shape
rules the service's shapes break: the left operand needs more than 16 rows
(the service's batches are 8, 64 or 512 users), and the inner and output
widths must be multiples of 8 (D 90, I 54,571 at full scale); and on an
H100 cuBLASLt finds no int8 kernel for thousands of users when the item
count is 8 more than a multiple of 16 (5,464 items, the 1/10 corpus's
5,457 padded to 8). So the item rows are zero-padded (I to a multiple of
16, D to one of 8) once, when :class:`QuantizedCache` is built, and
:func:`int8_product_int_mm` pads only a request's users (to a multiple of 8
of at least 24 rows, and to the items' D); zero rows and columns add exact
zeros, and the padding is sliced off before the rescale. The plain version,
:func:`int8_product_plain`, is the f32 product of the int8 values. It is
exact: every partial sum is an integer of at most D·127² (1,451,610 at D
90) < 2²⁴, so the card's scores equal the plain ones bit for bit. On the
CPU the product takes the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import mm_f32
from ..ops.topk_score import _mask_scores

# torch._int_mm: more than 16 rows on the left, every width a multiple of
# 8; the items (cuBLASLt's m) a multiple of 16 (see above).
INT_MM_MIN_ROWS = 24
INT_MM_ALIGN = 8
INT_MM_ITEM_ALIGN = 16


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax int8 quantization -> (q [N, D] int8,
    s [N] f32)."""
    x = x.float()
    absmax = x.abs().amax(dim=1)
    # A tensor divisor: CUDA multiplies by the reciprocal of a Python scalar
    # divisor, which rounds differently from the division JAX and the CPU do.
    scale = torch.where(absmax > 0, absmax / absmax.new_tensor(127.0), torch.ones_like(absmax))
    q = torch.round(x / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    out = x.new_zeros(rows, cols)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def pad_items(item_q: torch.Tensor) -> torch.Tensor:
    """``item_q`` [I, D] zero-padded to ``torch._int_mm``'s item shape: I to
    a multiple of 16, D to one of 8 (no copy when it has that shape)."""
    n, d = item_q.shape
    return _pad_to(item_q, _round_up(n, INT_MM_ITEM_ALIGN), _round_up(d, INT_MM_ALIGN))


def int8_product_int_mm(
    user_q: torch.Tensor, item_q: torch.Tensor, n_items: int | None = None
) -> torch.Tensor:
    """``user_q @ item_q[:n_items].T`` with int32 sums through
    ``torch._int_mm``: [B, n_items] f32 (exact). ``item_q`` may come padded
    by :func:`pad_items` (rows past ``n_items`` and columns past D zero), so
    that a request pads only its user rows."""
    b = user_q.shape[0]
    n_items = item_q.shape[0] if n_items is None else n_items
    it = pad_items(item_q)
    u = _pad_to(user_q, max(_round_up(b, INT_MM_ALIGN), INT_MM_MIN_ROWS), it.shape[1])
    acc = torch._int_mm(u, it.T)  # [rows, I padded] int32; it.T is column-major
    return acc[:b, :n_items].float()


def int8_product_plain(
    user_q: torch.Tensor, item_q: torch.Tensor, n_items: int | None = None
) -> torch.Tensor:
    """The same product as the f32 product of the int8 values (exact)."""
    n_items = item_q.shape[0] if n_items is None else n_items
    return mm_f32(user_q.float(), item_q[:n_items, : user_q.shape[1]].float().T)


def int8_product(
    user_q: torch.Tensor, item_q: torch.Tensor, n_items: int | None = None
) -> torch.Tensor:
    """``torch._int_mm`` for CUDA tensors, the plain version for CPU ones."""
    if user_q.is_cuda:
        return int8_product_int_mm(user_q, item_q, n_items)
    return int8_product_plain(user_q, item_q, n_items)


def topk_scores_int8(
    user_q: torch.Tensor,  # [B, D] int8
    user_s: torch.Tensor,  # [B] f32
    item_q: torch.Tensor,  # [I, D] int8, or as pad_items pads it
    item_s: torch.Tensor,  # [I] f32
    mask_idx: torch.Tensor,  # [B, M] local item ids to exclude, -1 padded
    k: int,
    item_tile: int = 8192,  # kept for the JAX signature; unused
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over int8 embeddings with neginf masking: (scores [B, k],
    local item ids [B, k] int32)."""
    del item_tile
    scores = int8_product(user_q, item_q, item_s.shape[0]) * user_s[:, None] * item_s[None, :]
    scores = _mask_scores(scores, mask_idx.to(scores.device), "neginf")
    vals, idx = torch.topk(scores, k, dim=1)
    return vals, idx.to(torch.int32)


class QuantizedCache:
    """Quantized view of the final embeddings for the request path, on the
    embeddings' device."""

    def __init__(self, final_emb: torch.Tensor, n_users: int):
        self.n_users = n_users
        self.user_q, self.user_s = quantize_rows(final_emb[:n_users])
        self.item_q, self.item_s = quantize_rows(final_emb[n_users:])
        # The product's item operand, padded once per refresh.
        self.item_mm = pad_items(self.item_q)

    def recommend(self, user_ids, mask_idx, k: int = 20) -> np.ndarray:
        """Top-K local item ids [B, k] (int32, numpy) for ``user_ids``,
        excluding ``mask_idx`` [B, M]."""
        dev = self.user_q.device
        ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int64, device=dev)
        mask = torch.as_tensor(mask_idx, device=dev)
        _, idx = topk_scores_int8(
            self.user_q.index_select(0, ids),
            self.user_s.index_select(0, ids),
            self.item_mm,
            self.item_s,
            mask,
            k,
        )
        return idx.cpu().numpy()
