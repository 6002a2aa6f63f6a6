"""Lower precisions for the controls: the reference computed one step below
the precision that a configuration states.

- ``TF32``: below float32 with TF32 off. Every operand rounded to TF32's
  10-bit mantissa (to nearest), the products and sums in f32: what a tensor
  core's TF32 mode does to an f32 product.
- ``FP8``: below bfloat16. The usual recipe for fp8 training: weights and
  activations in e4m3, gradients in e5m2, each tensor scaled by its own
  largest magnitude onto the format's range; products and sums in f32.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest value with a 10-bit mantissa."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` scaled by its largest magnitude onto ``dtype``'s range, rounded
    to ``dtype`` and scaled back (f32)."""
    x = x.float()
    amax = x.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class TF32:
    name = "tf32"

    weights = activations = gradients = staticmethod(round_tf32)


class FP8:
    name = "fp8"

    @staticmethod
    def weights(x):
        return round_fp8(x, torch.float8_e4m3fn)

    activations = weights

    @staticmethod
    def gradients(g):
        return round_fp8(g, torch.float8_e5m2)


CONTROLS = {"tf32": TF32, "fp8": FP8}
