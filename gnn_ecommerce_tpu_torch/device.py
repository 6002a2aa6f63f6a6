"""Device choice and the matmul precision rules shared by the port.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card they raise instead of quietly running on the host.

The JAX package asks for ``Precision.HIGHEST`` on every f32 product of its
exact path and for ``preferred_element_type=float32`` on its bf16 products.
Here that is: TF32 off for every f32 matmul, and bf16 operands multiplied
into an f32 result (exact products, f32 sums). Every entry point resolves
its device through ``resolve_device``, which sets that policy once for the
process; ``mm_f32`` only checks that it still holds.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises when CUDA is
    asked for and absent. Turns TF32 off for f32 matmuls."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result: exact f32 for f32 operands; for bf16
    operands the products are exact in f32 and summed in f32 (cuBLAS with an
    f32 output on the card, upcast operands on the CPU)."""
    if a.dtype == torch.float32:
        if torch.backends.cuda.matmul.allow_tf32 or (
            torch.get_float32_matmul_precision() != "highest"
        ):
            raise RuntimeError("f32 matmuls must run without TF32")
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
