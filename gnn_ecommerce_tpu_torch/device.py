"""Device choice, the matmul precision rules and the 16-byte row rule shared
by the port.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card they raise instead of quietly running on the host.

The JAX package asks for ``Precision.HIGHEST`` on every f32 product of its
exact path and for ``preferred_element_type=float32`` on its bf16 products.
Here that is: TF32 off for every f32 matmul, and bf16 operands multiplied
into an f32 result (exact products, f32 sums). Every entry point resolves
its device through ``resolve_device``, which sets that policy once for the
process; ``mm_f32`` only checks that it still holds.

The bf16 product carries its own gradient (``_MmBf16``): ``torch.mm`` with
``out_dtype`` has no derivative, and its backward is chosen to match JAX's
gradient of ``dot(a_bf16, b_bf16, preferred_element_type=f32)``, which
rounds each operand's cotangent to bf16.

Rows that a kernel loads 16 bytes at a time, or that cuBLAS's aligned bf16
GEMMs take, start 16 bytes apart: ``aligned_len`` is that row length and
``aligned_zeros`` storage of such rows.
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


def divisor(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``device``, to divide by. On the card
    a division by a Python scalar multiplies by its reciprocal, which can
    round one ulp away from the true division that JAX and the CPU do; a
    tensor divisor divides. It is filled on the device, so making it does
    not wait for the stream (a copy from the host would)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def aligned_len(n: int, dtype: torch.dtype) -> int:
    """``n`` elements of ``dtype`` rounded up to a multiple of 16 bytes (96
    for 90 in bf16, 92 for 90 in f32)."""
    per = 16 // dtype.itemsize
    return -(-n // per) * per


def aligned_zeros(rows: int, cols: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed [rows, cols] view of [rows, ``aligned_len(cols)``] storage."""
    return torch.zeros(rows, aligned_len(cols, dtype), dtype=dtype, device=device)[:, :cols]


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
    return _MmBf16.apply(a, b)


def _mm_bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MmBf16(torch.autograd.Function):
    """bf16 ``a @ b`` into f32, with the gradient JAX takes for it:
    ``grad_b = bf16(aᵀ·g)`` and ``grad_a = bf16(g·bᵀ)``.

    JAX multiplies the f32 cotangent ``g`` by the bf16 operand in f32 and
    rounds the result to bf16. Here ``g`` is rounded to bf16 first, so the
    backward is one bf16 product with an f32 result (tensor cores on the
    card) instead of an f32 copy of the operand (12 GB for B_ii at full
    scale) and a CUDA-core GEMM; the result is rounded to bf16 as in JAX.
    The extra rounding of ``g`` (2^-9 relative per element) is held
    against ``jax.grad`` in ``tests/test_torch_train_step.py``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_bf16_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = g.to(a.dtype)
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = _mm_bf16_f32(g16, b.T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            grad_b = _mm_bf16_f32(a.T, g16).to(b.dtype)
        return grad_a, grad_b
