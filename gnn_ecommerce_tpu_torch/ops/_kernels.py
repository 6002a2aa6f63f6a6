"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``_sharedlib``: gitignored, keyed by
a hash of the source) and bound with ctypes. Nothing is built or loaded at
import time. A wrapper checks its inputs, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream, raises on a non-zero
``cudaGetLastError()``, and counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from .._sharedlib import build_shared_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")


def nvcc_command() -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ]


class SegReduceKernel:
    """``csrc/segreduce.cu``: out = Â · table over a ``SegReducePlan``.

    ``launches`` counts wrapper calls that launched the kernel, per mode
    (``"float32"``, ``"bfloat16"``); one call is one chunk pass plus one
    combine pass on the card.
    """

    SOURCE = os.path.join(_CSRC, "segreduce.cu")
    MAX_DIM = 256

    def __init__(self):
        self.launches = {"float32": 0, "bfloat16": 0}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """Build (first use) and load the library."""
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_shared_library(
                    self.SOURCE, "segreduce", nvcc_command()
                )
                lib = ctypes.CDLL(path)
                ptr, i64 = ctypes.c_void_p, ctypes.c_int64
                for fn in (lib.segreduce_f32, lib.segreduce_bf16):
                    fn.argtypes = [
                        ptr, ptr, ptr, ptr, i64, ptr, i64, ctypes.c_int, ptr, ptr, ptr,
                    ]
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def __call__(self, table: torch.Tensor, plan) -> torch.Tensor:
        """[n_out, D] f32 from a CUDA ``table`` of f32 (exact mode) or bf16
        (bf16 mode, weights rounded to bf16) rows."""
        modes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        if not table.is_cuda:
            raise ValueError("the segreduce kernel takes a CUDA tensor")
        if table.dtype not in modes:
            raise TypeError(f"segreduce table must be f32 or bf16, got {table.dtype}")
        if table.dim() != 2 or not table.is_contiguous():
            raise ValueError("segreduce table must be a contiguous [rows, D] tensor")
        n_rows, d = table.shape
        if not 0 < d <= self.MAX_DIM:
            raise ValueError(f"segreduce supports 1 <= D <= {self.MAX_DIM}, got {d}")
        if n_rows < plan.n_src:
            raise ValueError(f"table has {n_rows} rows, the plan reads {plan.n_src}")
        for t in (plan.src, plan.w, plan.chunk_ptr, plan.row_chunk_ptr):
            if t.device != table.device:
                raise ValueError("plan and table must be on the same device")
        mode = modes[table.dtype]
        lib = self.load()
        fn = lib.segreduce_bf16 if mode == "bfloat16" else lib.segreduce_f32
        partial = torch.empty(plan.n_chunks, d, dtype=torch.float32, device=table.device)
        out = torch.empty(plan.n_out, d, dtype=torch.float32, device=table.device)
        with torch.cuda.device(table.device):
            rc = fn(
                table.data_ptr(), plan.src.data_ptr(), plan.w.data_ptr(),
                plan.chunk_ptr.data_ptr(), plan.n_chunks,
                plan.row_chunk_ptr.data_ptr(), plan.n_out, d,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"segreduce launch failed: cudaError {rc}")
        self.launches[mode] += 1
        return out


SEGREDUCE = SegReduceKernel()
