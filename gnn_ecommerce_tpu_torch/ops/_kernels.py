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


class _Kernel:
    """One ``csrc/<STEM>.cu`` library: built and bound at first ``load()``.
    ``launches`` counts, per mode, the wrapper calls that launched it."""

    STEM = ""
    MODES: tuple = ()

    def __init__(self):
        self.launches = {mode: 0 for mode in self.MODES}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def load(self) -> ctypes.CDLL:
        """Build (first use) and load the library."""
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_shared_library(
                    os.path.join(_CSRC, f"{self.STEM}.cu"), self.STEM, nvcc_command()
                )
                lib = ctypes.CDLL(path)
                self._bind(lib)
                self._lib = lib
            return self._lib


class SegReduceKernel(_Kernel):
    """``csrc/segreduce.cu``: out = Â · table over a ``SegReducePlan``.

    Modes ``"float32"`` and ``"bfloat16"`` (the table's type); one call is
    one chunk pass plus one combine pass on the card.
    """

    STEM = "segreduce"
    MODES = ("float32", "bfloat16")
    MAX_DIM = 256

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.segreduce_f32, lib.segreduce_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, ptr, i64, ctypes.c_int, ptr, ptr, ptr]
            fn.restype = ctypes.c_int

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


class StreamSumKernel(_Kernel):
    """``csrc/stream_sum.cu``: the [1, D] f32 column sums of a [rows, D] bf16
    stream, zero-initialized (K3, the segment reduce's streaming floor).
    Mode ``"bfloat16"``; one call is one partial pass plus one combine pass.
    """

    STEM = "stream_sum"
    MODES = ("bfloat16",)
    MAX_DIM = 256
    # Rows per block of the partial pass: about 1,024 blocks at the main
    # configuration's 7.56M rows. A function of the row count only, so the
    # order of the sums (and the result) does not depend on the card.
    MIN_ROWS_PER_BLOCK = 256
    TARGET_BLOCKS = 1024

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fn = lib.stream_sum_bf16
        fn.argtypes = [ptr, i64, ctypes.c_int, i64, i64, ptr, ptr, ptr]
        fn.restype = ctypes.c_int

    def __call__(self, msgs: torch.Tensor) -> torch.Tensor:
        if not msgs.is_cuda:
            raise ValueError("the stream_sum kernel takes a CUDA tensor")
        if msgs.dtype != torch.bfloat16:
            raise TypeError(f"stream_sum takes bf16 rows, got {msgs.dtype}")
        if msgs.dim() != 2 or not msgs.is_contiguous() or msgs.data_ptr() % 4:
            raise ValueError("stream_sum takes a contiguous, 4-byte aligned [rows, D] tensor")
        n_rows, d = msgs.shape
        if not 0 < d <= self.MAX_DIM:
            raise ValueError(f"stream_sum supports 1 <= D <= {self.MAX_DIM}, got {d}")
        rows_per_block = max(self.MIN_ROWS_PER_BLOCK, -(-n_rows // self.TARGET_BLOCKS))
        n_blocks = -(-n_rows // rows_per_block)
        lib = self.load()
        partial = torch.empty(n_blocks, d, dtype=torch.float32, device=msgs.device)
        out = torch.empty(1, d, dtype=torch.float32, device=msgs.device)
        with torch.cuda.device(msgs.device):
            rc = lib.stream_sum_bf16(
                msgs.data_ptr(), n_rows, d, rows_per_block, n_blocks,
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"stream_sum launch failed: cudaError {rc}")
        self.launches["bfloat16"] += 1
        return out


SEGREDUCE = SegReduceKernel()
STREAM_SUM = StreamSumKernel()


def stream_sum_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3: ``msgs.float().sum(0, keepdim=True)``."""
    return msgs.float().sum(0, keepdim=True)


def stream_sum(msgs: torch.Tensor) -> torch.Tensor:
    """[1, D] f32 = Σ_rows float(msgs). A CUDA tensor launches
    ``csrc/stream_sum.cu``; only a CPU tensor takes the plain version."""
    if msgs.device.type == "cpu":
        return stream_sum_plain(msgs)
    return STREAM_SUM(msgs)
