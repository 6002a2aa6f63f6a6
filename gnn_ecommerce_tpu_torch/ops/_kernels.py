"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``_sharedlib``: gitignored, keyed by
a hash of the source) and bound with ctypes. Nothing is built or loaded at
import time. A wrapper checks its inputs, allocates the outputs with
``torch.empty``, launches on PyTorch's current stream, raises on a non-zero
``cudaGetLastError()``, and counts its launches in ``launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading

import torch

from .._sharedlib import build_shared_library
from ..device import aligned_len

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")


def nvcc_command() -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ]


def _raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_device(device: torch.device):
    """``torch.cuda.device(device)``, or no context when it is already the
    current device (the common case, and the cheaper one on the host)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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

    Modes ``"float32"`` and ``"bfloat16"`` (the table's type): one call is
    one chunk pass, plus one combine pass when the plan has rows with no
    chunk or several. ``"float32_accumulate"`` and ``"bfloat16_accumulate"``
    count the calls that add into a given output (``accumulate``) instead.
    Mode ``"cast_bf16"``: the padded bf16 table (:meth:`cast_bf16`) that the
    bf16 mode reads 16 bytes a lane.
    """

    STEM = "segreduce"
    MODES = ("float32", "bfloat16", "float32_accumulate", "bfloat16_accumulate", "cast_bf16")
    MAX_DIM = 256

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.segreduce_f32, lib.segreduce_bf16):
            fn.argtypes = [ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr, i64, i32, ptr, i64, ptr, ptr, i64, i64, ptr, ptr, i32, ptr]
            fn.restype = ctypes.c_int
        lib.segreduce_cast_bf16.argtypes = [ptr, i64, i32, i64, ptr, ptr]
        lib.segreduce_cast_bf16.restype = ctypes.c_int

    @staticmethod
    def takes_rows(table: torch.Tensor) -> bool:
        """Whether a [rows, D] table's layout is one the kernel reads: each
        row's columns contiguous, rows disjoint (any row stride >= D).
        ``table.contiguous()`` of any table is one."""
        n_rows, d = table.shape
        return (d <= 1 or table.stride(1) == 1) and (n_rows <= 1 or table.stride(0) >= d)

    @staticmethod
    def row_stride(table: torch.Tensor) -> int:
        """The row stride the kernel is given: the table's own, or D for a
        table of at most one row whose stride is less (any, then)."""
        n_rows, d = table.shape
        return table.stride(0) if n_rows > 1 or table.stride(0) >= d else d

    @classmethod
    def vector_width(cls, table: torch.Tensor) -> int:
        """Row elements a lane reads at once: 8 (16 bytes) on bf16 rows that
        all start 16-byte aligned, else 2 (bf16 pairs, float2) on rows that
        start at a multiple of their size, else 1."""
        elt = table.element_size()
        for v in (8, 2) if table.dtype == torch.bfloat16 else (2,):
            if cls.row_stride(table) % v == 0 and table.data_ptr() % (v * elt) == 0:
                return v
        return 1

    def check_layout(self, table: torch.Tensor, plan) -> int:
        """Raise on a table the kernel does not take; return its
        :meth:`vector_width`. Rows may lie at any stride of at least D
        (a padded bf16 table) but their columns must be contiguous."""
        if table.dim() != 2 or not self.takes_rows(table):
            raise ValueError("segreduce table must be [rows, D] with contiguous, disjoint rows")
        n_rows, d = table.shape
        if not 0 < d <= self.MAX_DIM:
            raise ValueError(f"segreduce supports 1 <= D <= {self.MAX_DIM}, got {d}")
        if n_rows < plan.n_src:
            raise ValueError(f"table has {n_rows} rows, the plan reads {plan.n_src}")
        return self.vector_width(table)

    def __call__(self, table: torch.Tensor, plan, accumulate: torch.Tensor | None = None) -> torch.Tensor:
        """[n_out, D] f32 from a CUDA ``table`` of f32 (exact mode) or bf16
        (bf16 mode, weights rounded to bf16) rows. With ``accumulate``, a
        contiguous [n_out, D] f32 tensor on the table's device, the kernel
        adds into it in place (rows with no arc keep their values) and
        returns it."""
        modes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        if not table.is_cuda:
            raise ValueError("the segreduce kernel takes a CUDA tensor")
        if table.dtype not in modes:
            raise TypeError(f"segreduce table must be f32 or bf16, got {table.dtype}")
        vec = self.check_layout(table, plan)
        if plan.src.device != table.device:  # the plan's tensors share one device
            raise ValueError("plan and table must be on the same device")
        d = table.shape[1]
        mode = modes[table.dtype]
        if accumulate is not None:
            if (accumulate.dtype != torch.float32 or tuple(accumulate.shape) != (plan.n_out, d)
                    or not accumulate.is_contiguous() or accumulate.device != table.device):
                raise ValueError(
                    f"segreduce accumulates into a contiguous [{plan.n_out}, {d}] f32 tensor "
                    "on the table's device"
                )
            mode += "_accumulate"
        lib = self.load()
        fn = lib.segreduce_bf16 if table.dtype == torch.bfloat16 else lib.segreduce_f32
        partial = torch.empty(plan.n_partial, d, dtype=torch.float32, device=table.device)
        out = accumulate if accumulate is not None else torch.empty(
            plan.n_out, d, dtype=torch.float32, device=table.device
        )
        with _on_device(table.device):
            rc = fn(
                table.data_ptr(), self.row_stride(table), d, vec,
                plan.src.data_ptr(), plan.w.data_ptr(), plan.dst.data_ptr(), plan.chunk_ptr.data_ptr(),
                plan.chunk_slot.data_ptr(), plan.n_chunks, plan.n_out, plan.packed.data_ptr(),
                plan.n_packed, plan.comb_rows.data_ptr(),
                plan.comb_ptr.data_ptr(), plan.comb_rows.numel(), plan.n_long, partial.data_ptr(),
                out.data_ptr(), int(accumulate is not None), _raw_stream(table.device),
            )
        if rc != 0:
            raise RuntimeError(f"segreduce launch failed: cudaError {rc}")
        self.launches[mode] += 1
        return out

    def cast_bf16(self, table: torch.Tensor, width: int) -> torch.Tensor:
        """The [n, D] bf16 view of a new [n, width] buffer (``width`` a
        multiple of 8, at least D) holding ``table.to(bfloat16)``, pad
        columns zero, from a CUDA f32 [rows, D] ``table``. The kernel reads
        contiguous rows on a 16-byte aligned base: any other table is
        copied into such rows first."""
        if not table.is_cuda:
            raise ValueError("the segreduce cast takes a CUDA tensor")
        if table.dtype != torch.float32:
            raise TypeError(f"the segreduce cast takes an f32 table, got {table.dtype}")
        if table.dim() != 2:
            raise ValueError("the segreduce cast takes a [rows, D] table")
        n_rows, d = table.shape
        if width % 8 or not 0 < d <= min(width, self.MAX_DIM):
            raise ValueError(
                f"the segreduce cast needs 0 < D <= min(width, {self.MAX_DIM}), width % 8 == 0; "
                f"got {d}, {width}"
            )
        if not table.is_contiguous() or table.data_ptr() % 16:
            table = table.clone(memory_format=torch.contiguous_format)
        lib = self.load()
        buf = torch.empty(n_rows, width, dtype=torch.bfloat16, device=table.device)
        with _on_device(table.device):
            rc = lib.segreduce_cast_bf16(
                table.data_ptr(), n_rows, d, width, buf.data_ptr(), _raw_stream(table.device),
            )
        if rc != 0:
            raise RuntimeError(f"segreduce cast launch failed: cudaError {rc}")
        self.launches["cast_bf16"] += 1
        return buf[:, :d]


class EllGatherKernel(_Kernel):
    """``csrc/ell_gather.cu``: out = Â · table over an ``EllPlan``
    (``ops/spmm_fast.py``), each output row written once.

    Modes ``"float32"`` and ``"bfloat16"`` (the table's type; weights are
    f32 in both): one call is one row pass, plus one combine pass when the
    plan splits rows (``plan.n_split_rows``)."""

    STEM = "ell_gather"
    MODES = ("float32", "bfloat16")
    MAX_DIM = 256
    MAX_BINS = 64  # the kernel keeps the bin descriptor in shared memory

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.ell_gather_f32, lib.ell_gather_bf16):
            fn.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr, i32, i64, i64, i32, ptr, ptr, ptr]
            fn.restype = ctypes.c_int

    @staticmethod
    def takes_rows(table: torch.Tensor) -> bool:
        """Whether the kernel reads ``table`` as it is: a [rows, D] f32 or
        bf16 table of contiguous columns whose rows start 16-byte aligned and
        whose storage holds each row's last 16-byte vector whole (a lane
        reads 16 bytes; the columns past D are read and not used)."""
        if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
            return False
        n_rows, d = table.shape
        per = 16 // table.element_size()
        stride = table.stride(0)
        if (d > 1 and table.stride(1) != 1) or stride < d or stride % per or table.data_ptr() % 16:
            return False
        end = table.storage_offset() + (n_rows - 1) * stride + aligned_len(d, table.dtype)
        return n_rows == 0 or end * table.element_size() <= table.untyped_storage().nbytes()

    def __call__(self, table: torch.Tensor, plan) -> torch.Tensor:
        """[n_out, D] f32 from a CUDA ``table`` in a layout of
        :meth:`takes_rows`."""
        modes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        if not table.is_cuda:
            raise ValueError("the ell_gather kernel takes a CUDA tensor")
        if table.dtype not in modes:
            raise TypeError(f"ell_gather table must be f32 or bf16, got {table.dtype}")
        if not self.takes_rows(table):
            raise ValueError("ell_gather takes [rows, D] tables of contiguous, 16-byte aligned rows")
        d = table.shape[1]
        if not 0 < d <= self.MAX_DIM:
            raise ValueError(f"ell_gather supports 1 <= D <= {self.MAX_DIM}, got {d}")
        if plan.order.device != table.device:  # the plan's tensors share one device
            raise ValueError("plan and table must be on the same device")
        n_bins = plan.bins.shape[0]
        if n_bins > self.MAX_BINS:
            raise ValueError(f"ell_gather takes at most {self.MAX_BINS} bins, the plan has {n_bins}")
        mode = modes[table.dtype]
        lib = self._lib or self.load()
        fn = lib.ell_gather_bf16 if mode == "bfloat16" else lib.ell_gather_f32
        out = torch.empty(plan.n_out, d, dtype=torch.float32, device=table.device)
        partial = None
        if plan.n_segments:
            partial = torch.empty(plan.n_segments, d, dtype=torch.float32, device=table.device)
        with _on_device(table.device):
            rc = fn(
                table.data_ptr(), table.stride(0), d, plan.idx_flat.data_ptr(),
                plan.w_flat.data_ptr(), plan.order.data_ptr(), plan.bins.data_ptr(), n_bins,
                plan.n_work, plan.n_split_rows, plan.split_arcs,
                None if partial is None else partial.data_ptr(), out.data_ptr(),
                _raw_stream(table.device),
            )
        if rc != 0:
            raise RuntimeError(f"ell_gather launch failed: cudaError {rc}")
        self.launches[mode] += 1
        return out


class IntentGatherKernel(_Kernel):
    """``csrc/intent_gather.cu``: DGCF's intent-weighted gather-sum over an
    ``IntentPlan`` (``ops/routing.py``): ``out[h, k-chunk] = Σ_arcs w[a, k]
    · x[src_a, k-chunk]``, each output row written once.

    Modes ``"float32"`` and ``"bfloat16"`` (the table's type; weights are
    f32 in both): one call is one row pass, plus one combine pass when the
    plan splits rows (``plan.n_split_rows``)."""

    STEM = "intent_gather"
    MODES = ("float32", "bfloat16")
    MAX_DIM = 256
    MAX_INTENTS = 8

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.intent_gather_f32, lib.intent_gather_bf16):
            fn.argtypes = [ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr, i64, ptr, ptr, ptr]
            fn.restype = ctypes.c_int

    def __call__(self, table: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
        """[n_out, D] f32 from a CUDA ``table`` in a layout of
        ``ELL_GATHER.takes_rows`` (16-byte rows) and the arcs' weights ``w``
        [E, K] f32, contiguous (arc-major), on the table's device."""
        modes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        if table.dtype not in modes:
            raise TypeError(f"intent_gather table must be f32 or bf16, got {table.dtype}")
        if not EllGatherKernel.takes_rows(table):
            raise ValueError("intent_gather takes [rows, D] tables of contiguous, 16-byte aligned rows")
        d = table.shape[1]
        per = 16 // table.element_size()
        if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous() or w.shape[0] != plan.n_arcs:
            raise ValueError(f"intent_gather takes contiguous [{plan.n_arcs}, K] f32 weights")
        k = w.shape[1]
        if not (0 < d <= self.MAX_DIM and 0 < k <= self.MAX_INTENTS and d % k == 0 and (d // k) % per == 0):
            raise ValueError(
                f"intent_gather needs D <= {self.MAX_DIM}, K <= {self.MAX_INTENTS} and D / K a multiple of "
                f"{per} ({table.dtype}); got D {d}, K {k}"
            )
        if not table.is_cuda:
            raise ValueError("the intent_gather kernel takes a CUDA tensor")
        if plan.src.device != table.device or w.device != table.device:
            raise ValueError("plan, weights and table must be on the same device")
        mode = modes[table.dtype]
        lib = self._lib or self.load()
        fn = lib.intent_gather_bf16 if mode == "bfloat16" else lib.intent_gather_f32
        out = torch.empty(plan.n_out, d, dtype=torch.float32, device=table.device)
        partial = None
        if plan.n_split_rows:
            partial = torch.empty(plan.n_partial, d, dtype=torch.float32, device=table.device)
        with _on_device(table.device):
            rc = fn(
                table.data_ptr(), table.stride(0), d, k, plan.src.data_ptr(), w.data_ptr(),
                plan.item_arc.data_ptr(), plan.item_n.data_ptr(), plan.item_dest.data_ptr(), plan.n_work,
                plan.comb_row.data_ptr(), plan.comb_ptr.data_ptr(), plan.n_split_rows,
                None if partial is None else partial.data_ptr(), out.data_ptr(), _raw_stream(table.device),
            )
        if rc != 0:
            raise RuntimeError(f"intent_gather launch failed: cudaError {rc}")
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
        with _on_device(msgs.device):
            rc = lib.stream_sum_bf16(
                msgs.data_ptr(), n_rows, d, rows_per_block, n_blocks,
                partial.data_ptr(), out.data_ptr(), _raw_stream(msgs.device),
            )
        if rc != 0:
            raise RuntimeError(f"stream_sum launch failed: cudaError {rc}")
        self.launches["bfloat16"] += 1
        return out


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the {name} kernel takes CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: every tensor must be on one device")


class TileSegReduceKernel(_Kernel):
    """``csrc/tile_segreduce.cu`` (K2): the probe's tiled segment reduce over
    a chunk plan into [n_tiles·OT, D] f32. Modes ``"float32"`` and
    ``"bfloat16"`` (the messages' type); one call is one tile pass, plus one
    combine pass when a tile's chunks are split over several blocks."""

    STEM = "tile_segreduce"
    MODES = ("float32", "bfloat16")
    MAX_DIM = 128
    MAX_SHARED_BYTES = 232_448  # the most dynamic shared memory a block can have
    TWO_BLOCKS_SHARED_BYTES = 115_712  # each of two blocks on one SM (1 KB each reserved)
    # Blocks of the tile pass to aim for: few tiles are split over up to
    # this many blocks. A function of the plan's shape only, so the order of
    # the sums (and the result) does not depend on the card.
    TARGET_BLOCKS = 1024

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.tile_segreduce_f32, lib.tile_segreduce_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i64, i32, i32, ptr, ptr, ptr, ptr, ptr]
            fn.restype = ctypes.c_int

    def n_splits(self, n_tiles: int, n_chunks: int) -> int:
        """Blocks per tile: enough for about TARGET_BLOCKS, at most the mean
        chunks per tile."""
        if n_tiles == 0:
            return 1
        return max(1, min(-(-self.TARGET_BLOCKS // n_tiles), n_chunks // n_tiles))

    @staticmethod
    def lane_groups(d: int, vec: int) -> int:
        """Rows a warp reads at once: lane groups of D / vec lanes each."""
        return 32 // (d // vec) if d // vec <= 32 else 1

    @classmethod
    def shared_bytes(cls, band_rows: int, d: int, vec: int) -> int:
        """One tile block's shared memory (as ``csrc/tile_segreduce.cu`` lays
        it out): the band's [band_rows, D] f32 sums; two edge runs, their
        rows and the list of row starts for each of the 16·groups slices;
        scratch."""
        slots = 2 * 16 * cls.lane_groups(d, vec)
        return (band_rows + slots) * d * 4 + (2 * slots + 1) * 4 + 32 * 4 + 4 + 16 * 8 + 4 * 8

    @classmethod
    def n_bands(cls, ot: int, d: int, vec: int) -> int:
        """Row bands a tile is summed in, one block each: the fewest whose
        block fits twice in an SM's shared memory (2 at OT 512, D 80). A
        function of the plan's shape and the messages' layout only."""
        for bands in range(1, ot + 1):
            if cls.shared_bytes(-(-ot // bands), d, vec) <= cls.TWO_BLOCKS_SHARED_BYTES:
                return bands
        return ot

    @staticmethod
    def vector_width(msgs: torch.Tensor) -> int:
        """Message columns a lane reads at once: the widest of 16, 8, 4 or 2
        bytes (8/4/2/1 bf16 or 4/2/1 f32 columns) that divides both a row
        and the base address."""
        elt, d = msgs.element_size(), msgs.shape[1]
        for v in (8, 4, 2, 1):
            if v * elt <= 16 and d % v == 0 and msgs.data_ptr() % (v * elt) == 0:
                return v
        return 1

    def __call__(self, msgs, seg, tile_map, first, n_tiles: int, ot: int) -> torch.Tensor:
        modes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
        _check_cuda("tile_segreduce", msgs, seg, tile_map, first)
        if msgs.dtype not in modes:
            raise TypeError(f"tile_segreduce msgs must be f32 or bf16, got {msgs.dtype}")
        if any(t.dtype != torch.int32 for t in (seg, tile_map, first)):
            raise TypeError("tile_segreduce seg, tile_map and first must be int32")
        if msgs.dim() != 2 or not all(t.is_contiguous() for t in (msgs, seg, tile_map, first)):
            raise ValueError("tile_segreduce takes contiguous msgs [E_pad, D] and int32 arrays")
        e_pad, d = msgs.shape
        n_chunks = tile_map.numel()
        if first.numel() != n_chunks or seg.numel() != e_pad:
            raise ValueError("tile_segreduce: seg must have E_pad entries, first n_chunks")
        if n_chunks == 0 or e_pad % n_chunks:
            raise ValueError(f"E_pad {e_pad} is not a whole number of {n_chunks} chunks")
        ch = e_pad // n_chunks
        if not 0 < d <= self.MAX_DIM:
            raise ValueError(f"tile_segreduce supports 1 <= D <= {self.MAX_DIM}, got {d}")
        vec = self.vector_width(msgs)
        splits = self.n_splits(n_tiles, n_chunks)
        bands = self.n_bands(ot, d, vec)
        shared = self.shared_bytes(-(-ot // bands), d, vec)
        if shared > self.MAX_SHARED_BYTES:
            raise ValueError(
                f"tile_segreduce: OT={ot}, D={d} needs {shared} bytes of shared memory"
            )
        mode = modes[msgs.dtype]
        lib = self.load()
        out = torch.empty(n_tiles * ot, d, dtype=torch.float32, device=msgs.device)
        partial = reset = written = None
        if splits > 1:
            partial = torch.empty(n_tiles * splits * ot * d, dtype=torch.float32, device=msgs.device)
            reset = torch.empty(n_tiles * splits, dtype=torch.int32, device=msgs.device)
            written = torch.empty(n_tiles * splits * bands, dtype=torch.int32, device=msgs.device)
        fn = lib.tile_segreduce_bf16 if mode == "bfloat16" else lib.tile_segreduce_f32
        with _on_device(msgs.device):
            rc = fn(
                msgs.data_ptr(), seg.data_ptr(), tile_map.data_ptr(), first.data_ptr(),
                n_chunks, ch, ot, d, vec, n_tiles, splits, bands,
                *(None if t is None else t.data_ptr() for t in (partial, reset, written)),
                out.data_ptr(), _raw_stream(msgs.device),
            )
        if rc != 0:
            raise RuntimeError(f"tile_segreduce launch failed: cudaError {rc}")
        self.launches[mode] += 1
        return out


class RowGatherKernel(_Kernel):
    """``csrc/row_gather.cu`` (K4): ``out[j] = table[idx[j]]`` for rows of a
    multiple of 16 bytes, ``k_inflight`` rows in flight, index blocks of
    ``chunk`` rows. The kernel moves bytes; the mode is the table's type
    (``"bfloat16"``: the probe's [N, 128] rows; ``"float32"``: its
    [N, 8, 128] tile rows). Two paths, chosen by row bytes (:meth:`path`):
    ``"bulk"``, bulk-copy (TMA) row DMAs through a shared-memory ring on a
    persistent grid (:meth:`grid`), and ``"lanes"``, 16-byte lane loads and
    stores."""

    STEM = "row_gather"
    MODES = ("bfloat16", "float32")
    _MODE_OF = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    K_INFLIGHT = (4, 8, 16)  # the probe's
    MAX_CHUNK = 12_288
    # Narrower rows take the lanes path. Only 256-byte rows (lanes 2.5x
    # faster) and 4 KB rows (bulk 1% faster) were timed: the cut-over lies
    # somewhere in between, and 1 KB is not a measured point.
    BULK_MIN_ROW_BYTES = 1024
    BULK_BLOCKS_PER_SM = 4
    SHARED_BYTES_PER_SM = 232_448

    def __init__(self):
        super().__init__()
        self._sm_count = {}

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.row_gather.argtypes = [ptr, ptr, i64, i64, i32, i32, i32, i32, ptr, ptr]
        lib.row_gather.restype = ctypes.c_int

    @classmethod
    def path(cls, row_bytes: int) -> str:
        """The path that serves rows of ``row_bytes``: bulk copies for wide
        rows, lane loads for narrow ones."""
        return "bulk" if row_bytes >= cls.BULK_MIN_ROW_BYTES else "lanes"

    @staticmethod
    def bulk_index_stride(chunk: int) -> int:
        """Indices in each half of the bulk path's double buffer: a window's
        16-byte covering span (``chunk`` + 8) rounded up to a multiple of 4,
        so that the second half starts 16-byte aligned."""
        return -(-(chunk + 8) // 4) * 4

    @classmethod
    def bulk_shared_bytes(cls, k_inflight: int, row_bytes: int, chunk: int) -> int:
        """One bulk block's shared memory: the ring, the double index buffer
        and the barriers (as ``csrc/row_gather.cu`` lays it out)."""
        return k_inflight * row_bytes + 2 * cls.bulk_index_stride(chunk) * 4 + (k_inflight + 2) * 8

    @classmethod
    def grid(cls, n_index_blocks: int, sm_count: int, shared_bytes: int) -> int:
        """Persistent blocks of the bulk path: BULK_BLOCKS_PER_SM on each SM
        (fewer where their shared memory does not fit), never more than
        there are index blocks."""
        per_sm = max(1, min(cls.BULK_BLOCKS_PER_SM, cls.SHARED_BYTES_PER_SM // shared_bytes))
        return max(1, min(n_index_blocks, per_sm * sm_count))

    def _sms(self, device: torch.device) -> int:
        if device not in self._sm_count:
            self._sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
        return self._sm_count[device]

    def __call__(self, table, idx, k_inflight: int = 8, chunk: int = 1024) -> torch.Tensor:
        # Kept lean: at the probe's shapes the host time before the launch is
        # part of every one-call time.
        if k_inflight not in self.K_INFLIGHT or not 0 < chunk <= self.MAX_CHUNK:
            raise ValueError(f"row_gather: k_inflight in {self.K_INFLIGHT}, "
                             f"0 < chunk <= {self.MAX_CHUNK}")
        _check_cuda("row_gather", table, idx)
        mode = self._MODE_OF.get(table.dtype)
        if mode is None or idx.dtype != torch.int32:
            raise TypeError(f"row_gather takes a bf16 or f32 table and int32 indices, got "
                            f"{table.dtype} / {idx.dtype}")
        if table.dim() < 2 or not table.is_contiguous() or idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError("row_gather takes a contiguous [N, ...] table and [n] indices")
        row_bytes = table.stride(0) * table.element_size()
        if row_bytes % 16 or table.data_ptr() % 16:
            raise ValueError(f"row_gather rows must be 16-byte multiples, got {row_bytes} B")
        path = self.path(row_bytes)
        n = idx.numel()
        if n % chunk:
            raise ValueError(f"row_gather needs n % chunk == 0, got {n} % {chunk}")
        dev = table.device
        blocks = 0
        if path == "bulk":
            shared = self.bulk_shared_bytes(k_inflight, row_bytes, chunk)
            if shared > self.SHARED_BYTES_PER_SM:
                raise ValueError(f"row_gather: {k_inflight} rows of {row_bytes} B and chunk "
                                 f"{chunk} need {shared} bytes of shared memory")
            blocks = self.grid(n // chunk, self._sms(dev), shared)
        lib = self._lib or self.load()
        out = torch.empty((n, *table.shape[1:]), dtype=table.dtype, device=dev)
        with _on_device(dev):
            rc = lib.row_gather(
                table.data_ptr(), idx.data_ptr(), n, row_bytes, k_inflight, chunk,
                path == "bulk", blocks, out.data_ptr(), _raw_stream(dev),
            )
        if rc != 0:
            raise RuntimeError(f"row_gather launch failed: cudaError {rc}")
        self.launches[mode] += 1
        return out


class LaneGatherKernel(_Kernel):
    """``csrc/lane_gather.cu``: ``out[r, j] = tab[r, idx[j]]`` for a [d, ni]
    bf16 table. One CUDA kernel serves K5 (indices [1, n], mode ``"1xn"``)
    and K6 (indices [n/512, 512], mode ``"8x512"``): both layouts are the
    same contiguous index stream. The modes count K5's and K6's launches.

    One call launches each of two passes once (``PASSES``: a key of each
    pass's kernel symbol -> the pass): the transpose of the table into the
    [ni, dp] scratch this wrapper allocates (dp: d rounded up to 16 bytes,
    ``device.aligned_len``, so that each item's column is one aligned row), and
    the gather over windows of WINDOW indices and bands of at most
    BAND_ROWS table rows."""

    STEM = "lane_gather"
    MODES = ("1xn", "8x512")
    PASSES = {"transpose_pad": "transpose", "gather_windows": "gather"}
    WINDOW = 256
    BAND_ROWS = 128

    def _bind(self, lib: ctypes.CDLL) -> None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.lane_gather_bf16.argtypes = [ptr, i64, ctypes.c_int, ptr, i64, ptr, ptr, ptr]
        lib.lane_gather_bf16.restype = ctypes.c_int

    def __call__(self, tab, idx, layout: str) -> torch.Tensor:
        if layout not in self.MODES:
            raise ValueError(f"lane_gather layout must be one of {self.MODES}, got {layout!r}")
        _check_cuda("lane_gather", tab, idx)
        if tab.dtype != torch.bfloat16 or idx.dtype != torch.int32:
            raise TypeError(f"lane_gather takes a bf16 table and int32 indices, got "
                            f"{tab.dtype} / {idx.dtype}")
        if tab.dim() != 2 or not tab.is_contiguous() or not idx.is_contiguous():
            raise ValueError("lane_gather takes a contiguous [d, ni] table and contiguous indices")
        d, ni = tab.shape
        n = idx.numel()
        if n % 8 or idx.data_ptr() % 16:
            raise ValueError(f"lane_gather takes a 16-byte aligned multiple of 8 indices, got {n}")
        out = torch.empty(d, n, dtype=torch.bfloat16, device=tab.device)
        if n == 0:
            return out
        lib = self._lib or self.load()
        tab_t = torch.empty(ni, aligned_len(d, torch.bfloat16), dtype=torch.bfloat16, device=tab.device)
        with _on_device(tab.device):
            rc = lib.lane_gather_bf16(
                tab.data_ptr(), ni, d, idx.data_ptr(), n, tab_t.data_ptr(), out.data_ptr(),
                _raw_stream(tab.device),
            )
        if rc != 0:
            raise RuntimeError(f"lane_gather launch failed: cudaError {rc}")
        self.launches[layout] += 1
        return out


SEGREDUCE = SegReduceKernel()
ELL_GATHER = EllGatherKernel()
INTENT_GATHER = IntentGatherKernel()
STREAM_SUM = StreamSumKernel()
TILE_SEGREDUCE = TileSegReduceKernel()
ROW_GATHER = RowGatherKernel()
LANE_GATHER = LaneGatherKernel()
ALL_KERNELS = (SEGREDUCE, ELL_GATHER, INTENT_GATHER, STREAM_SUM, TILE_SEGREDUCE, ROW_GATHER, LANE_GATHER)


def launch_counts() -> dict:
    """Every kernel's launches so far, keyed ``"<stem>.<mode>"``."""
    return {f"{k.STEM}.{mode}": n for k in ALL_KERNELS for mode, n in k.launches.items()}


def stream_sum_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3: ``msgs.float().sum(0, keepdim=True)``."""
    return msgs.float().sum(0, keepdim=True)


def stream_sum(msgs: torch.Tensor) -> torch.Tensor:
    """[1, D] f32 = Σ_rows float(msgs). A CUDA tensor launches
    ``csrc/stream_sum.cu``; only a CPU tensor takes the plain version."""
    if msgs.device.type == "cpu":
        return stream_sum_plain(msgs)
    return STREAM_SUM(msgs)
