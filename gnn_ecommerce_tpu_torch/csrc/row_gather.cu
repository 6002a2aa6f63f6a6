// Row gather, written by hand for Hopper (sm_90a):
//
//   out[j] = table[idx[j]]      for rows of row_bytes (a multiple of 16)
//
// It replaces the Pallas kernel scripts/pallas_gather_probe.py:
// pallas_row_dma_gather (K4), which issues one async DMA per gathered row,
// k_inflight of them outstanding, each block of `chunk` rows with its
// indices staged in SMEM. The TPU could address no less than one (8, 128)
// f32 tile (4 KB) per DMA, so that probe's table is [N, 8, 128] f32. That
// minimum is not a limit on Hopper: any 16-byte-aligned row gathers at its
// own size, so the same kernel also gathers the production-shaped
// [N, 128] bf16 rows (256 B).
//
// Design: block b copies rows [b*chunk, (b+1)*chunk) (n % chunk == 0, the
// probe's rule), first staging its chunk of indices in shared memory. Each
// warp takes groups of K = k_inflight row slots. A slot is one row, or
// 32/V rows when a row's V 16-byte vectors fill fewer than 32 lanes (two
// 256-byte rows per warp pass). For each 512-byte slab of its rows the warp
// issues K 16-byte loads per lane (one from each slot, neighbouring lanes on
// neighbouring addresses) before it stores any of them: the card's version
// of K DMAs in flight. Offsets are 64-bit (the probe's tile-row output is
// 4.29 GB). Indices must lie in [0, N); the wrapper does not check them.
//
// Bound: the card must read each referenced table row once, the indices
// (4 B each), and write n*row_bytes. Reading each gathered row again, as a
// gather without reuse does, moves n*row_bytes both ways: 5.2 GB at the
// probe's [N, 128] bf16 shape (at least 1.56 ms at 3.35 TB/s) and 8.6 GB at
// its [N, 8, 128] f32 shape (2.56 ms). There is no arithmetic. A TMA-bulk
// (cp.async.bulk) version with mbarriers is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC row_gather.cu -o librow_gather.so
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 12288;  // 48 KB of staged indices

template <int K>
__global__ void __launch_bounds__(kThreads)
row_gather_rows(const uint4* __restrict__ table, const int32_t* __restrict__ idx,
                int64_t vecs, int chunk, uint4* __restrict__ out) {
  extern __shared__ int32_t idx_s[];  // [chunk]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * chunk;
  for (int i = threadIdx.x; i < chunk; i += kThreads) idx_s[i] = idx[row0 + i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarpsPerBlock = kThreads / 32;
  // Rows per slot: several when a row is narrower than a warp pass.
  const int per_slot = (vecs < 32 && 32 % vecs == 0) ? static_cast<int>(32 / vecs) : 1;
  const int lanes_per_row = 32 / per_slot;
  const int sub = lane / lanes_per_row;
  const int vl = lane - sub * lanes_per_row;
  const int rows_per_group = K * per_slot;

  for (int g0 = warp * rows_per_group; g0 < chunk; g0 += kWarpsPerBlock * rows_per_group) {
    int64_t src[K], dst[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int r = g0 + i * per_slot + sub;
      src[i] = r < chunk ? static_cast<int64_t>(idx_s[r]) * vecs : -1;
      dst[i] = (row0 + r) * vecs;
    }
    for (int64_t v0 = 0; v0 < vecs; v0 += lanes_per_row) {
      const int64_t v = v0 + vl;
      uint4 buf[K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (src[i] >= 0 && v < vecs) buf[i] = __ldg(table + src[i] + v);
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (src[i] >= 0 && v < vecs) __stcs(out + dst[i] + v, buf[i]);
    }
  }
}

template <int K>
void launch_k(const void* table, const int32_t* idx, int64_t n, int64_t vecs,
              int chunk, void* out, cudaStream_t stream) {
  row_gather_rows<K><<<static_cast<unsigned>(n / chunk), kThreads,
                       static_cast<size_t>(chunk) * sizeof(int32_t), stream>>>(
      static_cast<const uint4*>(table), idx, vecs, chunk, static_cast<uint4*>(out));
}

}  // namespace

// table: [N, row_bytes] 16-byte aligned; idx: [n] int32 in [0, N);
// out: [n, row_bytes]; n % chunk == 0; k_inflight in {4, 8, 16} (the probe's).
extern "C" int row_gather(const void* table, const int32_t* idx, int64_t n,
                          int64_t row_bytes, int k_inflight, int chunk, void* out,
                          cudaStream_t stream) {
  if (row_bytes <= 0 || row_bytes % 16 || chunk <= 0 || chunk > kMaxChunk || n % chunk)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t vecs = row_bytes / 16;
  switch (k_inflight) {
    case 4: launch_k<4>(table, idx, n, vecs, chunk, out, stream); break;
    case 8: launch_k<8>(table, idx, n, vecs, chunk, out, stream); break;
    case 16: launch_k<16>(table, idx, n, vecs, chunk, out, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
