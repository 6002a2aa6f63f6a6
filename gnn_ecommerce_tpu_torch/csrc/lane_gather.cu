// Lane-axis gather from a small resident table, written by hand for Hopper
// (sm_90a):
//
//   out[r, j] = tab[r, idx[j]]     tab [d, ni] bf16, idx [n] int32, out [d, n]
//
// It replaces two Pallas kernels that compute this same function:
// scripts/microbench_gather.py:t13 (K5, indices as [1, n] in blocks of
// [1, 4096]) and scripts/microbench_gather2.py:t_pallas_lane (K6, indices as
// [n/512, 512] in blocks of [8, 512], which each grid step reshapes to the
// same 4,096 consecutive indices). Both keep the whole [80, 54,571] table in
// VMEM and gather along its lane axis with take_along_axis. On the card both
// index layouts are one contiguous int32 stream, so one kernel serves both;
// the wrapper counts K5's and K6's launches apart.
//
// Where the table lives: 8.73 MB does not fit in a block's shared memory
// (227 KB), but it fits in the 50 MB L2, and one 109 KB table row fits in
// an SM's L1. Block (x, r) takes table row r and 8*256 consecutive j: each
// thread loads its 8 indices (two 16-byte loads), gathers the 8 bf16 values
// of row r and stores them as one 16-byte write, so a warp writes 512
// consecutive bytes of out's row r, coalesced along j. Blocks start in
// order of x within r, so the blocks resident at any time share one or two
// table rows, which stay in L1. (A thread that walked all d rows touched
// every row at once, so its random 2-byte reads went to L2, one 32-byte
// sector each.) Staging a row in shared memory per block is an option for a
// later version.
//
// Bound: the card must read the referenced table entries once, the indices
// (4 B each) and write d*n*2 bytes: at the probes' [80, 10,153,984] output,
// about 1.67 GB, at least about 0.50 ms at 3.35 TB/s. There is no
// arithmetic. This design reads the index stream once per table row (d
// times, 3.25 GB at that shape, from L2 or device memory).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC lane_gather.cu -o liblane_gather.so
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// bf16 values are moved as their 16-bit patterns: no conversion.
__global__ void __launch_bounds__(kThreads)
lane_gather_cols(const uint16_t* __restrict__ tab, int64_t ni,
                 const int32_t* __restrict__ idx, int64_t n, uint16_t* __restrict__ out) {
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 8;
  if (j0 >= n) return;
  const int r = blockIdx.y;
  union {
    int4 v[2];
    int32_t i[8];
  } ix;
  ix.v[0] = __ldg(reinterpret_cast<const int4*>(idx + j0));
  ix.v[1] = __ldg(reinterpret_cast<const int4*>(idx + j0) + 1);
  const uint16_t* row = tab + static_cast<int64_t>(r) * ni;
  union {
    uint4 u;
    uint16_t h[8];
  } pack;
#pragma unroll
  for (int v = 0; v < 8; ++v) pack.h[v] = __ldg(row + ix.i[v]);
  __stcs(reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * n + j0), pack.u);
}

}  // namespace

// tab: [d, ni] contiguous bf16, d <= 65535; idx: [n] int32 in [0, ni),
// n % 8 == 0, 16-byte aligned; out: [d, n] bf16, 16-byte aligned.
extern "C" int lane_gather_bf16(const void* tab, int64_t ni, int d, const int32_t* idx,
                                int64_t n, void* out, cudaStream_t stream) {
  if (d <= 0 || d > 65535 || ni <= 0 || n < 0 || n % 8 ||
      reinterpret_cast<uintptr_t>(idx) % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t threads = n / 8;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads), d);
  lane_gather_cols<<<grid, kThreads, 0, stream>>>(static_cast<const uint16_t*>(tab), ni, idx, n,
                                                  static_cast<uint16_t*>(out));
  return cudaGetLastError();
}
