// Column sums of a bf16 row stream, written by hand for Hopper (sm_90a):
//
//   out[0, c] = sum over rows r of float(x[r, c])      (f32, zero-initialized)
//
// It replaces the Pallas kernel scripts/profile_step.py:_stream_kernel, the
// "DMA control" of the segment reduce: it reads the same bytes as the
// segment reduce's bf16 message stream and does almost no arithmetic, so its
// time is a measured streaming floor for that stream. The TPU kernel adds
// each grid step's block into its output with `+=` and never zeroes the
// output first; this kernel computes the sum that probe was meant to give,
// starting from zero.
//
// Layout: the rows are one contiguous [n_rows, d] bf16 array. Rows of d=90
// are 180 bytes, so they are 4-byte but not 16-byte aligned. When d is even a
// thread loads bf16 pairs (4 bytes); a block holds `groups` rows of d/2
// pair-columns at a time, so its threads read `groups` whole consecutive rows
// (fully coalesced) per step. With odd d it loads single values.
//   pass 1  block b sums rows [b*rows_per_block, (b+1)*rows_per_block): each
//           thread keeps its column's sum in registers over the rows of its
//           group, then the groups are added in group order through shared
//           memory and the block writes its partial row.
//   pass 2  one block per column adds the column's block partials: thread t
//           takes partials t, t+256, ... in order, then a fixed tree.
// No atomics: the same input gives the same bytes every run.
//
// Bound: it must read n_rows*d*2 bytes once (and write d*4). At the main
// configuration's 7,560,078 tail messages of d=90 that is 1.36 GB: at least
// about 0.41 ms at 3.35 TB/s. The adds (one per element) are far below the
// card's rate, so bytes bound it; the design keeps several independent loads
// in flight per thread (the row loop is unrolled) so the memory system stays
// busy. The partials are n_blocks*d*4 bytes, under 0.1% of the stream.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC stream_sum.cu -o libstream_sum.so
// The C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTargetThreads = 256;
constexpr int kCombineThreads = 256;

template <int VEC>
__device__ __forceinline__ void load_add(const __nv_bfloat16* p, float* acc) {
  if constexpr (VEC == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    acc[0] += f.x;
    acc[1] += f.y;
  } else {
    acc[0] += __bfloat162float(*p);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kTargetThreads)
stream_sum_partials(const __nv_bfloat16* __restrict__ x, int64_t n_rows, int d,
                    int64_t rows_per_block, float* __restrict__ partial) {
  extern __shared__ float sh[];  // [groups, d]
  const int cols = d / VEC;
  const int groups = blockDim.x / cols;
  const int g = threadIdx.x / cols;
  const int c = threadIdx.x - g * cols;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  if (g < groups) {
    const __nv_bfloat16* p = x + (r0 + g) * d + c * VEC;
    const int64_t step = static_cast<int64_t>(groups) * d;
#pragma unroll 8
    for (int64_t r = r0 + g; r < r1; r += groups, p += step)
      load_add<VEC>(p, acc);
#pragma unroll
    for (int v = 0; v < VEC; ++v) sh[g * d + c * VEC + v] = acc[v];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += sh[k * d + col];
    partial[static_cast<int64_t>(blockIdx.x) * d + col] = s;
  }
}

__global__ void __launch_bounds__(kCombineThreads)
stream_sum_combine(const float* __restrict__ partial, int64_t n_blocks, int d,
                   float* __restrict__ out) {
  __shared__ float sh[kCombineThreads];
  const int col = blockIdx.x;
  float s = 0.f;
  for (int64_t b = threadIdx.x; b < n_blocks; b += kCombineThreads)
    s += partial[b * d + col];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int half = kCombineThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[col] = sh[0];
}

template <int VEC>
int launch(const void* x, int64_t n_rows, int d, int64_t rows_per_block,
           int64_t n_blocks, float* partial, float* out, cudaStream_t stream) {
  const int cols = d / VEC;
  const int groups = cols >= kTargetThreads ? 1 : kTargetThreads / cols;
  const int threads = groups * cols;
  if (threads > kTargetThreads) return cudaErrorInvalidValue;
  const size_t shmem = static_cast<size_t>(groups) * d * sizeof(float);
  if (n_blocks > 0) {
    stream_sum_partials<VEC><<<static_cast<unsigned>(n_blocks), threads, shmem,
                               stream>>>(static_cast<const __nv_bfloat16*>(x),
                                         n_rows, d, rows_per_block, partial);
  }
  stream_sum_combine<<<d, kCombineThreads, 0, stream>>>(partial, n_blocks, d, out);
  return cudaGetLastError();
}

}  // namespace

// x: [n_rows, d] contiguous bf16; partial: [n_blocks, d] f32 scratch with
// n_blocks = ceil(n_rows / rows_per_block); out: [d] f32.
extern "C" int stream_sum_bf16(const void* x, int64_t n_rows, int d,
                               int64_t rows_per_block, int64_t n_blocks,
                               float* partial, float* out, cudaStream_t stream) {
  if (d <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  if (d % 2 == 0 && d / 2 <= kTargetThreads)
    return launch<2>(x, n_rows, d, rows_per_block, n_blocks, partial, out, stream);
  if (d <= kTargetThreads)
    return launch<1>(x, n_rows, d, rows_per_block, n_blocks, partial, out, stream);
  return cudaErrorInvalidValue;
}
