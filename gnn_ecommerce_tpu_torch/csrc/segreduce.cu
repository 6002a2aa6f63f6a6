// Segment reduce over item-sorted arcs, written by hand for Hopper (sm_90a):
//
//   out[i, :] = sum over arcs a with dst_a == i of  w_a * x[src_a, :]
//
// with f32 accumulation. It replaces the Pallas kernel
// gnn_ecommerce_tpu/ops/spmm_fast.py:_seg_reduce_call (the one-hot MXU
// segment reduce behind fast_to_items) and fuses the row gather that the JAX
// package runs in XLA in front of it: a warp reads x[src] itself.
//
// Modes (the element type of x):
//   float         f32 rows, f32 weights, each product rounded to f32 and
//                 summed in f32 (__fmul_rn / __fadd_rn: no FMA contraction),
//                 the arithmetic of the exact mode's msgs = x[src] * w.
//   __nv_bfloat16 bf16 rows; the weight is rounded to bf16 BEFORE the
//                 multiply, as the TPU kernel's bf16 one-hot column is
//                 (spmm_fast.py:333-336); the product is exact in f32 and
//                 summed in f32.
//
// Layout (ops/spmm_fast.py:build_segreduce_plan): arcs sorted by dst, cut
// into chunks of at most CH arcs that never cross a row; chunk_ptr holds the
// chunks' arc offsets and row_chunk_ptr each row's chunk range.
//   pass 1  one warp per chunk: lanes load 32 (src, w) pairs at a time,
//           broadcast each by shuffle, and each lane accumulates columns
//           lane, lane+32, ... in registers; the warp writes its partial row.
//   pass 2  one thread per output element sums its row's chunk partials in
//           chunk order. No atomics: the result is the same bytes every run.
// Hub items (tens of thousands of arcs) spread over many warps; an ordinary
// item (a few hundred arcs) is one or two chunks of CH=256.
//
// Bound: the card must read E*D*sizeof(T) bytes of gathered rows plus E*8
// bytes of index and weight (and write n_out*D*4). At full scale:
//   f32 over the service's 9,649,537 arcs, D=90: about 3.55 GB, at least
//   about 1.06 ms at 3.35 TB/s;
//   bf16 over the main configuration's tail of about 7.5M arcs: about
//   1.4 GB, at least about 0.42 ms.
// (Reading each table row only once, with perfect reuse across arcs, would
// move 0.66 GB in f32: at least 0.20 ms.)
// This design reads each arc's row with coalesced 4-byte (f32) or 2-byte
// (bf16) lane loads and keeps every sum in registers, so its traffic is the
// gather bound plus the partials (n_chunks*D*4 bytes written and read,
// under 2% of it at full scale), less whatever rows L2 serves again. It
// does not prefetch the index stream or pipeline the gathers (TMA,
// cp.async): rows of D=90 are 360 B (f32) or 180 B (bf16), not 16-byte
// aligned, so lane loads are scalar.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC segreduce.cu -o libsegreduce.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxColsPerLane = 8;  // D <= 256
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float arc_weight(float w, const float*) { return w; }
__device__ __forceinline__ float arc_weight(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segreduce_chunks(const T* __restrict__ x, const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const int64_t* __restrict__ chunk_ptr, int64_t n_chunks,
                 int d, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  const int64_t lo = chunk_ptr[chunk], hi = chunk_ptr[chunk + 1];

  float acc[kMaxColsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxColsPerLane; ++j) acc[j] = 0.f;

  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t left = hi - base;
    const int n = left < 32 ? static_cast<int>(left) : 32;
    int my_src = 0;
    float my_w = 0.f;
    if (lane < n) {
      my_src = src[base + lane];
      my_w = arc_weight(w[base + lane], x);
    }
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int s = __shfl_sync(kFullMask, my_src, k);
      const float wk = __shfl_sync(kFullMask, my_w, k);
      const T* row = x + static_cast<int64_t>(s) * d;
#pragma unroll
      for (int j = 0; j < kMaxColsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < d) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, load_x(row + c)));
      }
    }
  }

  float* out = partial + chunk * d;
#pragma unroll
  for (int j = 0; j < kMaxColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < d) out[c] = acc[j];
  }
}

__global__ void segreduce_combine(const float* __restrict__ partial,
                                  const int64_t* __restrict__ row_chunk_ptr,
                                  int64_t n_out, int d,
                                  float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out * d) return;
  const int64_t r = i / d;
  const int64_t c = i - r * d;
  float s = 0.f;
  for (int64_t k = row_chunk_ptr[r]; k < row_chunk_ptr[r + 1]; ++k)
    s = __fadd_rn(s, partial[k * d + c]);
  out[i] = s;
}

template <typename T>
int launch(const void* x, const int32_t* src, const float* w,
           const int64_t* chunk_ptr, int64_t n_chunks,
           const int64_t* row_chunk_ptr, int64_t n_out, int d, float* partial,
           float* out, cudaStream_t stream) {
  if (d <= 0 || d > 32 * kMaxColsPerLane) return cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segreduce_chunks<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, stream>>>(static_cast<const T*>(x), src, w,
                                       chunk_ptr, n_chunks, d, partial);
  }
  const int64_t total = n_out * d;
  if (total > 0) {
    constexpr int kThreads = 256;
    segreduce_combine<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>(partial, row_chunk_ptr, n_out,
                                               d, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int segreduce_f32(const void* x, const int32_t* src, const float* w,
                             const int64_t* chunk_ptr, int64_t n_chunks,
                             const int64_t* row_chunk_ptr, int64_t n_out, int d,
                             float* partial, float* out, cudaStream_t stream) {
  return launch<float>(x, src, w, chunk_ptr, n_chunks, row_chunk_ptr, n_out, d,
                       partial, out, stream);
}

extern "C" int segreduce_bf16(const void* x, const int32_t* src, const float* w,
                              const int64_t* chunk_ptr, int64_t n_chunks,
                              const int64_t* row_chunk_ptr, int64_t n_out,
                              int d, float* partial, float* out,
                              cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, src, w, chunk_ptr, n_chunks, row_chunk_ptr,
                               n_out, d, partial, out, stream);
}
