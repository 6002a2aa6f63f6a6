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
// into chunks of at most CH arcs that never cross a row. chunk_ptr holds the
// chunks' arc offsets; chunk_slot says where a chunk's sum goes: the output
// row itself (>= 0) when the chunk is its row's only one, else partial row
// -1 - chunk_slot. comb_rows lists the rows with no chunk or several (the
// n_long rows of more than 32 chunks first), comb_ptr each one's range of
// partial rows (its chunks, in chunk order).
//
//   pass 1  one warp per chunk, in two halves that overlap:
//           copy  the warp stages its chunk's (src, w) in shared memory,
//                 256 arcs at a time, then copies each arc's row into a
//                 shared-memory ring with 16-byte cp.async: the row's
//                 16-byte-aligned covering span (23 vectors for a 360-byte
//                 f32 row, 12 for a 192-byte padded bf16 row), so any row
//                 alignment takes whole-vector copies. A step copies
//                 32 / span rows (one f32 row, two bf16 rows), four steps
//                 make one cp.async group, and two groups are in flight
//                 while the warp sums the oldest: 8 f32 or 16 bf16 rows.
//           sum   lane (group g, vector v) owns V columns (float2 in f32,
//                 16 bytes of bf16 on rows of a 16-byte stride, bf16 pairs
//                 or single values otherwise) and adds rows g, g + groups,
//                 ... of each step from shared memory in order; at the end
//                 group k's sums are added onto group 0 for k = 1, 2, ...
//           A row with one chunk is written straight to out, otherwise the
//           chunk writes its partial row.
//   pass 2  comb row b < n_long gets a block of 8 warps: warp g adds the
//           row's partials g, g+8, ... (four loads in flight) and the block
//           adds the 8 warp sums in warp order; every other comb row gets
//           one warp that adds its partials in order. Empty rows get zeros.
// No atomics: the order of every sum is fixed by the plan and the table's
// layout, so the result is the same bytes every run.
//
// Accumulate mode (accumulate != 0): out = out + Â · x, the TPU kernel's
// `prev` (spmm_fast.py:284-292, 312-315) that chains the passes of a plan
// cut by source ranges. Every output row has exactly one writer (its only
// chunk in pass 1, else its combine in pass 2), so the mode is a flag on
// those two writes: the row's sum is added onto what out holds, and an
// empty row is left as it is instead of zeroed. Still no atomics and a
// fixed order: out[row] + (the row's sum in the order above).
//
// segreduce_cast_bf16 writes the padded bf16 table that pass 1 reads 16
// bytes a lane: out[r, c] = bf16(x[r, c]) for c < d and 0 in the pad
// columns up to the 16-byte stride, in one pass over x (32-row tiles staged
// with 16-byte cp.async, written 16 bytes a thread). x must be contiguous
// f32 rows on a 16-byte aligned base; the wrapper copies any other table
// into such rows first.
//
// Bound: the card must read E*D*sizeof(T) bytes of gathered rows plus E*8
// bytes of index and weight (and write n_out*D*4). At full scale:
//   f32 over the service's 9,649,537 arcs, D=90: 3.57 GB, at least 1.066 ms
//   at 3.35 TB/s;
//   bf16 over the main configuration's tail of 7,569,916 arcs: 1.44 GB, at
//   least 0.431 ms (the 96-column padding adds 12 bytes a row, 6.7%, that
//   the bound does not count).
// (Reading each table row only once, with perfect reuse across arcs, would
// move 0.66 GB in f32: at least 0.20 ms; that needs a schedule by source
// row ranges, which this design does not have.) The rows are gathered in
// random order, so the design aims at the gather bound: rows in flight held
// in shared memory instead of registers (so about 28 warps an SM stay
// resident), whole 16-byte copies, few instructions a row, the index in
// shared memory before the row copies that need it, and a combine whose
// long rows are spread over a block. A 360-byte f32 row still costs its
// 64-byte DRAM granules (about 1.17x its bytes); a padded bf16 row is
// exactly three.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC segreduce.cu -o libsegreduce.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxCols = 256;
constexpr int kStageBytes = 512;               // one 16-byte copy per lane
constexpr int kBatchBytes = 4 * kStageBytes;   // one cp.async group
constexpr int kBatches = 2;                    // groups in flight per warp
constexpr int kRingBytes = kBatches * kBatchBytes;
constexpr int kIndexWindow = 256;              // arcs whose (src, w) a warp stages
constexpr int kCombineWarps = 8;
constexpr int kCombineUnroll = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// The raw type of one lane read of V row elements, and its f32 values.
template <typename T, int V> struct Raw;
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };

// bf16 bits to f32 (exact): the bf16 is the f32's top half.
__device__ __forceinline__ float lo_bf16(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void to_float(float r, float* f) { f[0] = r; }
__device__ __forceinline__ void to_float(float2 r, float* f) { f[0] = r.x; f[1] = r.y; }
__device__ __forceinline__ void to_float(unsigned short r, float* f) { f[0] = lo_bf16(r); }
__device__ __forceinline__ void to_float(unsigned int r, float* f) {
  f[0] = lo_bf16(r);
  f[1] = hi_bf16(r);
}
__device__ __forceinline__ void to_float(uint4 r, float* f) {
  f[0] = lo_bf16(r.x); f[1] = hi_bf16(r.x);
  f[2] = lo_bf16(r.y); f[3] = hi_bf16(r.y);
  f[4] = lo_bf16(r.z); f[5] = hi_bf16(r.z);
  f[6] = lo_bf16(r.w); f[7] = hi_bf16(r.w);
}

template <typename T>
__device__ __forceinline__ float arc_weight(float w) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(w));
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ const char* align_down16(const char* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t{15});
}

// Pass 1. T: row type; V: elements per lane read from shared memory (its
// size divides the rows' alignment); J16: 16-byte copies per lane per row
// (ceil(nv16 / 32)); nv16: the 16-byte vectors of a row's covering span.
template <typename T, int V, int J16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segreduce_chunks(const T* __restrict__ x, int64_t stride, int d, int nv16,
                 const int32_t* __restrict__ src, const float* __restrict__ w,
                 const int64_t* __restrict__ chunk_ptr,
                 const int32_t* __restrict__ chunk_slot, int64_t n_chunks,
                 float* __restrict__ partial, float* __restrict__ out, int accumulate) {
  using R = typename Raw<T, V>::type;
  constexpr int kU = kBatchBytes / (J16 * kStageBytes);  // copy steps per batch
  constexpr int kJ = 8 / V;  // column vectors a lane may own (d <= 256)
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (chunk >= n_chunks) return;  // the whole warp leaves together
  unsigned char* my_ring = smem + warp * kRingBytes;
  int32_t* my_src = reinterpret_cast<int32_t*>(smem + kWarpsPerBlock * kRingBytes) + warp * kIndexWindow;
  float* my_w = reinterpret_cast<float*>(my_src + kWarpsPerBlock * kIndexWindow);
  const int64_t lo = chunk_ptr[chunk], hi = chunk_ptr[chunk + 1];
  const int dest = chunk_slot[chunk];
  const char* xb = reinterpret_cast<const char*>(x);
  const int64_t stride_bytes = stride * static_cast<int64_t>(sizeof(T));
  const int row_bytes = d * static_cast<int>(sizeof(T));

  // Copies: lane (cslot, cvec) copies vector cvec (+ 32 j) of the span of
  // row cslot of a step; a step carries `rows` rows, one after the other.
  const int rows = nv16 <= 32 ? 32 / nv16 : 1;
  const int cslot = nv16 <= 32 ? lane / nv16 : 0;
  const int cvec = nv16 <= 32 ? lane - cslot * nv16 : lane;
  // Sums: lane (grp, svec) owns column vectors svec + 32 j of V elements
  // and adds rows grp, grp + groups, ... of every step.
  const int n_cv = (d + V - 1) / V;
  const int groups = n_cv <= 32 ? 32 / n_cv : 1;
  const int grp = n_cv <= 32 ? lane / n_cv : 0;
  const int svec = n_cv <= 32 ? lane - grp * n_cv : lane;
  const bool summer = grp < groups;

  float acc[kJ * V];
#pragma unroll
  for (int k = 0; k < kJ * V; ++k) acc[k] = 0.f;

  for (int64_t win = lo; win < hi; win += kIndexWindow) {
    const int wn = hi - win < kIndexWindow ? static_cast<int>(hi - win) : kIndexWindow;
    __syncwarp();  // the last window's index is read
    for (int k = lane; k < wn; k += 32) {
      cp_async4(my_src + k, src + win + k);
      cp_async4(my_w + k, w + win + k);
    }
    cp_async_commit();
    cp_async_wait<0>();  // no row copy is in flight between windows
    __syncwarp();
    const int per_batch = kU * rows;  // arcs a batch carries
    const int n_batches = (wn + per_batch - 1) / per_batch;
    // Batch b's copies into its ring slot, committed as one group (an
    // empty group past the last batch keeps the count of groups in order).
    auto start_copies = [&](int b) {
      unsigned char* slot = my_ring + (b % kBatches) * kBatchBytes;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = (b * kU + u) * rows + cslot;
        if (cslot < rows && k < wn) {
          const char* row = xb + static_cast<int64_t>(my_src[k]) * stride_bytes;
          const char* first = align_down16(row);
          const int count = static_cast<int>((align_down16(row + row_bytes - 1) - first) / 16) + 1;
          unsigned char* stage = slot + u * (J16 * kStageBytes) + cslot * nv16 * 16;
#pragma unroll
          for (int j = 0; j < J16; ++j) {
            const int v = cvec + 32 * j;
            if (v < count) cp_async16(stage + v * 16, first + v * 16);
          }
        }
      }
      cp_async_commit();
    };
    for (int b = 0; b < kBatches - 1; ++b) start_copies(b);
    for (int b = 0; b < n_batches; ++b) {
      start_copies(b + kBatches - 1);
      cp_async_wait<kBatches - 1>();  // batch b has landed
      __syncwarp();
      const unsigned char* slot = my_ring + (b % kBatches) * kBatchBytes;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!summer) break;
        for (int i = grp; i < rows; i += groups) {
          const int k = (b * kU + u) * rows + i;
          if (k >= wn) break;
          const char* row = xb + static_cast<int64_t>(my_src[k]) * stride_bytes;
          const unsigned char* base = slot + u * (J16 * kStageBytes) + i * nv16 * 16 +
                                      (reinterpret_cast<uintptr_t>(row) & 15);
          const float wk = arc_weight<T>(my_w[k]);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int cv = svec + 32 * j;
            if (cv < n_cv) {
              float f[V];
              to_float(*reinterpret_cast<const R*>(base + cv * V * sizeof(T)), f);
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[j * V + e] = __fadd_rn(acc[j * V + e], __fmul_rn(wk, f[e]));
            }
          }
        }
      }
      __syncwarp();  // ring slot b % kBatches is refilled by the next start_copies
    }
  }
  cp_async_wait<0>();

  // Group g's sums onto group 0's lanes, g = 1, 2, ... in order.
  if (groups > 1) {
#pragma unroll
    for (int e = 0; e < kJ * V; ++e) {
      float s = acc[e];
      for (int g = 1; g < groups; ++g)
        s = __fadd_rn(s, __shfl_sync(kFullMask, acc[e], (lane + g * n_cv) & 31));
      acc[e] = s;
    }
  }
  if (grp != 0) return;
  float* o = dest >= 0 ? out + static_cast<int64_t>(dest) * d
                       : partial + static_cast<int64_t>(-1 - dest) * d;
  const bool onto = accumulate && dest >= 0;  // partial rows are always written
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = (svec + 32 * j) * V + e;
      if (c < d) o[c] = onto ? __fadd_rn(o[c], acc[j * V + e]) : acc[j * V + e];
    }
  }
}

// Pass 2 (module comment). Blocks [0, n_long) each sum one of the first
// n_long rows of comb_rows (warps strided over its partials, then the warp
// sums in order); every later block gives each of its warps one of the
// remaining rows, whose partials the warp adds in order. C: columns per
// lane, ceil(d / 32); up to 4 columns fit 6 blocks an SM (42 registers a
// thread), 8 columns need more registers and get 3.
template <int C>
__global__ void __launch_bounds__(kCombineWarps * 32, C <= 4 ? 6 : 3)
segreduce_combine(const float* __restrict__ partial,
                  const int32_t* __restrict__ comb_rows,
                  const int64_t* __restrict__ comb_ptr, int64_t n_comb,
                  int64_t n_long, int d, float* __restrict__ out, int accumulate) {
  __shared__ float warp_sum[kCombineWarps][kMaxCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool whole_block = blockIdx.x < n_long;
  const int64_t b = whole_block ? blockIdx.x
                                : n_long + (blockIdx.x - n_long) * kCombineWarps + warp;
  if (b >= n_comb) return;  // a whole warp of the last block
  const int64_t lo = comb_ptr[b], hi = comb_ptr[b + 1];
  if (accumulate && lo == hi) return;  // an empty row keeps what out holds
  const int first = whole_block ? warp : 0, step = whole_block ? kCombineWarps : 1;
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.f;
  for (int64_t p0 = lo + first; p0 < hi; p0 += step * kCombineUnroll) {
    float v[kCombineUnroll][C];
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
      const int64_t p = p0 + u * step;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int c = lane + 32 * k;
        if (p < hi && c < d) v[u][k] = partial[p * d + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (p0 + u * step < hi && lane + 32 * k < d) acc[k] = __fadd_rn(acc[k], v[u][k]);
      }
    }
  }
  float* o = out + static_cast<int64_t>(comb_rows[b]) * d;
  if (!whole_block) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = lane + 32 * k;
      if (c < d) o[c] = accumulate ? __fadd_rn(o[c], acc[k]) : acc[k];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + 32 * k;
    if (c < d) warp_sum[warp][c] = acc[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = warp_sum[0][c];
#pragma unroll
    for (int g = 1; g < kCombineWarps; ++g) s = __fadd_rn(s, warp_sum[g][c]);
    o[c] = accumulate ? __fadd_rn(o[c], s) : s;
  }
}

// The padded bf16 table from contiguous f32 rows on a 16-byte aligned base:
// block b copies rows [32b, 32b + 32) into shared memory with 16-byte
// cp.async (all in flight at once), then writes their padded bf16 rows 16
// bytes a thread (zero past d).
constexpr int kCastRows = 32;
constexpr int kCastThreads = 256;

__global__ void __launch_bounds__(kCastThreads)
cast_bf16_tile(const float* __restrict__ x, int64_t n_rows, int d, int64_t out_stride,
               __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kCastRows;
  const int rows = n_rows - r0 < kCastRows ? static_cast<int>(n_rows - r0) : kCastRows;
  const int n = rows * d;
  const float* src = x + r0 * d;
  for (int q = threadIdx.x; 4 * q < n; q += kCastThreads) {
    if (4 * q + 4 <= n) {
      cp_async16(tile + 4 * q, src + 4 * q);
    } else {
      for (int e = 4 * q; e < n; ++e) tile[e] = src[e];
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int vecs = static_cast<int>(out_stride / 8);
  for (int o = threadIdx.x; o < rows * vecs; o += kCastThreads) {
    const int i = o / vecs, c = (o - i * vecs) * 8;
    uint4 packed;
    unsigned int* words = reinterpret_cast<unsigned int*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = c + 2 * k < d ? tile[i * d + c + 2 * k] : 0.f;
      const float b = c + 2 * k + 1 < d ? tile[i * d + c + 2 * k + 1] : 0.f;
      const __nv_bfloat162 two = __floats2bfloat162_rn(a, b);
      words[k] = *reinterpret_cast<const unsigned int*>(&two);
    }
    reinterpret_cast<uint4*>(out + (r0 + i) * out_stride)[c / 8] = packed;
  }
}

template <typename T, int V, int J16>
int launch_chunks(const void* x, int64_t stride, int d, int nv16, const int32_t* src,
                  const float* w, const int64_t* chunk_ptr, const int32_t* chunk_slot,
                  int64_t n_chunks, float* partial, float* out, int accumulate,
                  cudaStream_t stream) {
  constexpr int kSmem = kWarpsPerBlock * (kRingBytes + kIndexWindow * 8);
  static_assert(kSmem <= 48 * 1024, "more dynamic shared memory needs cudaFuncSetAttribute");
  const int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segreduce_chunks<T, V, J16><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, kSmem, stream>>>(
      static_cast<const T*>(x), stride, d, nv16, src, w, chunk_ptr, chunk_slot, n_chunks,
      partial, out, accumulate);
  return cudaSuccess;
}

template <typename T, int V>
int dispatch_j16(int nv16, const void* x, int64_t stride, int d, const int32_t* src,
                 const float* w, const int64_t* chunk_ptr, const int32_t* chunk_slot,
                 int64_t n_chunks, float* partial, float* out, int accumulate,
                 cudaStream_t stream) {
  const int j16 = (nv16 + 31) / 32;
  if (j16 == 1)
    return launch_chunks<T, V, 1>(x, stride, d, nv16, src, w, chunk_ptr, chunk_slot, n_chunks,
                                  partial, out, accumulate, stream);
  if constexpr (V * sizeof(T) < 16) {  // 16-byte aligned rows of <= 256 values span <= 32 vectors
    if (j16 == 2)
      return launch_chunks<T, V, 2>(x, stride, d, nv16, src, w, chunk_ptr, chunk_slot, n_chunks,
                                    partial, out, accumulate, stream);
    if constexpr (sizeof(T) == 4) {
      if (j16 <= 4)
        return launch_chunks<T, V, 4>(x, stride, d, nv16, src, w, chunk_ptr, chunk_slot,
                                      n_chunks, partial, out, accumulate, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <int C>
void launch_combine(const float* partial, const int32_t* comb_rows, const int64_t* comb_ptr,
                    int64_t n_comb, int64_t n_long, int d, float* out, int accumulate,
                    cudaStream_t stream) {
  const int64_t blocks = n_long + (n_comb - n_long + kCombineWarps - 1) / kCombineWarps;
  segreduce_combine<C><<<static_cast<unsigned>(blocks), kCombineWarps * 32, 0, stream>>>(
      partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate);
}

template <typename T>
int launch(const void* x, int64_t stride, int d, int vec, const int32_t* src,
           const float* w, const int64_t* chunk_ptr, const int32_t* chunk_slot,
           int64_t n_chunks, const int32_t* comb_rows, const int64_t* comb_ptr,
           int64_t n_comb, int64_t n_long, float* partial, float* out, int accumulate,
           cudaStream_t stream) {
  if (d <= 0 || d > kMaxCols || stride < d || n_long < 0 || n_long > n_comb)
    return cudaErrorInvalidValue;
  // The rows' alignment (a power of two up to 16 bytes) must hold a lane's
  // read of `vec` elements; a row's covering span is then nv16 vectors.
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         static_cast<uintptr_t>(stride * sizeof(T)) | uintptr_t{16};
  const int align = static_cast<int>(bits & (~bits + 1));
  if (vec <= 0 || align % (vec * static_cast<int>(sizeof(T)))) return cudaErrorInvalidValue;
  const int nv16 = (16 - align + d * static_cast<int>(sizeof(T)) + 15) / 16;
  if (n_chunks > 0) {
    int rc = cudaErrorInvalidValue;
    if (vec == 1) {
      rc = dispatch_j16<T, 1>(nv16, x, stride, d, src, w, chunk_ptr, chunk_slot, n_chunks,
                              partial, out, accumulate, stream);
    } else if (vec == 2) {
      rc = dispatch_j16<T, 2>(nv16, x, stride, d, src, w, chunk_ptr, chunk_slot, n_chunks,
                              partial, out, accumulate, stream);
    } else if constexpr (sizeof(T) == 2) {
      if (vec == 8)
        rc = dispatch_j16<T, 8>(nv16, x, stride, d, src, w, chunk_ptr, chunk_slot, n_chunks,
                                partial, out, accumulate, stream);
    }
    if (rc != cudaSuccess) return rc;
  }
  if (n_comb > 0) {
    switch ((d + 31) / 32) {
      case 1: launch_combine<1>(partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate, stream); break;
      case 2: launch_combine<2>(partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate, stream); break;
      case 3: launch_combine<3>(partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate, stream); break;
      case 4: launch_combine<4>(partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate, stream); break;
      default: launch_combine<8>(partial, comb_rows, comb_ptr, n_comb, n_long, d, out, accumulate, stream); break;
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int segreduce_f32(const void* x, int64_t stride, int d, int vec,
                             const int32_t* src, const float* w,
                             const int64_t* chunk_ptr, const int32_t* chunk_slot,
                             int64_t n_chunks, const int32_t* comb_rows,
                             const int64_t* comb_ptr, int64_t n_comb, int64_t n_long,
                             float* partial, float* out, int accumulate,
                             cudaStream_t stream) {
  return launch<float>(x, stride, d, vec, src, w, chunk_ptr, chunk_slot, n_chunks,
                       comb_rows, comb_ptr, n_comb, n_long, partial, out, accumulate, stream);
}

extern "C" int segreduce_bf16(const void* x, int64_t stride, int d, int vec,
                              const int32_t* src, const float* w,
                              const int64_t* chunk_ptr, const int32_t* chunk_slot,
                              int64_t n_chunks, const int32_t* comb_rows,
                              const int64_t* comb_ptr, int64_t n_comb, int64_t n_long,
                              float* partial, float* out, int accumulate,
                              cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, stride, d, vec, src, w, chunk_ptr, chunk_slot,
                               n_chunks, comb_rows, comb_ptr, n_comb, n_long, partial,
                               out, accumulate, stream);
}

extern "C" int segreduce_cast_bf16(const float* x, int64_t n_rows, int d, int64_t out_stride,
                                   void* out, cudaStream_t stream) {
  if (d <= 0 || d > kMaxCols || d > out_stride || out_stride % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (n_rows > 0) {
    const int smem = kCastRows * d * static_cast<int>(sizeof(float));
    cast_bf16_tile<<<static_cast<unsigned>((n_rows + kCastRows - 1) / kCastRows), kCastThreads,
                     smem, stream>>>(x, n_rows, d, out_stride, static_cast<__nv_bfloat16*>(out));
  }
  return cudaGetLastError();
}
