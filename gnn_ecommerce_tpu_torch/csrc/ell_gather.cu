// Degree-binned ELL gather + width-sum, written by hand for Hopper (sm_90a):
//
//   out[u, :] = sum over the arcs a of row u of  w_a * x[idx_a, :]
//
// with f32 accumulation, each output row written once. It replaces no TPU
// kernel: the JAX package leaves this product (fast_to_users, and
// fast_to_items' backward) to XLA's gathers and reductions, and the port ran
// it as plain torch (ops/spmm_fast.py:ell_apply: per bin an index_select, a
// cast, a multiply and a width sum, then a cat and a row gather at
// inv_order), which wrote every message to device memory in f32 and read it
// back several times.
//
// Modes (the element type of x; weights are f32 in both):
//   float         f32 rows: each product rounded to f32 and summed in f32
//                 (__fmul_rn / __fadd_rn: no FMA contraction), the
//                 arithmetic of ell_apply's x[idx].float() * w summed.
//   __nv_bfloat16 bf16 rows (the table rounded once, as ell_apply's
//                 gather_dtype): the bf16 value times the f32 weight, the
//                 product rounded to f32, summed in f32.
// Only the order of the sums differs from ell_apply: each row's arcs are
// added in arc order. A zero weight (the bins' padding) adds nothing and
// its row is not read.
//
// Layout (ops/spmm_fast.py:build_ell_plan): the bins' [rows_b, W_b] index
// and weight arrays lie one after the other in two flat buffers; order
// maps a row in bin order to its output row. The descriptor `bins` lists
// the bins widest first, one record of kBinCols int64 each: the first work
// item, the first row in bin order, the width W, the offset of the bin's
// first arc, and the first split row. A bin no wider than `split` gives
// one work item a row; a wider bin (a hub's, only without a heavy head)
// gives each row ceil(W / split) items of `split` arcs (the last shorter),
// whose sums go to partial rows: item q writes partial row q, and the hub
// bins come first, so a row's partials are consecutive.
//
//   pass 1  one launch over every work item, widest first (hub segments,
//           then the short rows from the widest bin down): a lane group
//           of one lane per 16 bytes of the row (D 64 bf16: 8 lanes; D 80
//           bf16 10; D 90 bf16 12; D 90 f32 23, read from 92-column rows)
//           takes an item; a warp holds 32 / lanes groups, and the groups
//           of a persistent grid walk the items with a stride of their
//           count. The group loads the item's (idx, w) pairs one a lane,
//           coalesced (streaming loads: they are read once), hands them
//           round by shuffles, and keeps 4 item rows in flight (2 at more
//           than 32 vectors a row); the item table ([54,571, 90] f32 padded
//           to 92 columns is 20 MB, in bf16 10.5 MB) stays in the 50 MB L2.
//           Each lane keeps its columns' sums in registers and stores them
//           once, 16 bytes at a time where the row's address allows
//           (8 or 4 bytes on rows that start off 16 bytes: D 90 f32 rows
//           alternate), with evict-first stores, so that the output rows
//           do not push the table out of L2. A row with no arc is written
//           as zeros by the same pass.
//   pass 2  (only when the plan splits rows) one warp a split row adds its
//           partial rows in segment order and writes the output row.
// No atomics: every sum's order is fixed by the plan, so the result is the
// same bytes every run, whatever the grid.
//
// Bound (to_users over 1,639,358 users, the item table in L2): the output
// written once, 1.64M x 90 x 4 B = 590 MB, the index and weight of each arc
// (8 B) and the table read once: at least 0.2 ms at 3.35 TB/s. The
// gathers are L2 traffic (192 B a bf16 arc, 368 B an f32 one).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC ell_gather.cu -o libell_gather.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 64;
constexpr int kBinCols = 5;  // first item, first row, width, first arc, first split row
constexpr int kMaxCols = 256;
constexpr int kCombineUnroll = 4;

// Row elements in one 16-byte vector.
template <typename T> constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

// bf16 bits to f32 (exact): the bf16 is the f32's top half.
__device__ __forceinline__ float lo_bf16(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

template <typename T> __device__ __forceinline__ void unpack(uint4 r, float* f);
template <> __device__ __forceinline__ void unpack<float>(uint4 r, float* f) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 r, float* f) {
  f[0] = lo_bf16(r.x); f[1] = hi_bf16(r.x);
  f[2] = lo_bf16(r.y); f[3] = hi_bf16(r.y);
  f[4] = lo_bf16(r.z); f[5] = hi_bf16(r.z);
  f[6] = lo_bf16(r.w); f[7] = hi_bf16(r.w);
}

// The values v[0, 4) of columns [c, c + 4) that lie below d, into row o,
// with the widest evict-first stores its address allows.
__device__ __forceinline__ void store4(float* o, int c, int d, const float* v) {
  float* p = o + c;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (c + 4 <= d && (a & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      if (c + e + 2 <= d) {
        __stcs(reinterpret_cast<float2*>(p + e), make_float2(v[e], v[e + 1]));
      } else if (c + e < d) {
        __stcs(p + e, v[e]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < d) __stcs(p + e, v[e]);
    }
  }
}

// Pass 1 (module comment). T: row type; J: 16-byte vectors a lane reads of
// each row (1, or 2 for f32 rows of more than 128 columns). x: rows of
// `stride` elements (a multiple of 16 bytes) on a 16-byte aligned base;
// nvec = ceil(d / kVecElems<T>) vectors a row, lanes = min(nvec, 32).
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
ell_rows(const T* __restrict__ x, int64_t stride, int d, int nvec, int lanes,
         const int32_t* __restrict__ idx, const float* __restrict__ w,
         const int32_t* __restrict__ order, const int64_t* __restrict__ bins, int n_bins,
         int64_t n_work, int split, float* __restrict__ partial, float* __restrict__ out) {
  constexpr int kE = kVecElems<T>;
  constexpr int kU = 4 / J;  // arcs whose rows a group loads at once
  __shared__ int64_t s_item[kMaxBins + 1];
  __shared__ int64_t s_arc[kMaxBins];
  __shared__ int32_t s_row[kMaxBins];
  __shared__ int32_t s_width[kMaxBins];
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    const int64_t* rec = bins + b * kBinCols;
    s_item[b] = rec[0];
    s_row[b] = static_cast<int32_t>(rec[1]);
    s_width[b] = static_cast<int32_t>(rec[2]);
    s_arc[b] = rec[3];
  }
  if (threadIdx.x == 0) s_item[n_bins] = n_work;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / lanes;
  const int g = lane / lanes;
  if (g >= groups) return;  // the lanes past the last whole group
  const int gl = lane - g * lanes, g0 = g * lanes;
  const unsigned gmask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << g0;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * kWarps * groups;
  int b = 0;
  for (int64_t q = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * groups + g; q < n_work;
       q += n_groups) {
    while (q >= s_item[b + 1]) ++b;  // q only grows
    const int width = s_width[b];
    const int64_t t = q - s_item[b];
    int64_t a0;
    int n;
    float* dest;
    if (width > split) {  // segment s of split row r
      const int nseg = (width + split - 1) / split;
      const int64_t r = t / nseg;
      const int s = static_cast<int>(t - r * nseg);
      a0 = s_arc[b] + r * width + static_cast<int64_t>(s) * split;
      n = min(split, width - s * split);
      dest = partial + q * d;
    } else {
      a0 = s_arc[b] + t * width;
      n = width;
      dest = out + static_cast<int64_t>(__ldcs(order + s_row[b] + t)) * d;
    }
    float acc[J * kE];
#pragma unroll
    for (int e = 0; e < J * kE; ++e) acc[e] = 0.f;
    for (int base = 0; base < n; base += lanes) {
      const int m = min(lanes, n - base);
      int my_src = 0;
      float my_w = 0.f;
      if (gl < m) {
        my_src = __ldcs(idx + a0 + base + gl);
        my_w = __ldcs(w + a0 + base + gl);
      }
      for (int k = 0; k < m; k += kU) {
        int src[kU];
        float wk[kU];
        uint4 v[kU][J];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int from = g0 + min(k + u, m - 1);
          src[u] = __shfl_sync(gmask, my_src, from);
          wk[u] = __shfl_sync(gmask, my_w, from);
          if (k + u >= m) wk[u] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint4* row = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(src[u]) * stride);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int vec = gl + lanes * j;
            v[u][j] = wk[u] != 0.f && vec < nvec ? __ldg(row + vec) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (wk[u] == 0.f) continue;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float f[kE];
            unpack<T>(v[u][j], f);
#pragma unroll
            for (int e = 0; e < kE; ++e)
              acc[j * kE + e] = __fadd_rn(acc[j * kE + e], __fmul_rn(wk[u], f[e]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int vec = gl + lanes * j;
      if (vec < nvec) {
#pragma unroll
        for (int p = 0; p < kE; p += 4) store4(dest, vec * kE + p, d, acc + j * kE + p);
      }
    }
  }
}

// Pass 2 (module comment): warp h of the grid writes split row h, the sum of
// its partial rows in segment order. C: columns a lane, ceil(d / 32).
template <int C>
__global__ void __launch_bounds__(kThreads)
ell_combine(const float* __restrict__ partial, const int32_t* __restrict__ order,
            const int64_t* __restrict__ bins, int n_bins, int64_t n_split_rows, int split, int d,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (h >= n_split_rows) return;
  // The split bins come first, their first split rows ascending; a bin
  // that splits nothing starts at n_split_rows.
  int b = 0;
  while (b + 1 < n_bins && h >= bins[(b + 1) * kBinCols + 4]) ++b;
  const int64_t* rec = bins + b * kBinCols;
  const int nseg = static_cast<int>((rec[2] + split - 1) / split);
  const int64_t t = h - rec[4];
  const float* p0 = partial + (rec[0] + t * nseg) * d;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int s = 0; s < nseg; s += kCombineUnroll) {
    float v[kCombineUnroll][C];
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        v[u][c] = s + u < nseg && col < d ? p0[static_cast<int64_t>(s + u) * d + col] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
      if (s + u < nseg) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], v[u][c]);
      }
    }
  }
  float* o = out + static_cast<int64_t>(order[rec[1] + t]) * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = lane + 32 * c;
    if (col < d) o[col] = acc[c];
  }
}

// The persistent grid: as many blocks as fit on the card at once, never
// more than the items need. The grid changes who sums a row, not the order.
template <typename T, int J>
int launch_rows(const void* x, int64_t stride, int d, int nvec, const int32_t* idx, const float* w,
                const int32_t* order, const int64_t* bins, int n_bins, int64_t n_work, int split,
                float* partial, float* out, cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t rc =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_rows<T, J>, kThreads, 0);
    if (rc != cudaSuccess || per_sm <= 0) {
      per_sm = 0;
      return rc != cudaSuccess ? rc : cudaErrorInvalidConfiguration;
    }
  }
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  const int lanes = nvec < 32 ? nvec : 32;
  const int64_t per_block = static_cast<int64_t>(kWarps) * (32 / lanes);
  int64_t blocks = (n_work + per_block - 1) / per_block;
  if (blocks > static_cast<int64_t>(per_sm) * sms) blocks = static_cast<int64_t>(per_sm) * sms;
  ell_rows<T, J><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), stride, d, nvec, lanes, idx, w, order, bins, n_bins, n_work, split,
      partial, out);
  return cudaSuccess;
}

template <int C>
void launch_combine(const float* partial, const int32_t* order, const int64_t* bins, int n_bins,
                    int64_t n_split_rows, int split, int d, float* out, cudaStream_t stream) {
  const int64_t blocks = (n_split_rows + kWarps - 1) / kWarps;
  ell_combine<C><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      partial, order, bins, n_bins, n_split_rows, split, d, out);
}

template <typename T>
int launch(const void* x, int64_t stride, int d, const int32_t* idx, const float* w,
           const int32_t* order, const int64_t* bins, int n_bins, int64_t n_work,
           int64_t n_split_rows, int split, float* partial, float* out, cudaStream_t stream) {
  constexpr int kE = kVecElems<T>;
  if (d <= 0 || d > kMaxCols || stride < d || stride % kE || reinterpret_cast<uintptr_t>(x) % 16 ||
      n_bins < 0 || n_bins > kMaxBins || split <= 0 || n_work < 0 || n_split_rows < 0 ||
      (n_split_rows > 0 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int nvec = (d + kE - 1) / kE;
  if (n_work > 0) {
    const int rc = nvec <= 32
        ? launch_rows<T, 1>(x, stride, d, nvec, idx, w, order, bins, n_bins, n_work, split, partial, out, stream)
        : launch_rows<T, 2>(x, stride, d, nvec, idx, w, order, bins, n_bins, n_work, split, partial, out, stream);
    if (rc != cudaSuccess) return rc;
  }
  if (n_split_rows > 0) {
    switch ((d + 31) / 32) {
      case 1: launch_combine<1>(partial, order, bins, n_bins, n_split_rows, split, d, out, stream); break;
      case 2: launch_combine<2>(partial, order, bins, n_bins, n_split_rows, split, d, out, stream); break;
      case 3: launch_combine<3>(partial, order, bins, n_bins, n_split_rows, split, d, out, stream); break;
      case 4: launch_combine<4>(partial, order, bins, n_bins, n_split_rows, split, d, out, stream); break;
      default: launch_combine<8>(partial, order, bins, n_bins, n_split_rows, split, d, out, stream); break;
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ell_gather_f32(const void* x, int64_t stride, int d, const int32_t* idx,
                              const float* w, const int32_t* order, const int64_t* bins,
                              int n_bins, int64_t n_work, int64_t n_split_rows, int split,
                              float* partial, float* out, cudaStream_t stream) {
  return launch<float>(x, stride, d, idx, w, order, bins, n_bins, n_work, n_split_rows, split,
                       partial, out, stream);
}

extern "C" int ell_gather_bf16(const void* x, int64_t stride, int d, const int32_t* idx,
                               const float* w, const int32_t* order, const int64_t* bins,
                               int n_bins, int64_t n_work, int64_t n_split_rows, int split,
                               float* partial, float* out, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, stride, d, idx, w, order, bins, n_bins, n_work, n_split_rows,
                               split, partial, out, stream);
}
