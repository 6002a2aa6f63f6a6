// Intent-weighted gather-sum over a head-sorted CSR, written by hand for
// Hopper (sm_90a), for DGCF's routing (models/dgcf.py, ops/routing.py):
//
//   out[h, k*c:(k+1)*c] = sum over the arcs a of row h of
//                         w[a, k] * x[src_a, k*c:(k+1)*c]        (c = d / K)
//
// with f32 weights and f32 sums, each output row written once. K weights an
// arc, one per intent chunk of the row. The weights are the equations'
// [K, E] stored arc-major, [E, K] in memory, so that an arc's K weights lie
// together. It replaces no TPU kernel: the JAX package has no DGCF. Its
// plain version is ops/routing.py:intent_gather_plain. One kernel serves
// the routing forward (each iteration's f = the routed product of the
// layer input), the gradient with respect to x (the same CSR with each
// arc's weights taken from its reverse arc), and the per-arc dot product's
// gradients (its output gradient as the weights).
//
// Modes (the element type of x; weights and sums are f32 in both):
//   float          f32 rows: each product rounded to f32 and summed in f32
//                  (__fmul_rn / __fadd_rn: no FMA contraction).
//   __nv_bfloat16  bf16 rows (the table rounded once, by the caller): the
//                  bf16 value times the f32 weight, rounded to f32, summed
//                  in f32.
// Each row's arcs are added in arc order.
//
// Layout (ops/routing.py:build_intent_plan): the CSR's src [E] int32 and
// the weights [E, K] f32; a work list of items, each (first arc, arc count,
// destination): a row of at most `split` arcs is one item written to its
// output row; a longer row is cut into segments of `split` arcs (the last
// shorter), each an item written to a partial row. The items are the
// segments first, then the whole rows from the longest down, so that the
// longest work starts first.
//
//   pass 1  a lane group of one lane per 16 bytes of the row (d 64: 8
//           lanes in bf16, 16 in f32) takes an item; a warp holds 32 /
//           lanes groups, and the groups of a persistent grid walk the
//           items with a stride of their count. The group loads the item's
//           arcs one a lane, coalesced (src and the arc's K weights;
//           streaming loads: read once), hands them round by shuffles, and
//           keeps 4 rows in flight (2 at more than 32 vectors a row). A
//           lane's 16 bytes lie in one intent chunk (c a multiple of the
//           vector), so it takes one weight an arc. It keeps its columns'
//           sums in registers and stores them once, 16 bytes at a time,
//           evict-first. A row with no arc is written as zeros.
//   pass 2  (only when some row is split) one block a split row: slice s of
//           P = 256 / (d / 4) slices adds a run of consecutive partial rows
//           in segment order, then one thread a column vector adds the
//           slices' sums in slice order and writes the output row. P
//           depends on d alone, so the order of every sum is fixed.
// No atomics: every sum's order is fixed by the plan, so the result is the
// same bytes every run, whatever the grid.
//
// Bound (one routing product of the cosmetics graph, d 64, K 4, bf16 rows:
// 20.2M arcs over 1.69M rows): each arc's src (4 B) and K weights (16 B),
// each gathered row read once (1.69M x 128 B), the f32 output written once
// (1.69M x 256 B): about 1.06 GB, 0.32 ms at 3.35 TB/s. The gathers are
// random rows: the users' side reads the item table (7 MB in bf16, in the
// 50 MB L2), the items' side reads the user table (210 MB) from HBM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC intent_gather.cu -o libintent_gather.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kMaxCols = 256;
constexpr int kCombineUnroll = 4;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

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

// Pass 1 (module comment). T: row type; J: 16-byte vectors a lane reads of
// each row (1, or 2 for f32 rows of more than 128 columns). x: rows of
// `stride` elements (a multiple of 16 bytes) on a 16-byte aligned base;
// nvec = d / kVecElems<T> vectors a row, lanes = min(nvec, 32).
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
intent_rows(const T* __restrict__ x, int64_t stride, int d, int nvec, int lanes, int c, int K,
            const int32_t* __restrict__ src, const float* __restrict__ w,
            const int64_t* __restrict__ item_arc, const int32_t* __restrict__ item_n,
            const int32_t* __restrict__ item_dest, int64_t n_work, float* __restrict__ partial,
            float* __restrict__ out) {
  constexpr int kE = kVecElems<T>;
  constexpr int kU = 4 / J;  // arcs whose rows a group loads at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / lanes;
  const int g = lane / lanes;
  if (g >= groups) return;  // the lanes past the last whole group
  const int gl = lane - g * lanes, g0 = g * lanes;
  const unsigned gmask = lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u) << g0;
  // The intent chunk of each vector this lane reads.
  int kint[J];
#pragma unroll
  for (int j = 0; j < J; ++j) kint[j] = ((gl + lanes * j) * kE) / c;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * kWarps * groups;
  for (int64_t q = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * groups + g; q < n_work;
       q += n_groups) {
    const int64_t a0 = __ldcs(reinterpret_cast<const long long*>(item_arc) + q);
    const int n = __ldcs(item_n + q);
    const int dest = __ldcs(item_dest + q);
    float* row_out = dest >= 0 ? out + static_cast<int64_t>(dest) * d
                               : partial + static_cast<int64_t>(-dest - 1) * d;
    float acc[J * kE];
#pragma unroll
    for (int e = 0; e < J * kE; ++e) acc[e] = 0.f;
    for (int base = 0; base < n; base += lanes) {
      const int m = min(lanes, n - base);
      int my_src = 0;
      float my_w[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) my_w[k] = 0.f;
      if (gl < m) {
        const int64_t a = a0 + base + gl;
        my_src = __ldcs(src + a);
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) my_w[k] = __ldcs(w + a * K + k);
        }
      }
      for (int k = 0; k < m; k += kU) {
        int sr[kU];
        float wk[kU][J];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int from = g0 + min(k + u, m - 1);
          sr[u] = __shfl_sync(gmask, my_src, from);
#pragma unroll
          for (int j = 0; j < J; ++j) wk[u][j] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kMaxK; ++kk) {
            if (kk < K) {
              const float v = __shfl_sync(gmask, my_w[kk], from);
#pragma unroll
              for (int j = 0; j < J; ++j) {
                if (kk == kint[j]) wk[u][j] = v;
              }
            }
          }
        }
        uint4 v[kU][J];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const uint4* row = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(sr[u]) * stride);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int vec = gl + lanes * j;
            v[u][j] = k + u < m && vec < nvec ? __ldg(row + vec) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (k + u >= m) continue;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float f[kE];
            unpack<T>(v[u][j], f);
#pragma unroll
            for (int e = 0; e < kE; ++e)
              acc[j * kE + e] = __fadd_rn(acc[j * kE + e], __fmul_rn(wk[u][j], f[e]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int vec = gl + lanes * j;
      if (vec < nvec) {
#pragma unroll
        for (int p = 0; p < kE; p += 4) {
          const float* s = acc + j * kE + p;
          __stcs(reinterpret_cast<float4*>(row_out + vec * kE + p), make_float4(s[0], s[1], s[2], s[3]));
        }
      }
    }
  }
}

// Pass 2 (module comment): block r writes split row r. d a multiple of 4.
__global__ void __launch_bounds__(kThreads)
intent_combine(const float* __restrict__ partial, const int32_t* __restrict__ comb_row,
               const int64_t* __restrict__ comb_ptr, int d, float* __restrict__ out) {
  __shared__ float4 s_sum[kThreads];
  const int nv = d / 4;
  const int slices = kThreads / nv;
  const int v = threadIdx.x % nv, s = threadIdx.x / nv;
  const int64_t r = blockIdx.x;
  const int64_t p0 = comb_ptr[r], nseg = comb_ptr[r + 1] - p0;
  const int64_t per = (nseg + slices - 1) / slices;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (s < slices) {
    const int64_t lo = p0 + min64(nseg, s * per), hi = p0 + min64(nseg, (s + 1) * per);
    const float4* base = reinterpret_cast<const float4*>(partial) + v;
    for (int64_t p = lo; p < hi; p += kCombineUnroll) {
      float4 t[kCombineUnroll];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u)
        t[u] = p + u < hi ? base[(p + u) * nv] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        if (p + u < hi) {
          acc.x = __fadd_rn(acc.x, t[u].x); acc.y = __fadd_rn(acc.y, t[u].y);
          acc.z = __fadd_rn(acc.z, t[u].z); acc.w = __fadd_rn(acc.w, t[u].w);
        }
      }
    }
    s_sum[s * nv + v] = acc;
  }
  __syncthreads();
  if (s == 0) {
    float4 tot = s_sum[v];
    for (int q = 1; q < slices; ++q) {
      const float4 t = s_sum[q * nv + v];
      tot.x = __fadd_rn(tot.x, t.x); tot.y = __fadd_rn(tot.y, t.y);
      tot.z = __fadd_rn(tot.z, t.z); tot.w = __fadd_rn(tot.w, t.w);
    }
    reinterpret_cast<float4*>(out + static_cast<int64_t>(comb_row[r]) * d)[v] = tot;
  }
}

// The persistent grid: as many blocks as fit on the card at once, never
// more than the items need. The grid changes who sums a row, not the order.
template <typename T, int J>
int launch_rows(const void* x, int64_t stride, int d, int nvec, int c, int K, const int32_t* src,
                const float* w, const int64_t* item_arc, const int32_t* item_n,
                const int32_t* item_dest, int64_t n_work, float* partial, float* out,
                cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t rc =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intent_rows<T, J>, kThreads, 0);
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
  intent_rows<T, J><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), stride, d, nvec, lanes, c, K, src, w, item_arc, item_n, item_dest,
      n_work, partial, out);
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, int64_t stride, int d, int K, const int32_t* src, const float* w,
           const int64_t* item_arc, const int32_t* item_n, const int32_t* item_dest, int64_t n_work,
           const int32_t* comb_row, const int64_t* comb_ptr, int64_t n_split_rows, float* partial,
           float* out, cudaStream_t stream) {
  constexpr int kE = kVecElems<T>;
  if (d <= 0 || d > kMaxCols || K <= 0 || K > kMaxK || d % K || (d / K) % kE || stride < d ||
      stride % kE || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      n_work < 0 || n_split_rows < 0 || (n_split_rows > 0 && partial == nullptr) ||
      (n_split_rows > 0 && reinterpret_cast<uintptr_t>(partial) % 16))
    return cudaErrorInvalidValue;
  const int nvec = d / kE, c = d / K;
  if (n_work > 0) {
    const int rc = nvec <= 32
        ? launch_rows<T, 1>(x, stride, d, nvec, c, K, src, w, item_arc, item_n, item_dest, n_work,
                            partial, out, stream)
        : launch_rows<T, 2>(x, stride, d, nvec, c, K, src, w, item_arc, item_n, item_dest, n_work,
                            partial, out, stream);
    if (rc != cudaSuccess) return rc;
  }
  if (n_split_rows > 0) {
    intent_combine<<<static_cast<unsigned>(n_split_rows), kThreads, 0, stream>>>(
        partial, comb_row, comb_ptr, d, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int intent_gather_f32(const void* x, int64_t stride, int d, int K, const int32_t* src,
                                 const float* w, const int64_t* item_arc, const int32_t* item_n,
                                 const int32_t* item_dest, int64_t n_work, const int32_t* comb_row,
                                 const int64_t* comb_ptr, int64_t n_split_rows, float* partial,
                                 float* out, cudaStream_t stream) {
  return launch<float>(x, stride, d, K, src, w, item_arc, item_n, item_dest, n_work, comb_row,
                       comb_ptr, n_split_rows, partial, out, stream);
}

extern "C" int intent_gather_bf16(const void* x, int64_t stride, int d, int K, const int32_t* src,
                                  const float* w, const int64_t* item_arc, const int32_t* item_n,
                                  const int32_t* item_dest, int64_t n_work, const int32_t* comb_row,
                                  const int64_t* comb_ptr, int64_t n_split_rows, float* partial,
                                  float* out, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, stride, d, K, src, w, item_arc, item_n, item_dest, n_work,
                               comb_row, comb_ptr, n_split_rows, partial, out, stream);
}
