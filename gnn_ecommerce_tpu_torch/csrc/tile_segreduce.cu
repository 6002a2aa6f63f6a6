// Tiled segment reduce over a chunk plan, written by hand for Hopper (sm_90a):
//
//   for every chunk c and position j in it:
//     out[tile_map[c] * OT + seg[c*CH + j], :] += float(msgs[c*CH + j, :])
//   with tile t's block zeroed at each chunk c of t whose first[c] == 1
//
// into an f32 [n_tiles * OT, D] output. It replaces the Pallas kernel
// scripts/proto_segreduce.py:make_seg_reduce (K2, the round-2 prototype of
// the segment reduce), which computes each chunk as 8 one-hot
// [OT, CH/8] x [CH/8, D] MXU products summed into a VMEM block that a
// sequential grid revisits. Here it is a sum: no one-hot, no matrix product.
// Messages are f32 or bf16 (the mode); every sum is f32, so the bf16 mode adds
// exactly the values the one-hot product multiplies by 1.
//
// What the TPU layout does not carry over, and what this design does instead:
// - The sequential grid carried the tile's sum from chunk to chunk. Blocks
//   have no order here, so block (t, s) walks split s of tile t's chunks in
//   order with the tile's [OT, D] f32 sum in shared memory (160 KB at
//   OT=512, D=80: dynamic shared memory above 48 KB). tile_map must be
//   non-decreasing (the plan's layout); a tile's chunks are found by binary
//   search. With n_splits > 1 (few tiles for 132 SMs: to_items has 107),
//   each split writes a partial tile and a second pass adds the splits in
//   order, starting at the last split that saw a first[] reset. A tile with
//   no chunk comes out zero (the TPU kernel leaves it unwritten).
// - Within a chunk the arcs are cut into maximal non-decreasing pieces of
//   seg (one piece per chunk, two at a tile's last chunk, whose zero-message
//   padding has seg 0; any seg order is correct, only slower). Each of the
//   32 warps walks one contiguous slice of a piece, lanes owning columns
//   lane, lane+32, ..., and keeps the current run of equal seg in registers.
//   A run strictly inside a slice owns its row within the piece and is added
//   to shared memory directly; a slice's first and last runs go to a small
//   edge buffer that warp 0 adds in slice order after a barrier. Every
//   element's sum therefore has a fixed order: no atomics, the same bytes on
//   every card and every run. A seg outside [0, OT) matches no row, as in
//   the one-hot.
//
// Bound: the card must read E_pad*D*sizeof(T) message bytes, 4 bytes of seg
// per arc and 8 per chunk, and write n_tiles*OT*D*4. At the probe's to_items
// shape (about 10.26M padded arcs, D=80) that is about 3.35 GB in f32 (at
// least about 1.0 ms at 3.35 TB/s) and 1.7 GB in bf16; the adds are far
// below the card's rate. This design streams each message row once with
// coalesced lane loads (4 arcs' loads issued before their adds) and keeps
// the sums on chip; the split partials add n_tiles*n_splits*OT*D*4 bytes
// written and read (about 0.17 GB at to_items, none at to_users).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC tile_segreduce.cu -o libtile_segreduce.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxColsPerLane = 4;  // D <= 128
constexpr int kUnroll = 4;          // arcs whose loads are issued together
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// First position in the non-decreasing a[0, n) whose value is >= v.
__device__ int64_t lower_bound(const int32_t* a, int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Minimum of v over the block (every thread gets it). red: [kWarps] ints.
__device__ int block_min(int v, int* red) {
  v = __reduce_min_sync(kFullMask, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = min(m, red[i]);
  __syncthreads();
  return m;
}

// Shared memory: acc [OT*D] f32 | edge [kWarps*2*D] f32 | seg [CH] int |
// edge_seg [kWarps*2] int | red [kWarps] int | scalars [4] int64.
size_t shared_bytes(int ch, int ot, int d) {
  return static_cast<size_t>(ot) * d * 4 + static_cast<size_t>(kWarps) * 2 * d * 4 +
         static_cast<size_t>(ch) * 4 + kWarps * 2 * 4 + kWarps * 4 + 4 * 8;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tile_segreduce_tiles(const T* __restrict__ msgs, const int32_t* __restrict__ seg,
                     const int32_t* __restrict__ tile_map,
                     const int32_t* __restrict__ first, int64_t n_chunks, int ch,
                     int ot, int d, int n_splits, float* __restrict__ dst,
                     int32_t* __restrict__ dst_reset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  float* edge = acc + static_cast<size_t>(ot) * d;
  int32_t* seg_s = reinterpret_cast<int32_t*>(edge + kWarps * 2 * d);
  int32_t* edge_seg = seg_s + ch;
  int32_t* red = edge_seg + kWarps * 2;
  int64_t* range = reinterpret_cast<int64_t*>(
      (reinterpret_cast<uintptr_t>(red + kWarps) + 7) & ~uintptr_t(7));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x / n_splits;
  const int split = blockIdx.x - static_cast<int>(tile * n_splits);
  if (threadIdx.x == 0) {
    const int64_t lo = lower_bound(tile_map, n_chunks, static_cast<int32_t>(tile));
    const int64_t hi = lower_bound(tile_map, n_chunks, static_cast<int32_t>(tile + 1));
    range[0] = lo + (hi - lo) * split / n_splits;
    range[1] = lo + (hi - lo) * (split + 1) / n_splits;
  }
  const int64_t tile_elems = static_cast<int64_t>(ot) * d;
  for (int64_t i = threadIdx.x; i < tile_elems; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const int64_t c_lo = range[0], c_hi = range[1];
  int reset = 0;

  for (int64_t c = c_lo; c < c_hi; ++c) {
    if (first[c] == 1) {  // the same for every thread
      reset = 1;
      for (int64_t i = threadIdx.x; i < tile_elems; i += kThreads) acc[i] = 0.f;
    }
    const int64_t base = c * ch;
    for (int i = threadIdx.x; i < ch; i += kThreads) seg_s[i] = seg[base + i];
    __syncthreads();

    for (int p0 = 0; p0 < ch;) {
      // The piece ends at the first descent of seg after p0.
      int p1 = ch;
      for (int j = p0 + 1 + threadIdx.x; j < ch; j += kThreads) {
        if (seg_s[j] < seg_s[j - 1]) { p1 = j; break; }
      }
      p1 = block_min(p1, red);

      const int len = p1 - p0;
      const int j0 = p0 + static_cast<int>(static_cast<int64_t>(len) * warp / kWarps);
      const int j1 = p0 + static_cast<int>(static_cast<int64_t>(len) * (warp + 1) / kWarps);
      if (lane == 0) edge_seg[2 * warp] = edge_seg[2 * warp + 1] = -1;
      __syncwarp();

      float run[kMaxColsPerLane];
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) run[k] = 0.f;
      int cur = -1;
      bool open = false, first_run = true;
      for (int j = j0; j < j1; j += kUnroll) {
        float v[kUnroll][kMaxColsPerLane];
        int s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in = j + u < j1;
          s[u] = in ? seg_s[j + u] : 0;
          const T* row = msgs + (base + j + u) * d;
#pragma unroll
          for (int k = 0; k < kMaxColsPerLane; ++k) {
            const int col = lane + 32 * k;
            v[u][k] = (in && col < d) ? to_f32(row[col]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u >= j1) break;
          if (!open || s[u] != cur) {
            if (open) {  // close a run that is not the slice's last
              if (first_run) {
#pragma unroll
                for (int k = 0; k < kMaxColsPerLane; ++k) {
                  const int col = lane + 32 * k;
                  if (col < d) edge[(2 * warp) * d + col] = run[k];
                }
                if (lane == 0) edge_seg[2 * warp] = cur;
                first_run = false;
              } else if (cur >= 0 && cur < ot) {
                float* out_row = acc + static_cast<int64_t>(cur) * d;
#pragma unroll
                for (int k = 0; k < kMaxColsPerLane; ++k) {
                  const int col = lane + 32 * k;
                  if (col < d) out_row[col] += run[k];
                }
              }
            }
            open = true;
            cur = s[u];
#pragma unroll
            for (int k = 0; k < kMaxColsPerLane; ++k) run[k] = 0.f;
          }
#pragma unroll
          for (int k = 0; k < kMaxColsPerLane; ++k) run[k] += v[u][k];
        }
      }
      if (open) {  // the slice's last run (or its only one)
        const int slot = first_run ? 2 * warp : 2 * warp + 1;
#pragma unroll
        for (int k = 0; k < kMaxColsPerLane; ++k) {
          const int col = lane + 32 * k;
          if (col < d) edge[slot * d + col] = run[k];
        }
        if (lane == 0) edge_seg[slot] = cur;
      }
      __syncthreads();
      if (warp == 0) {  // the slices' edge runs, in slice order
        for (int e = 0; e < 2 * kWarps; ++e) {
          const int r = edge_seg[e];
          if (r < 0 || r >= ot) continue;
          float* out_row = acc + static_cast<int64_t>(r) * d;
#pragma unroll
          for (int k = 0; k < kMaxColsPerLane; ++k) {
            const int col = lane + 32 * k;
            if (col < d) out_row[col] += edge[e * d + col];
          }
        }
      }
      __syncthreads();
      p0 = p1;
    }
  }

  const int64_t slot = static_cast<int64_t>(blockIdx.x);
  float* out = dst + (n_splits == 1 ? tile : slot) * tile_elems;
  for (int64_t i = threadIdx.x; i < tile_elems; i += kThreads) out[i] = acc[i];
  if (dst_reset != nullptr && threadIdx.x == 0) dst_reset[slot] = reset;
}

// out[t, e] = sum of partial[t, s, e] over s from the last split of t that
// reset (0 when none did) to n_splits - 1, in split order.
__global__ void tile_segreduce_combine(const float* __restrict__ partial,
                                       const int32_t* __restrict__ reset,
                                       int64_t n_tiles, int n_splits,
                                       int64_t tile_elems, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_tiles * tile_elems) return;
  const int64_t t = i / tile_elems;
  const int64_t e = i - t * tile_elems;
  int s0 = 0;
  for (int s = 0; s < n_splits; ++s)
    if (reset[t * n_splits + s]) s0 = s;
  float sum = 0.f;
  for (int s = s0; s < n_splits; ++s)
    sum += partial[(t * n_splits + s) * tile_elems + e];
  out[i] = sum;
}

template <typename T>
int launch(const void* msgs, const int32_t* seg, const int32_t* tile_map,
           const int32_t* first, int64_t n_chunks, int ch, int ot, int d,
           int64_t n_tiles, int n_splits, float* partial, int32_t* partial_reset,
           float* out, cudaStream_t stream) {
  if (d <= 0 || d > 32 * kMaxColsPerLane || ch <= 0 || ot <= 0 || n_splits <= 0)
    return cudaErrorInvalidValue;
  if (n_splits > 1 && (partial == nullptr || partial_reset == nullptr))
    return cudaErrorInvalidValue;
  if (n_tiles == 0) return cudaSuccess;
  const size_t shmem = shared_bytes(ch, ot, d);
  cudaError_t err = cudaFuncSetAttribute(tile_segreduce_tiles<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = n_tiles * n_splits;
  tile_segreduce_tiles<T><<<static_cast<unsigned>(blocks), kThreads, shmem, stream>>>(
      static_cast<const T*>(msgs), seg, tile_map, first, n_chunks, ch, ot, d, n_splits,
      n_splits == 1 ? out : partial, n_splits == 1 ? nullptr : partial_reset);
  if (n_splits > 1) {
    const int64_t tile_elems = static_cast<int64_t>(ot) * d;
    const int64_t total = n_tiles * tile_elems;
    constexpr int kCombineThreads = 256;
    tile_segreduce_combine<<<static_cast<unsigned>((total + kCombineThreads - 1) /
                                                   kCombineThreads),
                             kCombineThreads, 0, stream>>>(
        partial, partial_reset, n_tiles, n_splits, tile_elems, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block of the tile pass needs.
extern "C" int64_t tile_segreduce_shared_bytes(int ch, int ot, int d) {
  return static_cast<int64_t>(shared_bytes(ch, ot, d));
}

// msgs: [n_chunks*ch, d] f32 or bf16; seg: [n_chunks*ch] int32; tile_map,
// first: [n_chunks] int32 (tile_map non-decreasing); out: [n_tiles*ot, d] f32.
// With n_splits > 1, partial ([n_tiles*n_splits*ot*d] f32) and partial_reset
// ([n_tiles*n_splits] int32) are scratch; with 1 they may be null.
extern "C" int tile_segreduce_f32(const void* msgs, const int32_t* seg,
                                  const int32_t* tile_map, const int32_t* first,
                                  int64_t n_chunks, int ch, int ot, int d,
                                  int64_t n_tiles, int n_splits, float* partial,
                                  int32_t* partial_reset, float* out,
                                  cudaStream_t stream) {
  return launch<float>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, n_tiles,
                       n_splits, partial, partial_reset, out, stream);
}

extern "C" int tile_segreduce_bf16(const void* msgs, const int32_t* seg,
                                   const int32_t* tile_map, const int32_t* first,
                                   int64_t n_chunks, int ch, int ot, int d,
                                   int64_t n_tiles, int n_splits, float* partial,
                                   int32_t* partial_reset, float* out,
                                   cudaStream_t stream) {
  return launch<__nv_bfloat16>(msgs, seg, tile_map, first, n_chunks, ch, ot, d,
                               n_tiles, n_splits, partial, partial_reset, out, stream);
}
