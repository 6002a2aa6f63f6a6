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
//   have no order here, so block (tile, split, band) takes split s of the
//   tile's chunks and sums them into the tile's rows [band_lo, band_hi) in
//   shared memory. tile_map must be non-decreasing (the plan's layout); one
//   warp finds a tile's chunks by a 32-way search. A reset (first[c] == 1)
//   discards everything before chunk c, so the block starts at its split's
//   last reset and never zeroes again. The wrapper picks the fewest row
//   bands whose block fits twice in an SM's shared memory (two bands of 256
//   rows at OT=512, D=80: 80 KB of sums), so one block's set-up, barriers
//   and write-back overlap the other's loads. With n_splits > 1 (few tiles
//   for 132 SMs: to_items has 107), each split writes the bands its arcs
//   reach into a partial tile, and a second pass adds the splits in order,
//   starting at the last split that saw a reset and skipping the bands a
//   split did not write. A tile with no chunk comes out zero (the TPU
//   kernel leaves it unwritten).
// - The messages of a split are contiguous rows: K2 streams them. The
//   split's arcs are cut into maximal non-decreasing pieces of seg (one for
//   the real arcs, one for a tile's zero-message padding, whose seg is 0;
//   any seg order is correct, only slower); in a piece the band's rows are
//   one contiguous range, found by binary search, so no row is read twice.
//   Lanes read fixed 16-byte column vectors (V = 8 bf16 or 4 f32 columns;
//   narrower where D or the base alignment asks: the wrapper's
//   vector_width), so a row takes n_vec = D / V lanes and a warp holds R =
//   32 / n_vec lane groups (3 at D=80 bf16), each with 4 rows' loads in
//   flight. The range is cut into contiguous slices with no barrier among
//   them, one a lane group, which keeps its current run of equal seg in
//   registers; a run that ends is added by its group alone. A run strictly
//   inside a slice
//   owns its row within the piece and is added to the shared sums directly;
//   a slice's first and last runs go to an edge buffer, which the block
//   adds after a barrier: the rows that start a run of equal edge slots are
//   listed in slot order, and one warp sums each row's slots in order.
//   Every element's sum therefore has a fixed order, set by the plan and
//   the messages' layout: no atomics, the same bytes on every card and
//   every run. A seg outside [0, OT) matches no row, as in the one-hot.
//
// Bound: the card must read E_pad*D*sizeof(T) message bytes, 4 bytes of seg
// per arc and 8 per chunk, and write n_tiles*OT*D*4. At the probe's to_items
// shape (about 10.26M padded arcs, D=80) that is about 3.35 GB in f32 (at
// least about 1.0 ms at 3.35 TB/s) and 1.7 GB in bf16; the adds are far
// below the card's rate. The design streams each message row once with
// 16-byte lane loads and keeps the sums on chip; it reads seg twice (once to
// find the pieces), and the split partials add the written bands' bytes
// twice (written, then read by the combine).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC tile_segreduce.cu -o libtile_segreduce.so
// The C entry points launch on the given stream and return cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // a block: 512 threads, two blocks an SM
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // rows whose loads a lane has in flight
constexpr int kMaxDim = 128;
constexpr int kMaxShared = 232448;  // the most dynamic shared memory a block can have
constexpr unsigned kFullMask = 0xffffffffu;

// The raw type of one lane read of V elements, and its f32 values.
template <typename T, int V> struct Raw;
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<float, 2> { using type = float2; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Raw<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };

// bf16 bits to f32 (exact): the bf16 is the f32's top half.
__device__ __forceinline__ float lo_bf16(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void to_float(float r, float* f) { f[0] = r; }
__device__ __forceinline__ void to_float(float2 r, float* f) { f[0] = r.x; f[1] = r.y; }
__device__ __forceinline__ void to_float(float4 r, float* f) {
  f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void to_float(unsigned short r, float* f) { f[0] = lo_bf16(r); }
__device__ __forceinline__ void to_float(unsigned int r, float* f) {
  f[0] = lo_bf16(r);
  f[1] = hi_bf16(r);
}
__device__ __forceinline__ void to_float(uint2 r, float* f) {
  to_float(r.x, f);
  to_float(r.y, f + 2);
}
__device__ __forceinline__ void to_float(uint4 r, float* f) {
  to_float(r.x, f);
  to_float(r.y, f + 2);
  to_float(r.z, f + 4);
  to_float(r.w, f + 6);
}

// First position in the non-decreasing a[0, n) whose value is >= v, by
// one warp: each step probes 32 positions that cut [lo, hi) into 33 parts.
__device__ int64_t warp_lower_bound(const int32_t* a, int64_t n, int32_t v, int lane) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t q = lo + (hi - lo) * (lane + 1) / 33;
    const int k = __popc(__ballot_sync(kFullMask, __ldg(a + q) < v));  // probes below v
    const int64_t nlo = k > 0 ? lo + (hi - lo) * k / 33 + 1 : lo;
    hi = k < 32 ? lo + (hi - lo) * (k + 1) / 33 : hi;
    lo = nlo;
  }
  return lo;
}

// Minimum of v over the block (every thread gets it). red: [kWarps].
__device__ int64_t block_min(int64_t v, int64_t* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFullMask, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = min(m, red[i]);
  __syncthreads();
  return m;
}

// dst[0, V) (+)= v[0, V): 16-byte shared accesses when V is a multiple of
// 4 (then D is too, so every row and vector is 16-byte aligned).
template <int V, bool kAdd>
__device__ __forceinline__ void put(float* dst, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      float4* p = reinterpret_cast<float4*>(dst) + q;
      float4 x = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      if (kAdd) {
        const float4 o = *p;
        x = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
      }
      *p = x;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = kAdd ? dst[e] + v[e] : v[e];
  }
}

// Lane geometry of a row of d columns read V at a time: n_vec vectors a
// row, `rows` lane groups a warp (32 / n_vec when a row fits in a warp).
__host__ __device__ constexpr int groups_of(int d, int v) {
  return d / v <= 32 ? 32 / (d / v) : 1;
}

// Shared memory: acc [band_rows*D] f32 | edge [slots*D] f32 | edge_seg
// [slots] int | starts [slots + 1] int | counts [2*kWarps] int | (8-byte
// aligned) red [kWarps] int64 | range [4] int64, with slots = 2 * kWarps *
// groups.
size_t shared_bytes(int band_rows, int d, int v) {
  const size_t slots = 2 * static_cast<size_t>(kWarps) * groups_of(d, v);
  return (static_cast<size_t>(band_rows) * d + slots * d) * 4 + (2 * slots + 1) * 4 +
         2 * kWarps * 4 + 4 + kWarps * 8 + 4 * 8;
}

constexpr int32_t kEmpty = INT_MIN;  // an edge slot no run was written to

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
tile_segreduce_tiles(const T* __restrict__ msgs, const int32_t* __restrict__ seg,
                     const int32_t* __restrict__ tile_map,
                     const int32_t* __restrict__ first, int64_t n_chunks, int ch,
                     int ot, int d, int n_splits, int n_bands, int band_rows,
                     float* __restrict__ dst, int32_t* __restrict__ dst_reset,
                     int32_t* __restrict__ dst_written) {
  using R = typename Raw<T, V>::type;
  constexpr int kJ = (kMaxDim / V + 31) / 32;  // column vectors a lane may own
  // Lane geometry: lane group grp of `rows` owns vectors vec + 32 jj of a row.
  const int n_vec = d / V;
  const int rows = groups_of(d, V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = n_vec <= 32 ? lane / n_vec : 0;
  const int vec = n_vec <= 32 ? lane - grp * n_vec : lane;
  const bool active = grp < rows;
  const int max_slots = 2 * kWarps * rows;

  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  float* edge = acc + static_cast<size_t>(band_rows) * d;
  int32_t* edge_seg = reinterpret_cast<int32_t*>(edge + static_cast<size_t>(max_slots) * d);
  int32_t* starts = edge_seg + max_slots;
  int32_t* counts = starts + max_slots + 1;
  int64_t* red = reinterpret_cast<int64_t*>(
      (reinterpret_cast<uintptr_t>(counts + 2 * kWarps) + 7) & ~uintptr_t{7});
  int64_t* range = red + kWarps;

  // Block (tile, split, band) sums split `split` of tile `tile` into the
  // tile's rows [band_lo, band_hi).
  const int band = blockIdx.x % n_bands;
  const int64_t ts = blockIdx.x / n_bands;  // tile * n_splits + split
  const int64_t tile = ts / n_splits;
  const int split = static_cast<int>(ts - tile * n_splits);
  const int band_lo = band * band_rows;
  const int band_hi = band_lo + band_rows < ot ? band_lo + band_rows : ot;
  if (warp == 0) {  // while the other warps zero the tile
    const int64_t lo = warp_lower_bound(tile_map, n_chunks, static_cast<int32_t>(tile), lane);
    const int64_t hi = warp_lower_bound(tile_map, n_chunks, static_cast<int32_t>(tile + 1), lane);
    const int64_t c_lo = lo + (hi - lo) * split / n_splits;
    const int64_t c_hi = lo + (hi - lo) * (split + 1) / n_splits;
    // What came before the split's last reset is discarded: start there.
    int64_t start = c_lo;
    for (int64_t top = c_hi; top > c_lo; top -= 32) {
      const int64_t c = top - 32 + lane;
      const unsigned m = __ballot_sync(kFullMask, c >= c_lo && first[c] == 1);
      if (m) {
        start = top - 32 + (31 - __clz(m));
        break;
      }
    }
    if (lane == 0) {
      range[0] = start * ch;
      range[1] = c_hi * ch;
      if (dst_reset != nullptr && band == 0) dst_reset[ts] = start < c_hi && first[start] == 1;
    }
  }
  const int64_t band_elems = static_cast<int64_t>(band_hi - band_lo) * d;
  if (band_elems % 4 == 0) {
    for (int64_t i = threadIdx.x; i < band_elems / 4; i += kThreads)
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int64_t i = threadIdx.x; i < band_elems; i += kThreads) acc[i] = 0.f;
  }
  __syncthreads();
  const int64_t a0 = range[0], a1 = range[1];
  const R* mrow = reinterpret_cast<const R*>(msgs);
  bool written = false;  // whether any arc fell in the band (the same in every thread)

  for (int64_t p0 = a0; p0 < a1;) {
    // The piece ends at the first descent of seg after p0.
    int64_t p1 = a1;
    for (int64_t j = p0 + 1 + threadIdx.x; j < a1; j += kThreads) {
      if (__ldg(seg + j) < __ldg(seg + j - 1)) { p1 = j; break; }
    }
    p1 = block_min(p1, red);
    // The piece's seg is non-decreasing: the band's rows are one run of it.
    if (n_bands > 1) {
      if (warp == 0) {
        const int64_t q0 = p0 + warp_lower_bound(seg + p0, p1 - p0, band_lo, lane);
        const int64_t q1 = q0 + warp_lower_bound(seg + q0, p1 - q0, band_hi, lane);
        if (lane == 0) { range[2] = q0; range[3] = q1; }
      }
      __syncthreads();
    }
    const int64_t q0 = n_bands > 1 ? range[2] : p0, q1 = n_bands > 1 ? range[3] : p1;
    written |= q1 > q0;

    // The slices of the piece's band rows [q0, q1): n_eff contiguous,
    // non-empty ones; slice i goes to lane group i % rows of warp i / rows,
    // which walks it alone, and writes its first run to edge slot 2i, its
    // last (when it has two or more) to slot 2i + 1.
    const int64_t len = q1 - q0;
    const int n_eff = static_cast<int>(len < kWarps * rows ? len : kWarps * rows);
    const int slice = warp * rows + grp;
    const bool mine = active && slice < n_eff;
    const int64_t j0 = mine ? q0 + len * slice / n_eff : 0;
    const int64_t j1 = mine ? q0 + len * (slice + 1) / n_eff : 0;
    if (mine && vec == 0) edge_seg[2 * slice + 1] = kEmpty;
    const int passes = static_cast<int>(__reduce_max_sync(kFullMask, static_cast<unsigned>(j1 - j0)));

    float run[kJ * V];
#pragma unroll
    for (int e = 0; e < kJ * V; ++e) run[e] = 0.f;
    int cur = 0;
    bool open = false, first_run = true;
    // The open run to an edge slot (slot >= 0), or onto its row of the band.
    auto flush = [&](int slot) {
      if (slot < 0 && (cur < band_lo || cur >= band_hi)) return;
      float* base = slot >= 0 ? edge + static_cast<int64_t>(slot) * d
                              : acc + static_cast<int64_t>(cur - band_lo) * d;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int v = vec + 32 * jj;
        if (v < n_vec) {
          if (slot >= 0) put<V, false>(base + v * V, run + jj * V);
          else put<V, true>(base + v * V, run + jj * V);
        }
      }
      if (slot >= 0 && vec == 0) edge_seg[slot] = cur;
    };
    for (int p = 0; p < passes; p += kUnroll) {
      R raw[kUnroll][kJ];
      int sv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = j0 + p + u;
        const bool in = mine && k < j1;
        sv[u] = in ? __ldg(seg + k) : 0;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int v = vec + 32 * jj;
          if (in && v < n_vec) raw[u][jj] = __ldcs(mrow + k * n_vec + v);
          else raw[u][jj] = R{};
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!mine || j0 + p + u >= j1) continue;
        if (!open || sv[u] != cur) {
          if (open) {  // close a run that is not the slice's last
            flush(first_run ? 2 * slice : -1);
            first_run = false;
          }
          open = true;
          cur = sv[u];
#pragma unroll
          for (int e = 0; e < kJ * V; ++e) run[e] = 0.f;
        }
        float f[kJ * V];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) to_float(raw[u][jj], f + jj * V);
#pragma unroll
        for (int e = 0; e < kJ * V; ++e) run[e] += f[e];
      }
    }
    if (open) flush(first_run ? 2 * slice : 2 * slice + 1);  // the slice's last run
    __syncthreads();

    // The edge runs, whose rows are non-decreasing in slot order: a slot
    // starts a row when its seg is in [0, OT) and differs from the previous
    // written slot's (slot 2i is always written; 2i+1 may be empty). The
    // starts are listed in slot order; warp q sums row q's slots in order.
    const int n_slots = 2 * n_eff;
    const int rounds = (n_slots + kThreads - 1) / kThreads;  // at most 2
    bool is_start[2];
    unsigned ballot[2];
    for (int r = 0; r < rounds; ++r) {
      const int e = r * kThreads + threadIdx.x;
      bool st = false;
      if (e < n_slots) {
        const int se = edge_seg[e];
        const int prev = e == 0 ? -1 : (edge_seg[e - 1] == kEmpty ? e - 2 : e - 1);
        st = se != kEmpty && se >= band_lo && se < band_hi && (prev < 0 || edge_seg[prev] != se);
      }
      is_start[r] = st;
      ballot[r] = __ballot_sync(kFullMask, st);
      if (lane == 0) counts[r * kWarps + warp] = __popc(ballot[r]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the counts (at most 64), in place
      const int n_counts = rounds * kWarps;
      const int c0 = lane < n_counts ? counts[lane] : 0;
      const int c1 = lane + 32 < n_counts ? counts[lane + 32] : 0;
      int x0 = c0, x1 = c1;
      for (int o = 1; o < 32; o <<= 1) {
        const int y0 = __shfl_up_sync(kFullMask, x0, o), y1 = __shfl_up_sync(kFullMask, x1, o);
        if (lane >= o) { x0 += y0; x1 += y1; }
      }
      const int total0 = __shfl_sync(kFullMask, x0, 31);
      if (lane < n_counts) counts[lane] = x0 - c0;
      if (lane + 32 < n_counts) counts[lane + 32] = total0 + x1 - c1;
      if (lane == 31) starts[max_slots] = total0 + x1;  // the number of rows
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      if (is_start[r])
        starts[counts[r * kWarps + warp] + __popc(ballot[r] & ((1u << lane) - 1))] = r * kThreads + threadIdx.x;
    }
    __syncthreads();
    const int n_rows = starts[max_slots];
    for (int q = warp; q < n_rows; q += kWarps) {
      const int e0 = starts[q], e1 = q + 1 < n_rows ? starts[q + 1] : n_slots;
      const int row = edge_seg[e0];
      float* out_row = acc + static_cast<int64_t>(row - band_lo) * d;
      for (int c = lane; c < d; c += 32) {
        float t = 0.f;
        for (int e = e0; e < e1; ++e)
          if (edge_seg[e] == row) t += edge[static_cast<int64_t>(e) * d + c];
        out_row[c] += t;
      }
    }
    p0 = p1;
  }
  __syncthreads();

  if (dst_written != nullptr) {  // a split's partial: the combine skips an unwritten band
    if (threadIdx.x == 0) dst_written[blockIdx.x] = written;
    if (!written) return;
  }
  float* out = dst + (n_splits == 1 ? tile : ts) * static_cast<int64_t>(ot) * d +
               static_cast<int64_t>(band_lo) * d;
  if (band_elems % 4 == 0 && (static_cast<int64_t>(ot) * d) % 4 == 0 && band_lo * d % 4 == 0) {
    for (int64_t i = threadIdx.x; i < band_elems / 4; i += kThreads)
      __stcs(reinterpret_cast<float4*>(out) + i, reinterpret_cast<const float4*>(acc)[i]);
  } else {
    for (int64_t i = threadIdx.x; i < band_elems; i += kThreads) out[i] = acc[i];
  }
}

// out[t, e] = sum of partial[t, s, e] over s from the last split of t that
// reset (0 when none did) to n_splits - 1, in split order, skipping the
// splits that wrote nothing to e's band. Four elements a thread when D is a
// multiple of 4 (W = 4: one row, one band), else one.
template <int W>
__global__ void tile_segreduce_combine(const float* __restrict__ partial,
                                       const int32_t* __restrict__ reset,
                                       const int32_t* __restrict__ written,
                                       int64_t n_tiles, int n_splits, int n_bands,
                                       int band_rows, int64_t tile_elems, int d,
                                       float* __restrict__ out) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
  if (i >= n_tiles * tile_elems) return;
  const int64_t t = i / tile_elems;
  const int64_t e = i - t * tile_elems;
  const int band = static_cast<int>(e / d / band_rows);
  int s0 = 0;
  for (int s = 0; s < n_splits; ++s)
    if (reset[t * n_splits + s]) s0 = s;
  float sum[W];
#pragma unroll
  for (int w = 0; w < W; ++w) sum[w] = 0.f;
  for (int s = s0; s < n_splits; ++s) {
    if (!written[(t * n_splits + s) * n_bands + band]) continue;
    const float* p = partial + (t * n_splits + s) * tile_elems + e;
    float v[W];
    if constexpr (W == 4) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      v[0] = __ldcs(p);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) sum[w] += v[w];
  }
  if constexpr (W == 4) {
    reinterpret_cast<float4*>(out)[i / 4] = make_float4(sum[0], sum[1], sum[2], sum[3]);
  } else {
    out[i] = sum[0];
  }
}

template <typename T, int V>
int launch_tiles(const void* msgs, const int32_t* seg, const int32_t* tile_map,
                 const int32_t* first, int64_t n_chunks, int ch, int ot, int d, int64_t blocks,
                 int n_splits, int n_bands, int band_rows, float* dst, int32_t* dst_reset,
                 int32_t* dst_written, cudaStream_t stream) {
  // Once per instance: the most dynamic shared memory a block may ask for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_segreduce_tiles<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (attr != cudaSuccess) return attr;
  tile_segreduce_tiles<T, V><<<static_cast<unsigned>(blocks), kThreads,
                               shared_bytes(band_rows, d, V), stream>>>(
      static_cast<const T*>(msgs), seg, tile_map, first, n_chunks, ch, ot, d, n_splits, n_bands,
      band_rows, dst, dst_reset, dst_written);
  return cudaSuccess;
}

template <typename T>
int launch(const void* msgs, const int32_t* seg, const int32_t* tile_map,
           const int32_t* first, int64_t n_chunks, int ch, int ot, int d, int vec,
           int64_t n_tiles, int n_splits, int n_bands, float* partial, int32_t* partial_reset,
           int32_t* partial_written, float* out, cudaStream_t stream) {
  if (d <= 0 || d > kMaxDim || ch <= 0 || ot <= 0 || n_splits <= 0 || vec <= 0 ||
      d % vec || vec * sizeof(T) > 16 || reinterpret_cast<uintptr_t>(msgs) % (vec * sizeof(T)) ||
      n_bands <= 0 || n_bands > ot)
    return cudaErrorInvalidValue;
  const int band_rows = (ot + n_bands - 1) / n_bands;
  if (shared_bytes(band_rows, d, vec) > static_cast<size_t>(kMaxShared))
    return cudaErrorInvalidValue;
  if (n_splits > 1 && (partial == nullptr || partial_reset == nullptr || partial_written == nullptr))
    return cudaErrorInvalidValue;
  if (n_tiles == 0) return cudaSuccess;
  const int64_t blocks = n_tiles * n_splits * n_bands;
  float* dst = n_splits == 1 ? out : partial;
  int32_t* dst_reset = n_splits == 1 ? nullptr : partial_reset;
  int32_t* dst_written = n_splits == 1 ? nullptr : partial_written;
  int rc = cudaErrorInvalidValue;
  switch (vec) {
    case 1: rc = launch_tiles<T, 1>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, blocks, n_splits, n_bands, band_rows, dst, dst_reset, dst_written, stream); break;
    case 2: rc = launch_tiles<T, 2>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, blocks, n_splits, n_bands, band_rows, dst, dst_reset, dst_written, stream); break;
    case 4: rc = launch_tiles<T, 4>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, blocks, n_splits, n_bands, band_rows, dst, dst_reset, dst_written, stream); break;
    case 8:
      if constexpr (sizeof(T) == 2)
        rc = launch_tiles<T, 8>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, blocks, n_splits, n_bands, band_rows, dst, dst_reset, dst_written, stream);
      break;
  }
  if (rc != cudaSuccess) return rc;
  if (n_splits > 1) {
    const int64_t tile_elems = static_cast<int64_t>(ot) * d;
    const int64_t total = n_tiles * tile_elems;
    constexpr int kCombineThreads = 256;
    if (d % 4 == 0) {
      tile_segreduce_combine<4><<<static_cast<unsigned>((total / 4 + kCombineThreads - 1) /
                                                        kCombineThreads),
                                  kCombineThreads, 0, stream>>>(
          partial, partial_reset, partial_written, n_tiles, n_splits, n_bands, band_rows,
          tile_elems, d, out);
    } else {
      tile_segreduce_combine<1><<<static_cast<unsigned>((total + kCombineThreads - 1) /
                                                        kCombineThreads),
                                  kCombineThreads, 0, stream>>>(
          partial, partial_reset, partial_written, n_tiles, n_splits, n_bands, band_rows,
          tile_elems, d, out);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// msgs: [n_chunks*ch, d] f32 or bf16, read `vec` elements a lane (d % vec
// == 0, vec*sizeof <= 16, msgs aligned to it); seg: [n_chunks*ch] int32;
// tile_map, first: [n_chunks] int32 (tile_map non-decreasing); out:
// [n_tiles*ot, d] f32. Each tile's rows are summed in n_bands bands of
// ceil(ot / n_bands) rows. With n_splits > 1, partial
// ([n_tiles*n_splits*ot*d] f32), partial_reset ([n_tiles*n_splits] int32)
// and partial_written ([n_tiles*n_splits*n_bands] int32) are scratch; with
// 1 they may be null.
extern "C" int tile_segreduce_f32(const void* msgs, const int32_t* seg,
                                  const int32_t* tile_map, const int32_t* first,
                                  int64_t n_chunks, int ch, int ot, int d, int vec,
                                  int64_t n_tiles, int n_splits, int n_bands, float* partial,
                                  int32_t* partial_reset, int32_t* partial_written, float* out,
                                  cudaStream_t stream) {
  return launch<float>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, vec, n_tiles,
                       n_splits, n_bands, partial, partial_reset, partial_written, out,
                       stream);
}

extern "C" int tile_segreduce_bf16(const void* msgs, const int32_t* seg,
                                   const int32_t* tile_map, const int32_t* first,
                                   int64_t n_chunks, int ch, int ot, int d, int vec,
                                   int64_t n_tiles, int n_splits, int n_bands, float* partial,
                                   int32_t* partial_reset, int32_t* partial_written, float* out,
                                   cudaStream_t stream) {
  return launch<__nv_bfloat16>(msgs, seg, tile_map, first, n_chunks, ch, ot, d, vec,
                               n_tiles, n_splits, n_bands, partial, partial_reset,
                               partial_written, out, stream);
}
