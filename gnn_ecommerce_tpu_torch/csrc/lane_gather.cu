// Lane-axis gather from a small resident table, written by hand for Hopper
// (sm_90a):
//
//   out[r, j] = tab[r, idx[j]]     tab [d, ni] bf16, idx [n] int32, out [d, n]
//
// It replaces two Pallas kernels that compute this same function:
// scripts/microbench_gather.py:208 t13 (K5, indices as [1, n] in blocks of
// [1, 4096]) and scripts/microbench_gather2.py:134 t_pallas_lane (K6,
// indices as [n/512, 512] in blocks of [8, 512], which each grid step
// reshapes to the same 4,096 consecutive indices). Both keep the whole
// [80, 54,571] table in VMEM and gather along its lane axis with
// take_along_axis. On the card both index layouts are one contiguous int32
// stream, so one kernel serves both; the wrapper counts K5's and K6's
// launches apart.
//
// Bound: the card must read the referenced table entries once, the indices
// (4 B each) and write d*n*2 bytes: at the probes' [80, 54,571] table and
// 10,153,984 indices, 8.7 MB + 40.6 MB + 1.625 GB, at least 0.50 ms at
// 3.35 TB/s. There is no arithmetic. A walk that takes one table row r per
// block and reads idx[j] for every (r, j) reads the 40.6 MB index stream d
// times (3.25 GB at d = 80, twice the output), and the stream does not stay
// in the 50 MB L2 beside the streamed output.
//
// Design: every input byte is read from device memory about once, in two
// passes (one call launches each once).
//
// transpose_pad  writes tabT [ni, dp] bf16 (the wrapper's scratch), dp = d
//                rounded up to a multiple of 8 so that every item's column
//                is one 16-byte aligned row (160 B at d = 80), pad entries
//                zero: 8.7 MB at the probes' shape, which then stays in L2.
// gather_windows takes a window of J = 256 consecutive indices and a band
//                of at most 128 table rows
//                (blockIdx.y): it copies the window's indices into shared
//                memory with 16-byte cp.async (L2 evict_first), then each
//                referenced tabT row's band, 16-byte cp.async pieces with an
//                L2 evict_last hint so that the table stays resident, into a
//                tile [J][P] of 16-byte pieces (P = band rows / 8). Each
//                thread then reads 8 pieces (8 consecutive j, the same 8
//                table rows), transposes the 8x8 bf16 block in registers
//                with byte permutes and writes 8 rows of out, 16 bytes each
//                with a streaming (evict-first) store; the 32 lanes of a
//                warp take 32 consecutive 8-j blocks, so each store
//                instruction writes 512 contiguous bytes. The grid is
//                persistent (as many blocks as fit on the card, split over
//                the bands); a block walks windows x, x + G, ... with the
//                tile and the index buffer double-buffered: the next
//                window's row copies and the one after's index copy are in
//                flight while the current window is written out. The last
//                window may be ragged (n % J != 0; n % 8 == 0 always).
//                The index stream is read once per band: once at d <= 128.
// Tile layout: piece c of window row j lies at j * P + (c + g) mod P, with
// g = (j / 8) mod 8 when P >= 8 (no rotation below: small d only). A
// quarter warp's 16-byte reads then take rows 8(jb + l) + v for 8
// consecutive jb and one piece: their rotations differ, so they fall on 8
// distinct 16-byte bank groups when P % 8 == 0 and on at most 2 of each
// otherwise (P = 10 at d = 80), where an unrotated [J][P] tile puts all 8
// on one bank group (rows 8 apart are 8P pieces apart, a multiple of 8).
// The fills, 32 consecutive pieces of the flattened [jn][P] walk a warp,
// meet at most 2 to a bank group.
//
// Rejected: staging table rows, not items, in shared memory. A [54,571] row
// is 109 KB, so at most 2 fit in a block's 227 KB, and the index stream
// would still be read d/2 = 40 times (1.6 GB, as much as the output).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC lane_gather.cu -o liblane_gather.so
// The C entry point launches both passes on the given stream and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 128;
// Windows of 128 to 512 indices timed alike at the probes' shape; 256 fits
// two blocks an SM at d = 80, and a band of any d fits in shared memory.
constexpr int kLog2Window = 8;
constexpr int kWindow = 1 << kLog2Window;
constexpr int kLog2Blocks = kLog2Window - 3;  // 8-j blocks a window

__host__ __device__ constexpr int band_pieces(int dp, int r0) {
  return (dp - r0 < kBandRows ? dp - r0 : kBandRows) / 8;
}

// bf16 values are moved as their 16-bit patterns: no conversion.
__global__ void __launch_bounds__(kThreads)
transpose_pad(const uint16_t* __restrict__ tab, int64_t ni, int d, int dp,
              uint16_t* __restrict__ tabT) {
  __shared__ uint16_t t[32][34];  // odd word stride: the column reads hit 32 banks
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const int r = r0 + ty + k;
    const int64_t c = c0 + tx;
    t[ty + k][tx] = (r < d && c < ni) ? tab[r * ni + c] : uint16_t{0};
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const int64_t c = c0 + ty + k;
    const int r = r0 + tx;
    if (c < ni && r < dp) tabT[c * dp + r] = t[tx][ty + k];
  }
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, uint64_t policy) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory: idx_s [2][kWindow] int32, then tile [2][kWindow * pmax]
// 16-byte pieces (pmax: the widest band's pieces a row), at most 130 KB.
__global__ void __launch_bounds__(kThreads)
gather_windows(const uint16_t* __restrict__ tabT, int d, int dp, const int32_t* __restrict__ idx,
               int64_t n, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * kBandRows;
  const int P = band_pieces(dp, r0);
  const int stage = kWindow * band_pieces(dp, 0) * 8;  // tile elements a buffer
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem);
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem + 2 * kWindow * sizeof(int32_t));
  const int64_t n_windows = (n + kWindow - 1) >> kLog2Window;
  const int64_t G = gridDim.x;
  int64_t w = blockIdx.x;
  if (w >= n_windows) return;
  const bool rotate = P >= 8;
  const int tid = threadIdx.x;
  // The fill walk: piece p = tid + k * kThreads of a window's flattened
  // [jn][P] pieces is row p / P, piece p % P, stepped without a division.
  const int jj0 = tid / P, c0 = tid - jj0 * P;
  const int djj = kThreads / P, dc = kThreads - djj * P;
  const uint64_t keep = l2_policy_evict_last(), stream = l2_policy_evict_first();

  auto rows_in = [&](int64_t win) {
    const int64_t left = n - (win << kLog2Window);
    return left < kWindow ? static_cast<int>(left) : kWindow;
  };
  auto load_idx = [&](int64_t win, int buf) {
    const int32_t* src = idx + (win << kLog2Window);
    int32_t* dst = idx_s + buf * kWindow;
    for (int p = tid; p < rows_in(win) / 4; p += kThreads) cp_async16(dst + 4 * p, src + 4 * p, stream);
  };
  auto load_rows = [&](int64_t win, int buf) {
    const int jn = rows_in(win);
    const int32_t* ix = idx_s + buf * kWindow;
    uint16_t* t = tile + buf * stage;
    const uint16_t* band = tabT + r0;
    int jj = jj0, c = c0;
    while (jj < jn) {
      int ph = c + (rotate ? (jj >> 3) & 7 : 0);
      if (ph >= P) ph -= P;
      cp_async16(t + (jj * P + ph) * 8, band + static_cast<int64_t>(ix[jj]) * dp + 8 * c, keep);
      jj += djj;
      c += dc;
      if (c >= P) {
        c -= P;
        ++jj;
      }
    }
  };
  auto store = [&](int64_t win, int buf) {
    const int jn = rows_in(win);
    const uint16_t* t = tile + buf * stage;
    const int64_t j0 = win << kLog2Window;
    for (int u = tid; u < (P << kLog2Blocks); u += kThreads) {
      const int rb = u >> kLog2Blocks, jb = u & ((1 << kLog2Blocks) - 1);
      if (8 * jb >= jn) continue;
      int ph = rb + (rotate ? jb & 7 : 0);
      if (ph >= P) ph -= P;
      uint32_t a[8][4];  // a[v]: table rows 8rb..8rb+7 (bf16 pairs) at j = 8jb + v
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const uint4 x = *reinterpret_cast<const uint4*>(t + ((8 * jb + v) * P + ph) * 8);
        a[v][0] = x.x;
        a[v][1] = x.y;
        a[v][2] = x.z;
        a[v][3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = r0 + 8 * rb + q;
        if (r >= d) break;
        const uint32_t sel = (q & 1) ? 0x7632 : 0x5410;  // high or low halves
        const int m = q >> 1;
        const uint4 b = make_uint4(__byte_perm(a[0][m], a[1][m], sel), __byte_perm(a[2][m], a[3][m], sel),
                                   __byte_perm(a[4][m], a[5][m], sel), __byte_perm(a[6][m], a[7][m], sel));
        __stcs(reinterpret_cast<uint4*>(out + r * n + j0 + 8 * jb), b);
      }
    }
  };

  load_idx(w, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  load_rows(w, 0);
  if (w + G < n_windows) load_idx(w + G, 1);
  cp_async_commit();
  for (int buf = 0;; buf ^= 1) {
    cp_async_wait_all();  // this window's rows and the next window's indices
    __syncthreads();
    const int64_t next = w + G;
    if (next < n_windows) {
      load_rows(next, buf ^ 1);
      if (next + G < n_windows) load_idx(next + G, buf);
      cp_async_commit();
    }
    store(w, buf);
    if (next >= n_windows) break;
    __syncthreads();  // tile[buf] and idx_s[buf] are free for the next fills
    w = next;
  }
}

}  // namespace

// tab: [d, ni] contiguous bf16, d <= 65535; idx: [n] int32 in [0, ni),
// n % 8 == 0, 16-byte aligned; tabT: [ni, dp] bf16 scratch (dp = d rounded
// up to 8), 16-byte aligned; out: [d, n] bf16, 16-byte aligned.
extern "C" int lane_gather_bf16(const void* tab, int64_t ni, int d, const int32_t* idx, int64_t n,
                                void* tabT, void* out, cudaStream_t stream) {
  if (d <= 0 || d > 65535 || ni <= 0 || n < 0 || n % 8 ||
      reinterpret_cast<uintptr_t>(idx) % 16 || reinterpret_cast<uintptr_t>(tabT) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int dp = (d + 7) / 8 * 8;
  const dim3 tgrid(static_cast<unsigned>((ni + 31) / 32), (dp + 31) / 32);
  transpose_pad<<<tgrid, kThreads, 0, stream>>>(static_cast<const uint16_t*>(tab), ni, d, dp,
                                                static_cast<uint16_t*>(tabT));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t shared = 2 * kWindow * sizeof(int32_t) + 2 * kWindow * band_pieces(dp, 0) * 16;
  err = cudaFuncSetAttribute(gather_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_windows, kThreads, shared)) ||
      (err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int bands = (dp + kBandRows - 1) / kBandRows;
  const int64_t n_windows = (n + kWindow - 1) / kWindow;
  const int64_t blocks = per_sm * sms / bands < n_windows ? per_sm * sms / bands : n_windows;
  const dim3 grid(static_cast<unsigned>(blocks > 0 ? blocks : 1), bands);
  gather_windows<<<grid, kThreads, shared, stream>>>(static_cast<const uint16_t*>(tabT), d, dp, idx, n,
                                                     static_cast<uint16_t*>(out));
  return cudaGetLastError();
}
