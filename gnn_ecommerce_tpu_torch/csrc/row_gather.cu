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
// [N, 128] bf16 rows (256 B). Rows are split into index blocks of `chunk`
// rows (n % chunk == 0, the probe's rule). Two paths; the wrapper chooses by
// row bytes (ops/_kernels.py: RowGatherKernel.path):
//
// bulk   The card's counterpart of the TPU's per-row DMA: the bulk copy
//        engine (TMA, cp.async.bulk). A block is one warp whose lane 0 runs
//        a pipeline: a ring of k_inflight row slots in shared memory, each
//        row copied global -> shared by one bulk copy that completes on the
//        slot's mbarrier, then shared -> global by one bulk store
//        (bulk_group). k_inflight - 1 loads and the stores behind them are
//        in flight at once; no lane touches a row's bytes. The grid is
//        persistent (the wrapper sizes it to the card): block b of G copies
//        the contiguous rows [n*b/G, n*(b+1)/G) in windows of `chunk`, and
//        bulk-copies the next window's indices (their 16-byte covering span,
//        so any 4-byte-aligned index array works) into the other half of a
//        double buffer while the current window's rows move. Each half is
//        chunk + 8 indices rounded up to a multiple of 4, so both start
//        16-byte aligned, as a bulk copy's destination must, at any chunk.
// lanes  Block b copies index block b, first staging its indices in shared
//        memory. Each warp takes groups of K = k_inflight row slots. A slot
//        is one row, or 32/V rows when a row's V 16-byte vectors fill fewer
//        than 32 lanes. For each 512-byte slab of its rows the warp issues K
//        16-byte loads per lane (one from each slot, neighbouring lanes on
//        neighbouring addresses) before it stores any of them.
// Offsets are 64-bit (the probe's tile-row output is 4.29 GB). Indices must
// lie in [0, N); the kernel does not check them.
//
// Bound: the card must read each referenced table row once, the indices
// (4 B each), and write n*row_bytes. Reading each gathered row again, as a
// gather without reuse does, moves n*row_bytes both ways: 5.2 GB at the
// probe's [N, 128] bf16 shape (at least 1.56 ms at 3.35 TB/s) and 8.6 GB at
// its [N, 8, 128] f32 shape (2.56 ms). There is no arithmetic. The tile-row
// table (2.15 GB) is 43x the 50 MB L2 and each row is drawn about twice at
// random times, so the gather bound is the practical floor there.
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
constexpr int kIndexPad = 8;      // a covering span's extra indices (< 16 bytes each side)

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// shared -> global, one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the newest N bulk groups have finished reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Indices in each half of the bulk path's double buffer: a window's covering
// span, rounded up to 16 bytes so the second half starts 16-byte aligned.
__host__ __device__ __forceinline__ int index_stride(int chunk) {
  return (chunk + kIndexPad + 3) & ~3;
}

// Shared memory of one bulk block: ring [K][row_bytes] | indices
// [2][index_stride(chunk)] int32 | barriers full[K], index[2].
size_t bulk_shared_bytes(int k, int64_t row_bytes, int chunk) {
  return static_cast<size_t>(k) * row_bytes + 2 * static_cast<size_t>(index_stride(chunk)) * 4 +
         static_cast<size_t>(k + 2) * 8;
}

// Rows [n*b/G, n*(b+1)/G) of block b of G: contiguous ranges that differ by
// at most one row, so no block waits on a last index block of its own.
__device__ __forceinline__ int64_t range_start(int64_t n, int64_t b, int64_t g) { return n * b / g; }

template <int K>
__global__ void __launch_bounds__(32)
row_gather_bulk(const char* __restrict__ table, const int32_t* __restrict__ idx, int64_t n,
                int chunk, unsigned row_bytes, char* __restrict__ out) {
  if (threadIdx.x != 0) return;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  int32_t* ibuf = reinterpret_cast<int32_t*>(smem + static_cast<size_t>(K) * row_bytes);
  const int ibuf_len = index_stride(chunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(ibuf + 2 * ibuf_len);
  uint64_t* ibar = full + K;
  const int64_t r0 = range_start(n, blockIdx.x, gridDim.x);
  const int64_t n_rows = range_start(n, blockIdx.x + 1, gridDim.x) - r0;
  if (n_rows <= 0) return;
#pragma unroll
  for (int s = 0; s < K; ++s) mbar_init(full + s);
  mbar_init(ibar);
  mbar_init(ibar + 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // The block walks its rows in windows of `chunk` indices; window i's
  // indices (their 16-byte covering span) go to buffer i % 2.
  const int64_t n_windows = (n_rows + chunk - 1) / chunk;
  int ioff[2] = {0, 0};  // where window i's first index sits in its buffer
  auto load_indices = [&](int64_t i) {
    const int64_t lo_row = r0 + i * chunk;
    const int64_t len = n_rows - i * chunk < chunk ? n_rows - i * chunk : chunk;
    const char* first = reinterpret_cast<const char*>(idx + lo_row);
    const char* lo = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15});
    const char* hi = reinterpret_cast<const char*>(
        (reinterpret_cast<uintptr_t>(first + 4 * len) + 15) & ~uintptr_t{15});
    const int b = static_cast<int>(i & 1);
    ioff[b] = static_cast<int>((first - lo) / 4);
    const unsigned bytes = static_cast<unsigned>(hi - lo);
    mbar_expect(ibar + b, bytes);
    bulk_load(ibuf + b * ibuf_len, lo, bytes, ibar + b);
  };
  auto load_row = [&](int64_t t) {
    const int64_t i = t / chunk;
    const int r = static_cast<int>(t - i * chunk);
    const int b = static_cast<int>(i & 1);
    if (r == 0) {  // the first row of window i: its indices must have landed
      mbar_wait(ibar + b, static_cast<unsigned>((i >> 1) & 1));
      if (i + 1 < n_windows) load_indices(i + 1);  // buffer (i+1)%2 held window i-1, all issued
    }
    const int s = static_cast<int>(t % K);
    const int64_t row = ibuf[b * ibuf_len + ioff[b] + r];
    mbar_expect(full + s, row_bytes);
    bulk_load(ring + static_cast<size_t>(s) * row_bytes, table + row * row_bytes, row_bytes,
              full + s);
  };

  load_indices(0);
  for (int64_t t = 0; t < K && t < n_rows; ++t) load_row(t);
  for (int64_t t = 0; t < n_rows; ++t) {
    const int s = static_cast<int>(t % K);
    mbar_wait(full + s, static_cast<unsigned>((t / K) & 1));
    bulk_store(out + (r0 + t) * row_bytes, ring + static_cast<size_t>(s) * row_bytes, row_bytes);
    // Refill the slot of row t-1 once its store has read it: at most the
    // newest group (row t's) is still reading.
    if (t >= 1 && t - 1 + K < n_rows) {
      bulk_wait_read<1>();
      load_row(t - 1 + K);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int K>
void launch_lanes(const void* table, const int32_t* idx, int64_t n, int64_t vecs, int chunk,
                  void* out, cudaStream_t stream) {
  row_gather_rows<K><<<static_cast<unsigned>(n / chunk), kThreads,
                       static_cast<size_t>(chunk) * sizeof(int32_t), stream>>>(
      static_cast<const uint4*>(table), idx, vecs, chunk, static_cast<uint4*>(out));
}

template <int K>
int launch_bulk(const void* table, const int32_t* idx, int64_t n, int64_t row_bytes, int chunk,
                int blocks, void* out, cudaStream_t stream) {
  // Once per instance: the most dynamic shared memory a block may ask for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      row_gather_bulk<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  const size_t shmem = bulk_shared_bytes(K, row_bytes, chunk);
  if (shmem > 232448 || row_bytes > (1 << 20)) return cudaErrorInvalidValue;
  row_gather_bulk<K><<<static_cast<unsigned>(blocks), 32, shmem, stream>>>(
      static_cast<const char*>(table), idx, n, chunk, static_cast<unsigned>(row_bytes),
      static_cast<char*>(out));
  return cudaSuccess;
}

}  // namespace

// table: [N, row_bytes] 16-byte aligned; idx: [n] int32 in [0, N), 4-byte
// aligned; out: [n, row_bytes] 16-byte aligned; n % chunk == 0; k_inflight
// in {4, 8, 16} (the probe's). path 0: lanes; path 1: bulk over `blocks`
// persistent blocks (1 <= blocks <= n / chunk).
extern "C" int row_gather(const void* table, const int32_t* idx, int64_t n,
                          int64_t row_bytes, int k_inflight, int chunk, int path, int blocks,
                          void* out, cudaStream_t stream) {
  if (row_bytes <= 0 || row_bytes % 16 || chunk <= 0 || chunk > kMaxChunk || n % chunk ||
      reinterpret_cast<uintptr_t>(table) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(idx) % 4)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int rc = cudaSuccess;
  if (path == 0) {
    const int64_t vecs = row_bytes / 16;
    switch (k_inflight) {
      case 4: launch_lanes<4>(table, idx, n, vecs, chunk, out, stream); break;
      case 8: launch_lanes<8>(table, idx, n, vecs, chunk, out, stream); break;
      case 16: launch_lanes<16>(table, idx, n, vecs, chunk, out, stream); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (path == 1) {
    if (blocks < 1 || blocks > n / chunk) return cudaErrorInvalidValue;
    switch (k_inflight) {
      case 4: rc = launch_bulk<4>(table, idx, n, row_bytes, chunk, blocks, out, stream); break;
      case 8: rc = launch_bulk<8>(table, idx, n, row_bytes, chunk, blocks, out, stream); break;
      case 16: rc = launch_bulk<16>(table, idx, n, row_bytes, chunk, blocks, out, stream); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
