// K1: neighbor counts for O(N^2 L) sequence reweighting, by hand for Hopper.
//
// Replaces the TPU kernel evcouplings_tpu/ops/weights_pallas.py
// _reweight_kernel (launched by _neighbor_counts_pallas). Same function:
// for every row i of an (n, L) int8 code matrix, the number of rows j < n
// whose identity count  sum_l [c_il == c_jl]  reaches min_count. A negative
// code (-1: gap in -g mode, padding) matches nothing, not even another -1.
// Row i counts itself when its own identity reaches min_count.
//
// Design: the identity matrix is the product onehot . onehot^T, taken on
// the int8 tensor cores (wgmma s8 x s8 -> s32, exact), as the TPU kernel
// took it on its matrix unit. Neither the one-hot nor the N x N identity
// matrix is written to device memory.
//   - K layout: one 32-byte slab per site and per 32 symbols (q <= 32: one
//     slab per site, so one wgmma k-step of depth 32 is one site; q = 21
//     pays 32/21 of the dense products for an expansion that is a handful
//     of integer operations per row). Byte s of slab t of site l is
//     [c_l == 32 t + s]; a negative code gives an all-zero slab.
//   - Tiles: 128 i rows x 128 j rows per block, 256 threads = two
//     warpgroups; warpgroup w multiplies i rows [64w, 64w + 64) by all 128
//     j rows with wgmma m64n128k32, both operands K-major in shared memory
//     (no swizzle: 8-row x 16-byte core matrices), int32 accumulators in
//     registers. Only tiles with j-tile >= i-tile are launched: the
//     relation is symmetric, so an off-diagonal tile adds its row sums to
//     counts[i] and its column sums to counts[j], and a diagonal tile adds
//     its row sums once. Int32 atomics are exact and order-free; the
//     output must be zeroed by the caller.
//   - Codes: the wrapper pads every row to Lp sites, a multiple of 32,
//     with -1 (16-byte aligned rows). Each thread keeps the codes of the
//     row it expands (A rows for threads 0-127, B rows for 128-255) for 32
//     sites in registers, two 16-byte loads, and loads the next 32 while
//     the current ones are multiplied: no shared-memory staging of codes
//     and no barrier for it.
//   - Pipeline: per group of kGroup k-steps every thread expands its
//     row's 32-byte slabs (two 64-bit words per 16-byte half) into one of
//     three buffers, fences the generic-proxy writes for the async proxy,
//     and each warpgroup issues the group's kGroup wgmmas and keeps that
//     group in flight while the next one is expanded (three buffers: a
//     buffer is written again only after every warpgroup has waited for
//     the products that read it). One barrier and one fence per group.
//     K-steps run slab-major within a 32-site chunk ((t, site), not
//     (site, t)): the sum is an integer, so the order is free.
//   - Epilogue: threshold at min_count, mask i >= n and j >= n, reduce the
//     0/1 tile along rows (quad shuffles) and columns (shuffles, then
//     shared-memory atomics), and add to counts with int32 atomics.
//   - Range launch: evc_neighbor_counts_range launches only the tiles
//     [block_begin, block_begin + block_count) of the row-by-row numbering,
//     with the same epilogue into a zeroed full-length counts vector. R
//     launches over R ranges that cover every tile add up, by an int32 sum,
//     to the counts of one whole launch (the ranks of a sharded run each
//     launch one range and all-reduce their counts).
//
// What bounds it: int8 tensor-core operations, N(N+1)/2 pairs x 2 x 32 S L
// (S = slabs per site) at 1979 TOP/s; the codes (N Lp bytes) fit in L2.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                 // i rows and j rows per block
constexpr int kThreads = 256;              // two warpgroups
constexpr int kChunk = 32;                 // sites of codes per register load
constexpr int kGroup = 4;                  // k-steps per barrier
constexpr int kBufs = 3;                   // groups of slabs in flight
constexpr int kHalf = kTile * 16;          // bytes of one 16-byte K half
constexpr int kSlab = 2 * kHalf;           // bytes of one 128 x 32 slab

struct alignas(128) Smem {
  // slab layout (K-major, no swizzle): byte k of row r at
  //   (k / 16) * kHalf + r * 16 + k % 16
  // i.e. core matrices of 8 rows x 16 bytes, 128 bytes apart along the
  // rows (SBO) and kHalf bytes apart along K (LBO)
  uint8_t a[kBufs][kGroup][kSlab];
  uint8_t b[kBufs][kGroup][kSlab];
  int col_count[kTile];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading byte
// offset (K direction), stride byte offset (8-row groups), no swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// d[64] += A (64 x 32, s8) . B (128 x 32, s8)^T, both K-major.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Number of the first tile of tile row t of the upper triangle: tiles
// (ti, tj), tj >= ti, numbered row by row.
__device__ __forceinline__ long long row_start(long long t, long long T) {
  return t * T - t * (t - 1) / 2;
}

__global__ void __launch_bounds__(kThreads, 2)
neighbor_counts_kernel(const int8_t* __restrict__ codes, int n, int Lp,
                       int slabs, int min_count, int tiles,
                       long long block_begin, int* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;

  // upper-triangle tile of this block
  const long long T = tiles;
  const long long bid = block_begin + blockIdx.x;
  long long ti = static_cast<long long>(
      ((2.0 * T + 1.0) -
       sqrt((2.0 * T + 1.0) * (2.0 * T + 1.0) - 8.0 * bid)) / 2.0);
  if (ti < 0) ti = 0;
  while (ti > 0 && row_start(ti, T) > bid) --ti;
  while (ti + 1 < T && row_start(ti + 1, T) <= bid) ++ti;
  const long long tj = ti + (bid - row_start(ti, T));
  const bool diag = ti == tj;
  const int i0 = static_cast<int>(ti) * kTile;
  const int j0 = static_cast<int>(tj) * kTile;

  if (tid < kTile) sm.col_count[tid] = 0;

  const int wg = tid / 128;
  const int erow = tid % 128;  // the row this thread expands
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  const uint32_t a_off = static_cast<uint32_t>(wg * 64 * 16);
  // this thread's row: its codes for kChunk sites in registers, the next
  // chunk loaded while the current one is multiplied (rows past n read as
  // -1, i.e. all-zero slabs)
  const int row = (wg ? j0 : i0) + erow;
  const uint4* src = reinterpret_cast<const uint4*>(
      codes + static_cast<size_t>(row < n ? row : 0) * Lp);
  const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);
  uint4 cur0 = row < n ? src[0] : none;
  uint4 cur1 = row < n ? src[1] : none;
  const int chunks = Lp / kChunk;
  int group = 0;
  for (int c = 0; c < chunks; ++c) {
    uint4 nxt0 = none, nxt1 = none;
    if (c + 1 < chunks && row < n) {
      nxt0 = src[2 * c + 2];
      nxt1 = src[2 * c + 3];
    }
    const uint32_t cw[8] = {cur0.x, cur0.y, cur0.z, cur0.w,
                            cur1.x, cur1.y, cur1.z, cur1.w};
    for (int t = 0; t < slabs; ++t) {
#pragma unroll
      for (int s0 = 0; s0 < kChunk; s0 += kGroup, ++group) {
        const int buf = group % kBufs;
        // expand: slab t of the group's kGroup sites of this row (A rows
        // in warpgroup 0, B rows in warpgroup 1) as two 16-byte halves of
        // 64-bit words, byte s = [code == 32 t + s]
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int site = s0 + j;
          const int code =
              static_cast<int8_t>(cw[site / 4] >> (8 * (site % 4)));
          const int sym = code - 32 * t;
          const int sv = (code >= 0 && sym >= 0 && sym < 32) ? sym : 32;
          const unsigned long long bit = 1ull << (8 * (sv & 7));
          const int word = sv >> 3;  // 4: no symbol of this slab
          uint8_t* slab = wg ? sm.b[buf][j] : sm.a[buf][j];
          *reinterpret_cast<ulonglong2*>(slab + erow * 16) = make_ulonglong2(
              word == 0 ? bit : 0ull, word == 1 ? bit : 0ull);
          *reinterpret_cast<ulonglong2*>(slab + kHalf + erow * 16) =
              make_ulonglong2(word == 2 ? bit : 0ull, word == 3 ? bit : 0ull);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();

        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          wgmma_m64n128k32(
              d, make_desc(smem_u32(sm.a[buf][j]) + a_off, kHalf, 128),
              make_desc(smem_u32(sm.b[buf][j]), kHalf, 128));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // keep one group in flight: the one that read buffer
        // (group - 1) % 3 may still run, the one before it has finished
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      }
    }
    cur0 = nxt0;
    cur1 = nxt1;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // epilogue. Accumulator layout of m64nNk32: warp v of the warpgroup
  // holds rows 16 v + lane / 4 (d[4c + 0..1]) and + 8 (d[4c + 2..3]),
  // columns 8 c + 2 (lane % 4) + 0..1.
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int gi0 = i0 + r0;
  const int gi1 = gi0 + 8;
  int row0 = 0, row1 = 0;
  int col[32];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool jv = j0 + 8 * c + 2 * (lane % 4) + e < n;
      const int x0 = (jv && gi0 < n && d[4 * c + e] >= min_count) ? 1 : 0;
      const int x1 = (jv && gi1 < n && d[4 * c + 2 + e] >= min_count) ? 1 : 0;
      row0 += x0;
      row1 += x1;
      col[2 * c + e] = x0 + x1;
    }
  }
  row0 += __shfl_xor_sync(0xffffffffu, row0, 1);
  row0 += __shfl_xor_sync(0xffffffffu, row0, 2);
  row1 += __shfl_xor_sync(0xffffffffu, row1, 1);
  row1 += __shfl_xor_sync(0xffffffffu, row1, 2);
  if (lane % 4 == 0) {
    if (row0) atomicAdd(&counts[gi0], row0);
    if (row1) atomicAdd(&counts[gi1], row1);
  }
  if (!diag) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      int v = col[k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      col[k] = v;
    }
    if (lane < 4) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (col[k]) atomicAdd(&sm.col_count[8 * (k / 2) + 2 * lane + k % 2],
                              col[k]);
    }
    __syncthreads();
    if (tid < kTile && j0 + tid < n && sm.col_count[tid])
      atomicAdd(&counts[j0 + tid], sm.col_count[tid]);
  }
}

}  // namespace

extern "C" {

// codes: (n, Lp) int8, row-major, contiguous, 16-byte aligned, Lp a
// multiple of 32 (padded with -1); symbols 0 .. q-1 and negative codes
// that match nothing; q <= 127. counts: (n,) int32, zeroed. Launches the
// upper-triangle tiles [block_begin, block_begin + block_count) of the
// ceil(n / 128) x ceil(n / 128) tile grid, numbered row by row (no launch
// for an empty range). Returns the cudaError_t of the launch.
int evc_neighbor_counts_range(const void* codes, int n, int Lp, int q,
                              int min_count, long long block_begin,
                              long long block_count, void* counts,
                              void* stream) {
  if (n <= 0 || Lp <= 0 || Lp % kChunk || q < 0 || q > 127 ||
      reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = q > 0 ? (q + 31) / 32 : 1;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (block_begin < 0 || block_count < 0 ||
      block_begin + block_count > blocks || block_count > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_count == 0) return static_cast<int>(cudaSuccess);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      neighbor_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  neighbor_counts_kernel<<<static_cast<unsigned>(block_count), kThreads,
                           smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, Lp, slabs, min_count,
      static_cast<int>(tiles), block_begin, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The whole upper triangle: every tile in one launch.
int evc_neighbor_counts(const void* codes, int n, int Lp, int q,
                        int min_count, void* counts, void* stream) {
  const long long tiles = n > 0 ? (n + kTile - 1) / kTile : 0;
  return evc_neighbor_counts_range(codes, n, Lp, q, min_count, 0,
                                   tiles * (tiles + 1) / 2, counts, stream);
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
