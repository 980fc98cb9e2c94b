// K1: neighbor counts for O(N^2 L) sequence reweighting, by hand for Hopper.
//
// Replaces the TPU kernel evcouplings_tpu/ops/weights_pallas.py
// _reweight_kernel (launched by _neighbor_counts_pallas). Same function:
// for every row i of an (n, L) int8 code matrix, the number of rows j < n
// whose identity count  sum_l [c_il == c_jl]  reaches min_count. A negative
// code (-1: gap in -g mode, padding) matches nothing, not even another -1.
// Row i counts itself when its own identity reaches min_count.
//
// Design. The TPU kernel expanded a one-hot in VMEM to feed its matrix
// unit. Here the count is taken directly on the codes: four int8 codes
// per 32-bit word, compared bytewise with integer bit tricks and counted
// with __popc. Neither the one-hot nor the N x N identity matrix exists
// anywhere; only the (n, L) codes are read from device memory (they fit
// in L2, so re-reading a tile per block pair is cheap).
//
//   grid (i-tile, j-tile), 64 x 64 rows per block, 256 threads;
//   each thread keeps a 4 x 4 micro-tile of identity counts in registers;
//   L is walked in chunks of 128 codes staged in shared memory (the codes
//   are byte-loaded, so any L works and the ragged edge pads with -1);
//   after the last chunk each thread thresholds its 16 counts, rows of a
//   block merge through shared-memory atomics, and each block adds its
//   per-row partial counts to the output with one int32 atomicAdd per
//   row. Integer atomics are exact and order-free; the output must be
//   zeroed by the caller.
//
// What bounds it: integer issue. Per word pair (4 sites) a thread spends
// xor, or, sub, one lop3 and a popc; the popc unit (16/clk/SM) is the
// narrowest. The identity GEMM route onto the int8 tensor cores would
// bound lower (2 N^2 L q ops at 1979 TOP/s) at the price of building the
// one-hot on chip; that is a later optimization, this kernel is the
// simple exact one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // rows of i and of j per block
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 pairs each
constexpr int kChunkCodes = 128;          // codes per staged chunk
constexpr int kChunkWords = kChunkCodes / 4;
constexpr int kRowWords = kChunkWords + 1;  // +1 word: conflict-free reads

// Number of sites where the four int8 codes of `a` and `b` are equal and
// valid (>= 0). `a_hi` is a | 0x7F7F7F7F, precomputed per i word.
//   x = a ^ b: byte zero iff the codes are equal.
//   s = (x | 0x80) - 1 per byte (no borrow crosses a byte): bit 7 set
//       iff the low seven bits of x are nonzero.
//   ~(s | x | a_hi): bit 7 of a byte survives iff x == 0 and a's sign bit
//       is clear (a valid code); every other bit is cleared by a_hi.
__device__ __forceinline__ int match_count(unsigned a_hi, unsigned a,
                                           unsigned b) {
  const unsigned x = a ^ b;
  const unsigned s = (x | 0x80808080u) - 0x01010101u;
  return __popc(~(s | x | a_hi));
}

__global__ void __launch_bounds__(kThreads)
neighbor_counts_kernel(const int8_t* __restrict__ codes, int n, int L,
                       int min_count, int* __restrict__ counts) {
  __shared__ unsigned s_i[kTile][kRowWords];
  __shared__ unsigned s_j[kTile][kRowWords];
  __shared__ int s_count[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;

  if (tid < kTile) s_count[tid] = 0;

  int ids[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) ids[u][v] = 0;

  unsigned char* si = reinterpret_cast<unsigned char*>(&s_i[0][0]);
  unsigned char* sj = reinterpret_cast<unsigned char*>(&s_j[0][0]);

  for (int l0 = 0; l0 < L; l0 += kChunkCodes) {
    // stage both tiles; consecutive threads read consecutive codes of a
    // row, and everything outside [0, n) x [0, L) becomes -1 (0xFF)
    for (int e = tid; e < kTile * kChunkCodes; e += kThreads) {
      const int r = e / kChunkCodes;
      const int c = e % kChunkCodes;
      const int l = l0 + c;
      const int gi = i0 + r;
      const int gj = j0 + r;
      si[r * kRowWords * 4 + c] =
          (gi < n && l < L)
              ? static_cast<unsigned char>(codes[(size_t)gi * L + l])
              : 0xFFu;
      sj[r * kRowWords * 4 + c] =
          (gj < n && l < L)
              ? static_cast<unsigned char>(codes[(size_t)gj * L + l])
              : 0xFFu;
    }
    __syncthreads();

    const int words = min(kChunkWords, (L - l0 + 3) / 4);
    for (int w = 0; w < words; ++w) {
      unsigned a[4], a_hi[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = s_i[ty + 16 * u][w];
        a_hi[u] = a[u] | 0x7F7F7F7Fu;
        b[u] = s_j[tx + 16 * u][w];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          ids[u][v] += match_count(a_hi[u], a[u], b[v]);
    }
    __syncthreads();
  }

  // threshold, mask j >= n, merge the block's partial counts per row
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int part = 0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      part += (j < n && ids[u][v] >= min_count) ? 1 : 0;
    }
    if (part) atomicAdd(&s_count[ty + 16 * u], part);
  }
  __syncthreads();
  if (tid < kTile) {
    const int i = i0 + tid;
    if (i < n && s_count[tid]) atomicAdd(&counts[i], s_count[tid]);
  }
}

}  // namespace

extern "C" {

// codes: (n, L) int8, row-major, contiguous. counts: (n,) int32, zeroed.
// Returns the cudaError_t of the launch.
int evc_neighbor_counts(const void* codes, int n, int L, int min_count,
                        void* counts, void* stream) {
  if (n <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, tiles);
  neighbor_counts_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), n, L, min_count,
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
