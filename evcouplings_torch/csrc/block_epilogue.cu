// K6: the bf16 row block's epilogue of the PLM value+grad in one pass: the
// softmax, the per-site sums, the NLL terms and the residual of each row
// of a block of logits.
//
// Per row s of logits x (B, Lq = L q, the bf16 output of the logits
// product), codes c (B, L) int8 (-1: gap or padding, m = 0) and weights
// w (B,) float32, in float32 registers:
//
//     rowmax = max_k x[k]
//     e[k]   = exp(max(x[k] - rowmax, floor))          (floor = -80)
//     Z[r]   = sum of e over site r's q lanes, in lane order
//     term   = sum_r m_r (x[r, c_r] - rowmax - log Z[r])
//     r[k]   = w (e[k] m_r / Z[r] - onehot[k])         rounded once to bf16
//     t      = w term                                  float32, one per row
//
// It replaces no Pallas kernel: the JAX package leaves this epilogue to
// XLA, which fuses it into the passes around the logits product. Eager
// PyTorch ran it as some fifteen kernels over (B, Lq) tensors, each
// reading or writing the whole block (61% of the production fit's device
// time on an H100 at 8192 x 3360).
//
// What bounds it: device-memory bytes. A row reads its Lq bf16 logits
// and L int8 codes once and writes its Lq bf16 residuals once: at
// 8192 x 3360 a block is 111.5 MB, 33 us at 3.35 TB/s. The exponentials
// (Lq per row) come close behind, so they are full-precision expf but
// each computed once.
//
// Design. One warp per row, kWarps rows per block, no block-wide
// barrier. The warp copies its row into shared memory with 16-byte
// loads where the rows are 16-byte aligned (2-byte ones otherwise),
// taking the row's max on the way (a max is exact in any order); then
// each lane takes whole sites (lane, lane + 32, ...): it reads the
// site's q logits from shared memory, sums their exponentials in lane
// order, and writes the site's residuals back in place; then the warp
// stores the row with 16-byte stores. The row's term is summed over the
// lanes by a fixed butterfly of shuffles. Every sum has a fixed order
// and nothing is atomic, so K6 is bitwise deterministic; it allocates
// nothing and never reads the host, so a CUDA graph captures it. With
// Q = 21 (the amino-acid alphabet with its gap) a site's exponentials
// stay in registers between the sum and the residual; for any other q
// they are computed again (Q = 0).
//
// No fast-math: expf, logf and the division are the IEEE-accurate ones.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // rows (warps) per block, at most
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float max8(uint4 u, float m) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    m = fmaxf(m, fmaxf(f.x, f.y));
  }
  return m;
}

// Q: the states per site at compile time (21), or 0 for a runtime q.
// VEC: rows of logits and residuals 16-byte aligned and Lq a multiple of 8.
template <int Q, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
k6_block_epilogue(const __nv_bfloat16* __restrict__ x, long long ldx,
                  const int8_t* __restrict__ codes, long long ldc,
                  const float* __restrict__ w, __nv_bfloat16* __restrict__ r,
                  long long ldr, float* __restrict__ terms, int B, int L,
                  int q_rt, int row_elems, float floor_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = Q > 0 ? Q : q_rt;
  const int lq = L * q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                        + warp;
  if (row >= B) return;
  __nv_bfloat16* buf =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * row_elems;
  const __nv_bfloat16* xr = x + row * ldx;
  __nv_bfloat16* rr = r + row * ldr;
  const int8_t* cr = codes + row * ldc;

  // the row into shared memory, and its max
  float mx = -INFINITY;
  if constexpr (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(xr);
    uint4* dst = reinterpret_cast<uint4*>(buf);
    const int nv = lq / 8;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      uint4 u = __ldcs(src + v);
      dst[v] = u;
      mx = max8(u, mx);
    }
  } else {
    for (int k = lane; k < lq; k += 32) {
      __nv_bfloat16 b = xr[k];
      buf[k] = b;
      mx = fmaxf(mx, __bfloat162float(b));
    }
  }
  mx = warp_max(mx);
  __syncwarp();

  // each lane's sites: Z, the observed logit, the residual in place
  const float wt = w[row];
  float term = 0.0f;
  for (int s = lane; s < L; s += 32) {
    const int c = cr[s];
    __nv_bfloat16* xs = buf + s * q;
    float z = 0.0f;
    float x_obs = 0.0f;
    if constexpr (Q > 0) {
      float e[Q > 0 ? Q : 1];
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        const float xa = __bfloat162float(xs[a]);
        e[a] = expf(fmaxf(xa - mx, floor_));
        z += e[a];
        x_obs = a == c ? xa : x_obs;
      }
      const float rz = c >= 0 ? 1.0f / z : 0.0f;
#pragma unroll
      for (int a = 0; a < Q; ++a)
        xs[a] = __float2bfloat16_rn(wt * (e[a] * rz - (a == c ? 1.0f : 0.0f)));
    } else {
      for (int a = 0; a < q; ++a) {
        const float xa = __bfloat162float(xs[a]);
        z += expf(fmaxf(xa - mx, floor_));
        x_obs = a == c ? xa : x_obs;
      }
      const float rz = c >= 0 ? 1.0f / z : 0.0f;
      for (int a = 0; a < q; ++a) {
        const float ea = expf(fmaxf(__bfloat162float(xs[a]) - mx, floor_));
        xs[a] = __float2bfloat16_rn(wt * (ea * rz - (a == c ? 1.0f : 0.0f)));
      }
    }
    if (c >= 0) term += (x_obs - mx) - logf(z);
  }
  term = warp_sum(term);
  __syncwarp();

  // the residual row out
  if constexpr (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(buf);
    uint4* dst = reinterpret_cast<uint4*>(rr);
    const int nv = lq / 8;
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) dst[v] = src[v];
  } else {
    for (int k = lane; k < lq; k += 32) rr[k] = buf[k];
  }
  if (lane == 0) terms[row] = wt * term;
}

template <int Q, bool VEC>
cudaError_t launch(const void* x, long long ldx, const int8_t* codes,
                   long long ldc, const float* w, void* r, long long ldr,
                   float* terms, int B, int L, int q, float floor_,
                   cudaStream_t stream) {
  // a row's shared buffer, rounded to 16 bytes; as many rows per block
  // as fit in 96 KB, at most kWarps
  const int row_elems = (L * q + 7) / 8 * 8;
  const int row_bytes = row_elems * 2;
  int warps = (96 * 1024) / row_bytes;
  warps = warps < 1 ? 1 : (warps > kWarps ? kWarps : warps);
  const int smem = warps * row_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        k6_block_epilogue<Q, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int blocks = (B + warps - 1) / warps;
  k6_block_epilogue<Q, VEC><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, codes, ldc, w,
      static_cast<__nv_bfloat16*>(r), ldr, terms, B, L, q, row_elems, floor_);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of K6 over B rows: logits (B, L q) bf16 with row stride ldx,
// codes (B, L) int8 with row stride ldc, w (B,) float32, r (B, L q) bf16
// with row stride ldr (written), terms (B,) float32 (written). vec: every
// row of x and r starts 16-byte aligned and L q is a multiple of 8.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue where a
// row does not fit in a block's shared memory).
int evc_block_epilogue(const void* x, long long ldx, const void* codes,
                       long long ldc, const void* w, void* r, long long ldr,
                       void* terms, int B, int L, int q, float floor_,
                       int vec, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* wf = static_cast<const float*>(w);
  float* t = static_cast<float*>(terms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == 21)
    return vec ? launch<21, true>(x, ldx, c, ldc, wf, r, ldr, t, B, L, q,
                                  floor_, s)
               : launch<21, false>(x, ldx, c, ldc, wf, r, ldr, t, B, L, q,
                                   floor_, s);
  return vec ? launch<0, true>(x, ldx, c, ldc, wf, r, ldr, t, B, L, q,
                               floor_, s)
             : launch<0, false>(x, ldx, c, ldc, wf, r, ldr, t, B, L, q,
                                floor_, s);
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
