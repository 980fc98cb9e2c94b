// K4: the float32 dot product of the LBFGS engine in parity mode, as ONE
// chain of fused multiply-adds in index order per pair of vectors:
//
//     acc = 0; for i in 0..n-1: acc = fma(x[i], y[i], acc)
//
// The JAX package's LBFGS engine (evcouplings_tpu/ops/lbfgs.py) takes its
// dot products with jnp.dot, which XLA's CPU backend compiles to exactly
// this chain, and the parity fixtures (tests/data/golden) carry its
// rounding: the 40-iteration golden fit moves by ~1e-3 when the dots are
// summed in any other order. This kernel reproduces that arithmetic bit
// for bit on the card; evcouplings_torch/csrc/seqdot_host.c is its plain
// version on the host. It replaces no Pallas kernel.
//
// What bounds it: the latency of the dependent FMA chain, n FMAs one after
// the other (4 cycles each), not bytes or throughput. A parallel reduction
// would be hundreds of times faster and give other bits.
//
// Design. One block per pair; a launch takes a batch of independent pairs
// (the LBFGS engine batches the dots that do not depend on each other),
// each pair on its own SM, each its own unchanged chain.
//   - warp 1, the producer, keeps a ring of kStages shared-memory stages
//     full, kStageElems floats of x and of y each, with cp.async copies
//     (16 bytes where the vector is 16-byte aligned, 4 bytes otherwise, so
//     any slice works) completed on the stage's `full` mbarrier;
//   - lane 0 of warp 0, the consumer, runs the chain: it reads each stage
//     with 16-byte shared loads one group of 16 elements ahead of the FMAs
//     that need them, into two register sets in turn, one load pair of the
//     next group between each four FMAs of the current one (the loads do
//     not depend on acc), so only the FMA latency is left on the critical
//     path, and releases the stage to the producer through its `empty`
//     mbarrier. (This form, a macro for the two halves of a pair of
//     groups, ran faster on the H100 than the same code written as an
//     inline function, which ptxas unrolls otherwise.)
// No fast-math anywhere: every FMA is an explicit __fmaf_rn.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 4;
constexpr int kStageElems = 4096;  // floats of x and of y per stage (16 KB)
constexpr int kGroup = 16;         // elements loaded one group ahead
constexpr int kThreads = 64;       // warp 0: consumer, warp 1: producer
constexpr int kMaxBatch = 16;      // pairs per launch

struct Pairs {
  const float* x[kMaxBatch];
  const float* y[kMaxBatch];
  long long n[kMaxBatch];
};

struct alignas(16) Smem {
  float x[kStages][kStageElems];
  float y[kStages][kStageElems];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Producer: one warp copies m floats of one vector into a stage.
__device__ __forceinline__ void copy_stage(float* dst, const float* src,
                                           int m, bool aligned, int lane) {
  int i = 0;
  if (aligned) {
    const int vec = m / 4;
    for (int v = lane; v < vec; v += 32) copy16(dst + 4 * v, src + 4 * v);
    i = 4 * vec;
  }
  for (i += lane; i < m; i += 32) copy4(dst + i, src + i);
}

// Consumer: the chain over one stage, in index order. Two register sets
// (a and b) in turn; each 16-byte load pair of the next group sits
// between the FMAs of the current one.
#define EVC_HALF(A, B, NEXT)                                      \
  _Pragma("unroll") for (int u = 0; u < kVec; ++u) {              \
    B##x[u] = vx[(NEXT) * kVec + u];                              \
    B##y[u] = vy[(NEXT) * kVec + u];                              \
    acc = __fmaf_rn(A##x[u].x, A##y[u].x, acc);                   \
    acc = __fmaf_rn(A##x[u].y, A##y[u].y, acc);                   \
    acc = __fmaf_rn(A##x[u].z, A##y[u].z, acc);                   \
    acc = __fmaf_rn(A##x[u].w, A##y[u].w, acc);                   \
  }
__device__ __forceinline__ float chain(const float* __restrict__ sx,
                                       const float* __restrict__ sy, int m,
                                       float acc) {
  const float4* vx = reinterpret_cast<const float4*>(sx);
  const float4* vy = reinterpret_cast<const float4*>(sy);
  const int groups = m / kGroup;
  constexpr int kVec = kGroup / 4;
  float4 ax[kVec], ay[kVec], bx[kVec], by[kVec];
  if (groups > 0) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      ax[u] = vx[u];
      ay[u] = vy[u];
    }
  }
  int g = 0;
  for (; g + 1 < groups; g += 2) {
    EVC_HALF(a, b, g + 1)
    // group g + 2, or a harmless reload of g + 1 after the last pair
    EVC_HALF(b, a, g + 2 < groups ? g + 2 : g + 1)
  }
  if (g < groups) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      acc = __fmaf_rn(ax[u].x, ay[u].x, acc);
      acc = __fmaf_rn(ax[u].y, ay[u].y, acc);
      acc = __fmaf_rn(ax[u].z, ay[u].z, acc);
      acc = __fmaf_rn(ax[u].w, ay[u].w, acc);
    }
  }
  for (int i = groups * kGroup; i < m; ++i)
    acc = __fmaf_rn(sx[i], sy[i], acc);
  return acc;
}
#undef EVC_HALF

__global__ void __launch_bounds__(kThreads)
seq_dots_kernel(__grid_constant__ const Pairs pairs,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const float* x = pairs.x[blockIdx.x];
  const float* y = pairs.y[blockIdx.x];
  const long long n = pairs.n[blockIdx.x];
  const long long chunks = (n + kStageElems - 1) / kStageElems;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // one cp.async arrival per producer lane
      mbar_init(&sm.empty[s], 1);  // the consumer's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 1) {
    const bool x16 = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
    const bool y16 = (reinterpret_cast<uintptr_t>(y) % 16) == 0;
    for (long long c = 0; c < chunks; ++c) {
      const int s = static_cast<int>(c % kStages);
      const long long round = c / kStages;
      if (round > 0)
        mbar_wait(&sm.empty[s], static_cast<uint32_t>((round - 1) & 1));
      const long long base = c * kStageElems;
      const int m = static_cast<int>(
          n - base < kStageElems ? n - base : kStageElems);
      copy_stage(sm.x[s], x + base, m, x16, lane);
      copy_stage(sm.y[s], y + base, m, y16, lane);
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(smem_u32(&sm.full[s]))
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (lane == 0) {
    float acc = 0.0f;
    for (long long c = 0; c < chunks; ++c) {
      const int s = static_cast<int>(c % kStages);
      mbar_wait(&sm.full[s], static_cast<uint32_t>((c / kStages) & 1));
      const long long base = c * kStageElems;
      const int m = static_cast<int>(
          n - base < kStageElems ? n - base : kStageElems);
      acc = chain(sm.x[s], sm.y[s], m, acc);
      mbar_arrive(&sm.empty[s]);
    }
    out[blockIdx.x] = acc;
  }
}

}  // namespace

extern "C" {

// k pairs (x[p], y[p]) of float32 vectors of n[p] elements, contiguous,
// any 4-byte alignment; out: k float32 on the device. One launch of at
// most kMaxBatch blocks. Returns the cudaError_t of the launch.
int evc_seq_dots(const void* const* xs, const void* const* ys,
                 const long long* ns, int k, void* out, void* stream) {
  if (k < 1 || k > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  Pairs pairs = {};
  for (int p = 0; p < k; ++p) {
    if (ns[p] < 0 || reinterpret_cast<uintptr_t>(xs[p]) % 4 ||
        reinterpret_cast<uintptr_t>(ys[p]) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    pairs.x[p] = static_cast<const float*>(xs[p]);
    pairs.y[p] = static_cast<const float*>(ys[p]);
    pairs.n[p] = ns[p];
  }
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      seq_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seq_dots_kernel<<<k, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pairs, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
