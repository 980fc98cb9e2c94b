// K4: the float32 dot product of the LBFGS engine in parity mode, as ONE
// chain of fused multiply-adds in index order:
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
// What bounds it: the latency of the dependent FMA chain (n FMAs, one
// after the other), not bytes or throughput. A parallel reduction would
// be hundreds of times faster and give other bits. Design: one warp;
// all 32 lanes stage coalesced chunks of x and y in shared memory, and
// lane 0 runs the chain over each chunk. Used only in parity mode
// (float32, precision "highest"); every other mode uses torch.dot.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;

__global__ void __launch_bounds__(32)
seq_dot_kernel(const float* __restrict__ x, const float* __restrict__ y,
               long long n, float* __restrict__ out) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  float acc = 0.0f;
  for (long long base = 0; base < n; base += kChunk) {
    const int m = static_cast<int>(n - base < kChunk ? n - base : kChunk);
    for (int i = threadIdx.x; i < m; i += 32) {
      sx[i] = x[base + i];
      sy[i] = y[base + i];
    }
    __syncwarp();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) acc = __fmaf_rn(sx[i], sy[i], acc);
    }
    __syncwarp();
  }
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

extern "C" {

// x, y: (n,) float32, contiguous. out: one float32. Returns the
// cudaError_t of the launch.
int evc_seq_dot(const void* x, const void* y, long long n, void* out,
                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  seq_dot_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* evc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
