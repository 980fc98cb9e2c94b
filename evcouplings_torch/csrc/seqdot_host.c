/* Plain host version of K4 (csrc/seqdot.cu): the float32 dot product as
 * one chain of fused multiply-adds in index order,
 *
 *     acc = 0; for i in 0..n-1: acc = fmaf(x[i], y[i], acc)
 *
 * the arithmetic of the JAX package's LBFGS dot products on the CPU. */

#include <math.h>

float evc_seq_dot_host(const float* x, const float* y, long long n) {
  float acc = 0.0f;
  for (long long i = 0; i < n; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}
