// Newton-Raphson inversion of a 1-D Gaussian-mixture CDF for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/gm/inverse_cdf.py:gm1d_inverse_cdf_pallas (_nr_kernel):
// for each element m and target n, starting from init[n, m], take n_steps
// steps of
//   s -= clip(0.5 * (cdf(s) - target[n, m]) / max(pdf(s), eps),
//             -max_step_size * std[m], max_step_size * std[m])
// with nd_g = (s - means[g, m]) * exp(-logstd[m]),
//   pdf(s) = sum_g exp(-nd_g^2 / 2 - logstd[m] + logw[g, m]) / sqrt(2 pi),
//   cdf(s) = sum_g w[g, m] * erf(nd_g / sqrt(2))   (the CDF scaled to [-1, 1]).
// Inputs are fp32 in the (rows, M) layout of the wrapper
// (ops/gm/inverse_cdf.py): means, logw, w (G, M); logstd (1, M); target and
// init (N, M); the result goes to a fresh (N, M) output.
//
// What bounds it on the card: each step reads nothing new (the element's
// 3G mixture values stay in L1), so after one read of (3G + 2N + 1) M floats
// it does n_steps * N * G * (about 12 fp32 operations and 2 special
// functions) per element. At the KR transport's problem (G = 16, N = 1,
// n_steps = 16) that is 256 exp/erf pairs per 204 bytes: bound by the
// special-function units, then by the fp32 pipes, not by memory.
//
// Design (a simple, correct first version): one thread per (n, m), threads
// of a block on neighbouring m so every read of a (G, M) row is coalesced;
// the sum over G runs in registers in a fixed order, so the result is
// bitwise deterministic. CUDA's erff replaces the TPU kernel's
// Abramowitz-Stegun erf (|err| < 1.5e-7), which exists only because Pallas
// on the TPU has no erf. A bounds check replaces the JAX padding of M.
// What it leaves on the table: holding the G mixture values in registers or
// shared memory across steps, fast-math exp, and more than one element per
// thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

__global__ void __launch_bounds__(kThreads)
gm_inverse_cdf_kernel(const float* __restrict__ means,
                      const float* __restrict__ logw,
                      const float* __restrict__ w,
                      const float* __restrict__ logstd,
                      const float* __restrict__ target,
                      const float* __restrict__ init, float* __restrict__ out,
                      int g, long long m, int n_steps, float eps,
                      float max_step_size) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  const long long at = (long long)blockIdx.y * m + col;   // (n, m)
  const float ls = logstd[col];
  const float inv_std = expf(-ls);
  const float clamp = max_step_size * expf(ls);
  const float tgt = target[at];
  float s = init[at];
  for (int step = 0; step < n_steps; ++step) {
    float pdf = 0.0f, cdf = 0.0f;
    for (int j = 0; j < g; ++j) {
      const long long idx = (long long)j * m + col;
      const float nd = (s - __ldg(means + idx)) * inv_std;
      pdf += expf(-0.5f * nd * nd - ls + __ldg(logw + idx));
      cdf += __ldg(w + idx) * erff(nd * kInvSqrt2);
    }
    const float delta = 0.5f * (cdf - tgt) / fmaxf(pdf * kInvSqrt2Pi, eps);
    s -= fminf(fmaxf(delta, -clamp), clamp);
  }
  out[at] = s;
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks that every tensor is
// contiguous fp32 on the card in the layout above, M >= 1, G >= 1 and
// 1 <= N <= 65535 before calling.
extern "C" int arcflow_gm_inverse_cdf(const void* means, const void* logw,
                                      const void* w, const void* logstd,
                                      const void* target, const void* init,
                                      void* out, int g, int n, long long m,
                                      int n_steps, float eps,
                                      float max_step_size, void* stream) {
  const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)n);
  gm_inverse_cdf_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(logw),
      static_cast<const float*>(w), static_cast<const float*>(logstd),
      static_cast<const float*>(target), static_cast<const float*>(init),
      static_cast<float*>(out), g, m, n_steps, eps, max_step_size);
  return (int)cudaGetLastError();
}
