// Newton-Raphson inversion of a 1-D Gaussian-mixture CDF for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/gm/inverse_cdf.py:gm1d_inverse_cdf_pallas (_nr_kernel):
// for each element e (a target n at a position m) and starting from
// init[e], take n_steps steps of
//   s -= clip(0.5 * (cdf(s) - target[e]) / max(pdf(s), eps),
//             -max_step_size * std[m], max_step_size * std[m])
// with nd_g = (s - means[g, m]) * exp(-logstd[m]),
//   pdf(s) = sum_g exp(-nd_g^2 / 2 - logstd[m] + logw[g, m]) / sqrt(2 pi),
//   cdf(s) = sum_g w[g, m] * erf(nd_g / sqrt(2))   (the CDF scaled to [-1, 1]).
//
// Layout: the wrapper (ops/gm/inverse_cdf.py) hands over the six fp32
// inputs as they lie, as views over the element axes (lead..., N, H, W),
// broadcast axes with stride 0 and axes merged where every tensor allows:
// up to kMaxDims element dimensions, each tensor with its own strides, and
// a component stride for means, logw and w. The result goes straight to
// the (lead..., N, H, W) output through its strides. No layout copy.
//
// What bounds it on the card: after one read of its (3G + 3) inputs an
// element does n_steps * G * (about 12 fp32 operations and 2 special
// functions) in registers. At the KR transport's axis (G 16, 16,384
// elements, 16 steps) that is 256 exp/erf pairs per 204 bytes: bound by the
// special-function units, then by the fp32 pipes, not by memory; and with
// one thread per element, 16,384 threads leave most of the card's 132 SMs
// idle, so a lone thread's serial chain of 256 component steps sets the
// time.
//
// Design: L lanes per element (a template parameter, L <= 16, chosen by
// the wrapper so that the grid fills the card: L = 16 at the KR axis, 1 at
// a million elements), each lane holding C components in registers for
// all steps (components g = c L + lane; a slot past G holds zero weights
// and adds exactly 0). Per step each lane sums its pdf and cdf terms in
// order, then a fixed __shfl_xor_sync butterfly adds the L partial sums:
// every lane ends with the same sums (the butterfly's pairs add the same
// two values), so every lane takes the same step, and the sum order is
// fixed by (L, C), which the wrapper picks from the problem's size alone,
// so the result is bitwise repeatable. A lane's exp(-nd^2 / 2) is one
// ex2.approx (log2 e folded in) that serves both terms: the pdf term is
// exp(logw - logstd) times it, and erf is the TPU kernel's own
// Abramowitz-Stegun 7.1.26, 1 - t poly(t) exp(-x^2) with t = 1 / (1 + p x)
// from one rcp.approx (|err| < 1.5e-7, so a root moves by at most
// 1.5e-7 / (2 pdf), inside the kernel-vs-plain bound of 1e-5 + 1e-6 /
// (2 pdf)). It ran 1.2x (KR axis) and 1.4x (a million elements) faster than
// CUDA's erff with a second ex2 for the pdf, both inside that bound: its
// largest error against the plain version 1.2e-5 and 9.4e-5 there (erff's
// 7.6e-6 and 4.3e-5), the worst element 1.0e-5 inside the bound
// (attention_ab.py builds and times both; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 6;                  // element dimensions
constexpr int kTensors = 7;                  // the six inputs and the output
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kLog2e = 1.44269504088896340736f;

// Abramowitz-Stegun 7.1.26, as arcflow_tpu/ops/gm/inverse_cdf.py:_erf
constexpr float kA1 = 0.254829592f, kA2 = -0.284496736f, kA3 = 1.421413741f;
constexpr float kA4 = -1.453152027f, kA5 = 1.061405429f, kP = 0.3275911f;

enum Tensor { kMeans, kLogw, kW, kLogstd, kTarget, kInit, kOut };

struct Params {
  const float* in[6];                        // means, logw, w, logstd,
                                             // target, init
  float* out;
  uint32_t size[kMaxDims];                   // element dims, outer first
  long long stride[kTensors][kMaxDims];      // elements, per tensor
  long long gstride[3];                      // components: means, logw, w
  uint32_t elements;
  int ndim, g, n_steps;
  float eps, max_step_size;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// erf(x) from e = exp(-x^2)
__device__ __forceinline__ float erf_as(float x, float e) {
  const float t = rcp_approx(fmaf(kP, fabsf(x), 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, kA5, kA4), kA3), kA2), kA1);
  return copysignf(fmaf(-poly, e, 1.f), x);
}

template <int L, int C>
__global__ void __launch_bounds__(kThreads)
    gm_inverse_cdf_kernel(const Params p) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % L;
  const uint32_t e = t / L;
  // a thread past the last element works on element 0 (the butterfly
  // needs every lane) and stores nothing
  const bool live = e < p.elements;
  long long off[kTensors] = {};
  uint32_t rem = live ? e : 0u;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < p.ndim) {
      const uint32_t i = rem % p.size[d];
      rem /= p.size[d];
#pragma unroll
      for (int k = 0; k < kTensors; ++k) off[k] += i * p.stride[k][d];
    }
  }

  const float ls = p.in[kLogstd][off[kLogstd]];
  const float xs = expf(-ls) * kInvSqrt2;    // x = nd / sqrt(2) = (s - mu) xs
  const float clamp = p.max_step_size * expf(ls);
  float mu[C], pw[C], wt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int g = c * L + lane;
    if (g < p.g) {
      mu[c] = p.in[kMeans][off[kMeans] + g * p.gstride[0]];
      const float lw = p.in[kLogw][off[kLogw] + g * p.gstride[1]];
      pw[c] = expf(lw - ls);
      wt[c] = p.in[kW][off[kW] + g * p.gstride[2]];
    } else {
      mu[c] = 0.f;
      pw[c] = 0.f;
      wt[c] = 0.f;
    }
  }
  const float tgt = p.in[kTarget][off[kTarget]];
  float s = p.in[kInit][off[kInit]];
  for (int step = 0; step < p.n_steps; ++step) {
    float pdf = 0.f, cdf = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = (s - mu[c]) * xs;
      const float ex = ex2_approx(-kLog2e * x * x);   // exp(-nd^2 / 2)
      pdf = fmaf(pw[c], ex, pdf);
      cdf = fmaf(wt[c], erf_as(x, ex), cdf);
    }
#pragma unroll
    for (int o = L / 2; o >= 1; o /= 2) {
      pdf += __shfl_xor_sync(0xffffffffu, pdf, o);
      cdf += __shfl_xor_sync(0xffffffffu, cdf, o);
    }
    const float delta = 0.5f * (cdf - tgt) / fmaxf(pdf * kInvSqrt2Pi, p.eps);
    s -= fminf(fmaxf(delta, -clamp), clamp);
  }
  if (live && lane == 0) p.out[off[kOut]] = s;
}

template <int L, int C>
int launch_lc(const Params& p, cudaStream_t stream) {
  const uint32_t blocks =
      (uint32_t)(((unsigned long long)p.elements * L + kThreads - 1) /
                 kThreads);
  gm_inverse_cdf_kernel<L, C><<<blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L>
int launch_l(const Params& p, int per_lane, cudaStream_t stream) {
  switch (per_lane) {
    case 1: return launch_lc<L, 1>(p, stream);
    case 2: return launch_lc<L, 2>(p, stream);
    case 4: return launch_lc<L, 4>(p, stream);
    case 8: return launch_lc<L, 8>(p, stream);
    case 16: return launch_lc<L, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. `geom` holds ndim element sizes
// (outer first), then the element strides of means, logw, w, logstd,
// target, init and out (ndim each), then the component strides of means,
// logw and w. `lanes` (1, 2, 4, 8, 16) lanes per element, each holding
// `per_lane` (1, 2, 4, 8, 16) component slots, lanes * per_lane >= g.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry it does not take (more than
// kMaxDims dims, elements outside [1, 2^31), elements * lanes >= 2^32);
// the caller checks that every tensor is fp32 on the card.
extern "C" int arcflow_gm_inverse_cdf(
    const void* means, const void* logw, const void* w, const void* logstd,
    const void* target, const void* init, void* out, const long long* geom,
    int ndim, int g, long long elements, int n_steps, float eps,
    float max_step_size, int lanes, int per_lane, void* stream) {
  if (ndim < 1 || ndim > kMaxDims || g < 1 || (long long)lanes * per_lane < g
      || elements < 1 || elements > 0x7FFFFFFFLL
      || elements * lanes > 0xFFFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  const void* in[6] = {means, logw, w, logstd, target, init};
  for (int i = 0; i < 6; ++i) p.in[i] = static_cast<const float*>(in[i]);
  p.out = static_cast<float*>(out);
  for (int d = 0; d < kMaxDims; ++d) {
    p.size[d] = d < ndim ? (uint32_t)geom[d] : 1u;
    for (int k = 0; k < kTensors; ++k) {
      p.stride[k][d] = d < ndim ? geom[ndim + k * ndim + d] : 0;
    }
  }
  for (int k = 0; k < 3; ++k) p.gstride[k] = geom[ndim + kTensors * ndim + k];
  p.elements = (uint32_t)elements;
  p.ndim = ndim;
  p.g = g;
  p.n_steps = n_steps;
  p.eps = eps;
  p.max_step_size = max_step_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_l<1>(p, per_lane, st);
    case 2: return launch_l<2>(p, per_lane, st);
    case 4: return launch_l<4>(p, per_lane, st);
    case 8: return launch_l<8>(p, per_lane, st);
    case 16: return launch_l<16>(p, per_lane, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
