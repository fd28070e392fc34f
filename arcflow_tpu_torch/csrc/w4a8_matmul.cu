// w4a8 grouped matmul for Hopper (sm_90a): int8 activations x int4 weights.
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/quant_matmul.py:w4a8_matmul_pallas (_w4a8_kernel):
//   out[m, n] = sum_g scale[g, n] * sum_{k in g} xq[m, k] * w4[k, n]
// with xq (M, K) int8, w4 nibble-packed (K/2, N) int8 in the group-local
// half-split layout (utils/quantize.py:pack_int4: packed row j of group g
// holds input row g*group + j in its low nibble and g*group + group/2 + j in
// its high nibble) and scale (G, N) fp32. The output is (M, N) fp32 or bf16;
// with a per-row scale r (the per-token activation scale) it is
// (out[m, n] * r[m]) rounded once to the output type, the same fp32 product
// and rounding as scaling the fp32 output afterwards.
//
// What bounds it on the card: at the Qwen-Image serving shapes (M = 4096
// image tokens, K and N of 3072 or 12288) one call does 2*M*K*N = 103-309
// GOP on 12-75 MB, thousands of operations per byte: tensor-core bound. At
// M = 1 (the AdaLN modulations) it reads K*N/2 bytes of weights for 2*K*N
// operations and is bound by the weight read.
//
// Design (warp specialised on hopper.cuh; one CTA of three warpgroups per
// 128 weight columns x TOK tokens, TOK = 128, or 8 for M <= 8):
//   * the operands are swapped, out^T = w^T xq^T, so that the unpacked
//     weight is the register A operand of an m64nTOKk32 s8 wgmma and the
//     activations the shared-memory B operand, read K-major as they lie in
//     memory. 8-bit wgmma reads shared-memory operands K-major only, and the
//     packed weight keeps N contiguous, so whichever operand the weight is,
//     the k values of one column have to be gathered; in registers that
//     needs no shared-memory write, no proxy fence and no transpose pass;
//   * the producer warpgroup gives up its registers and one thread issues
//     the TMA loads of each 128-deep K step into an mbarrier ring of
//     kStages stages: the activation tile (TOK rows x 128 bytes) and the
//     packed weight tile (64 packed rows x 128 columns), both 128-byte
//     swizzled;
//   * each of two consumer warpgroups owns 64 weight columns. A thread's
//     two accumulator rows are the adjacent columns 2q and 2q + 1, so one
//     16-bit shared-memory load gives both of their bytes of a packed row;
//     four rows make the four k values of a register, the low nibbles one
//     k32 step's register and the high nibbles another's, sign-extended by
//     byte permutes;
//   * the int32 accumulator covers one scale group (a partial sum below
//     2^24, exact in fp32), then is folded into fp32 registers with
//     scale[g, n], one I2F and one FFMA per element. The two consumers
//     take turns to issue their products (named barriers), so that one
//     folds while the other's run on the tensor cores, and each unpacks its
//     next tile's A operands while its own products run;
//   * the epilogue writes pairs of adjacent columns straight from the
//     registers, scaled by the row scale and rounded to the output type.
// The fold is in group order and each output is summed by one thread, so
// the result is bitwise repeatable. What bounds it now is not the tensor
// cores: per 128 x 128 x 128 tile a consumer thread issues about 128 fold
// and 80 unpack instructions, with two warps a scheduler to hide their
// latencies, against 245 cycles of tensor work per warpgroup, and the CTA
// loads 24 KB; builds with the fold, the unpack or the products taken out
// each ran faster, so all three weigh, and larger tiles would need more
// registers than the two accumulators leave.
// M = 1 fills 144 CTAs at N = 18432, one wave and 12 CTAs, and 24 at
// N = 3072; a fixed-order split over groups would fill the card there.
//
// Shapes: any M, K a multiple of the group (32, 64 or 128), N a multiple of
// 8. The packed weight's and the scale's rows are `Ns` elements apart, a
// multiple of 16 (TMA steps rows in 16-byte units: the wrapper pads N to
// it); columns at or past N are neither read from the scale nor written.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                     // weight columns per CTA
constexpr int kBK = 128;                     // K per stage
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kStages = 6;                   // ring depth
constexpr int kPackedBytes = kBK / 2 * kBN;  // 64 packed rows x 128 columns

enum OutKind { kOutF32 = 0, kOutBF16 = 1 };

// one stage: the activation tile (TOK rows x 128 bytes), then the packed
// weight tile
template <int TOK>
constexpr int kStageBytes = TOK * kBK + kPackedBytes;

template <int TOK>
constexpr int kSmemBytes =
    kStages * kStageBytes<TOK> + 2 * kStages * 8 + 1024;

struct Params {
  const float* scale;                        // (G, Ns)
  const float* row_scale;                    // (M) or null
  void* out;                                 // (M, N)
  int M, N, Ns, K;
  int out_kind;
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The low / high nibble of each byte of w, sign-extended to a byte. prmt's
// selector 0x8-0xB replicates the sign bit of byte 0-3 over its byte.
__device__ __forceinline__ uint32_t sext_lo(uint32_t w) {
  const uint32_t sign = prmt(w << 4, 0u, 0xBA98u);
  return (w & 0x0F0F0F0Fu) | (sign & 0xF0F0F0F0u);
}
__device__ __forceinline__ uint32_t sext_hi(uint32_t w) {
  const uint32_t sign = prmt(w, 0u, 0xBA98u);
  return ((w >> 4) & 0x0F0F0F0Fu) | (sign & 0xF0F0F0F0u);
}

// Byte offsets, in a packed tile (64 rows x 128 bytes, 128-byte swizzled),
// of this thread's columns `col` and `col + 1` in rows 4c + i (c = lane % 4,
// i = 0..3); row 16u + 4c + i lies u * 2048 bytes further (16u leaves the
// swizzle phase, row % 8, as it is).
__device__ __forceinline__ void packed_offsets(int (&off)[4], int col,
                                               int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * c + i;
    off[i] = j * 128 + ((((col >> 4) ^ j) & 7) << 4) + (col & 15);
  }
}

// The A operands of the four k32 steps of one 128-deep K tile from the
// packed tile `sw`, at this thread's `off` (packed_offsets). Register r of
// step s holds four consecutive k; in the half-split layout those are four
// consecutive packed rows J..J+3, J = 16u + 4c, whose low nibbles feed one
// step and high nibbles another:
//   group 128: low -> step u / 2, high -> step u / 2 + 2, registers h;
//   group 64:  low -> step 2 (u / 2), high -> step 2 (u / 2) + 1,
//              registers h;
//   group 32:  low -> step u (k 0-15), high -> step u (k 16-31);
// with h = u % 2 the register pair (k 0-15 or 16-31 of a step).
template <int GROUP>
__device__ __forceinline__ void unpack_a(uint32_t (&a)[4][4],
                                         const unsigned char* sw,
                                         const int (&off)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int s_lo, s_hi, r_lo, r_hi;
    if (GROUP == 128) {
      s_lo = u >> 1;
      s_hi = s_lo + 2;
      r_lo = r_hi = 2 * (u & 1);
    } else if (GROUP == 64) {
      s_lo = 2 * (u >> 1);
      s_hi = s_lo + 1;
      r_lo = r_hi = 2 * (u & 1);
    } else {
      s_lo = s_hi = u;
      r_lo = 0;
      r_hi = 2;
    }
    uint32_t hw[4];                          // rows J + i, columns col, col+1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hw[i] = *reinterpret_cast<const uint16_t*>(sw + u * 2048 + off[i]);
    }
    const uint32_t t01 = __byte_perm(hw[0], hw[1], 0x5140);
    const uint32_t t23 = __byte_perm(hw[2], hw[3], 0x5140);
    const uint32_t w0 = __byte_perm(t01, t23, 0x5410);   // column col
    const uint32_t w1 = __byte_perm(t01, t23, 0x7632);   // column col + 1
    a[s_lo][r_lo] = sext_lo(w0);
    a[s_lo][r_lo + 1] = sext_lo(w1);
    a[s_hi][r_hi] = sext_hi(w0);
    a[s_hi][r_hi + 1] = sext_hi(w1);
  }
}

template <int TOK, int GROUP>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const Params p) {
  constexpr int kXBytes = TOK * kBK;
  constexpr int kStage = kStageBytes<TOK>;
  constexpr int kSteps = GROUP / 32;         // k32 steps per scale group
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * TOK;
  const int n_tiles = (p.K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);              // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 256) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) - 1) & 1);
        unsigned char* dst = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        tma_load_2d(dst, &map_x, &full[st], t * kBK, m0);
        tma_load_2d(dst + kXBytes, &map_w, &full[st], n0, t * (kBK / 2));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns weight columns 64 wg .. 64 wg + 63
    setmaxnreg_inc<240>();
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;
    const int c = lane & 3;
    // accumulator rows 16 warp + lane/4 and + 8 are columns col and col + 1
    const int col = wg * 64 + warp * 16 + 2 * (lane >> 2);
    const int n = n0 + col;
    int off[4];
    packed_offsets(off, col, c);

    float acc[TOK / 2];                      // fp32, over the groups so far
    int32_t part[TOK / 2];                   // int32, this scale group
#pragma unroll
    for (int i = 0; i < TOK / 2; ++i) acc[i] = 0.f;

    // The consumers take turns to issue their products, on named barriers
    // 1 (consumer 0's turn) and 2 (consumer 1's), so that one folds while
    // the other's wgmmas run; consumer 0 goes first. Each unpacks the next
    // tile's A operands (double-buffered, a[t % 2]) while its own products
    // run.
    if (wg == 1) named_bar_arrive(1, 256);
    uint32_t a[2][4][4];
    mbar_wait(&full[0], 0);
    unpack_a<GROUP>(a[0], smem + kXBytes, off);
#pragma unroll 1
    for (int t0 = 0; t0 < n_tiles; t0 += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + h;
        if (t < n_tiles) {
          const int st = t % kStages;
          const int k0 = t * kBK;
          const unsigned char* sx = smem + st * kStage;
          const int groups = min(4, (p.K - k0) / 32) / kSteps;
#pragma unroll
          for (int gb = 0; gb < 4 / kSteps; ++gb) {
            if (gb < groups) {
              const int g = k0 / GROUP + gb;
              const float2 sc =
                  n < p.Ns ? __ldg(reinterpret_cast<const float2*>(
                                 p.scale + (long long)g * p.Ns + n))
                           : make_float2(0.f, 0.f);
              named_bar_sync(1 + wg, 256);
              fence_regs(a[h]);
              wgmma_fence();
#pragma unroll
              for (int ss = 0; ss < kSteps; ++ss) {
                const int s = gb * kSteps + ss;
                wgmma_rs_s8(part, a[h][s], make_desc(sx + s * 32, 16, 1024),
                            ss);
              }
              wgmma_commit();
              // hand the turn over; consumer 1's last turn has no taker
              if (wg == 0 || t + 1 < n_tiles || gb + 1 < groups) {
                named_bar_arrive(2 - wg, 256);
              }
              if (gb == 0 && t + 1 < n_tiles) {
                const int st1 = (t + 1) % kStages;
                mbar_wait(&full[st1], ((t + 1) / kStages) & 1);
                unpack_a<GROUP>(a[h ^ 1], smem + st1 * kStage + kXBytes, off);
              }
              wgmma_wait<0>();
              fence_regs(part);
#pragma unroll
              for (int i = 0; i < TOK / 2; ++i) {
                acc[i] = fmaf(__int2float_rn(part[i]), (i & 2) ? sc.y : sc.x,
                              acc[i]);
              }
            }
          }
          if (lane == 0) mbar_arrive(&empty[st]);
        }
      }
    }

    // epilogue: acc[4 jt + 2 i + e] is column n + i of token 8 jt + 2c + e
    if (n < p.N) {                           // N % 8 == 0: so is n + 1
      if (p.row_scale != nullptr) {
        // every row scale is read before the first store: for all the
        // compiler knows a store to `out` may alias them, so a load issued
        // after one would wait for it
        float r[TOK / 4];
#pragma unroll
        for (int i = 0; i < TOK / 4; ++i) {
          const int m = m0 + 8 * (i / 2) + 2 * c + (i & 1);
          r[i] = m < p.M ? __ldg(p.row_scale + m) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < TOK / 2; ++i) {
          acc[i] = __fmul_rn(acc[i], r[2 * (i / 4) + (i & 1)]);
        }
      }
#pragma unroll
      for (int jt = 0; jt < TOK / 8; ++jt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * jt + 2 * c + e;
          if (m >= p.M) continue;
          const float v0 = acc[4 * jt + e], v1 = acc[4 * jt + 2 + e];
          const long long off = (long long)m * p.N + n;
          if (p.out_kind == kOutF32) {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(p.out) + off) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

template <int TOK, int GROUP>
int launch(const void* xq, const void* packed, const Params& p,
           cudaStream_t stream) {
  constexpr int smem = kSmemBytes<TOK>;
  // a runtime call first: it makes the device's context current on this
  // thread, which libcuda's map encoder needs (make_int8_map)
  const cudaError_t e = cudaFuncSetAttribute(
      w4a8_matmul_kernel<TOK, GROUP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_x, map_w;
  int err = make_int8_map(&map_x, xq, p.M, p.K, p.K, TOK, 0);
  if (err == 0) {
    err = make_int8_map(&map_w, packed, p.K / 2, p.Ns, p.Ns, kBK / 2, 1);
  }
  if (err != 0) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + TOK - 1) / TOK);
  w4a8_matmul_kernel<TOK, GROUP><<<grid, kThreads, smem, stream>>>(
      map_x, map_w, p);
  return (int)cudaGetLastError();
}

template <int TOK>
int launch_group(const void* xq, const void* packed, const Params& p,
                 int group, cudaStream_t stream) {
  if (group == 32) return launch<TOK, 32>(xq, packed, p, stream);
  if (group == 64) return launch<TOK, 64>(xq, packed, p, stream);
  return launch<TOK, 128>(xq, packed, p, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Builds the TMA maps of xq and the
// packed weight, launches on `stream` and returns 0, a CUDA error code, or
// hopper::kTmaRefused + ... for a map libcuda refused (xq 0, packed 1).
// The caller checks that the tensors are contiguous and 16-byte aligned,
// group in {32, 64, 128}, K % group == 0, N % 8 == 0, Ns >= N a multiple of
// 16 (the row pitch of packed and scale), out_kind 0 (fp32) or 1 (bf16),
// row_scale (M) fp32 or null, and the grid's size, before calling.
extern "C" int arcflow_w4a8_matmul(const void* xq, const void* packed,
                                   const void* scale, const void* row_scale,
                                   void* out, int M, int N, int Ns, int K,
                                   int group, int out_kind, void* stream) {
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.row_scale = static_cast<const float*>(row_scale);
  p.out = out;
  p.M = M;
  p.N = N;
  p.Ns = Ns;
  p.K = K;
  p.out_kind = out_kind;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch_group<8>(xq, packed, p, group, s)
                : launch_group<128>(xq, packed, p, group, s);
}
