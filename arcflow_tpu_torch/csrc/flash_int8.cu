// Forward flash attention with an int8 QK^T for Hopper (sm_90a), and the row
// quantization that feeds it.
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/flash_int8.py:flash_attention_int8 (rowwise_int8 on q
//   and k, then _flash_int8_kernel):
// q and k are quantized per (batch, token, head) row to symmetric int8 with
// fp32 scales s = max(absmax, 1e-6) / 127 (quantize_rows_int8_kernel, one
// launch for both; the JAX function quantizes inside the same jitted
// function, where XLA fuses it); the score of query i and key j is the
// int8 dot product rescaled exactly,
//   s_ij = (q8_i . k8_j) * (s_q[i] / sqrt(D)) * s_k[j],
// the softmax runs online in fp32 and P.V in bf16 with P rounded to bf16. A
// masked key scores -1e30 (not -inf) and the running max starts at -1e30,
// as in the JAX kernel, so a row whose every key is masked attends
// uniformly and gets the mean of v; keys past S (a ragged last tile) score
// -inf and count for nothing. O = acc / max(l, 1e-30).
//
// What bounds it on the card: at the FLUX serving shape (B1 S4608 H24 D128)
// QK^T is 1.30e11 int8 operations and P.V 1.30e11 bf16 operations on 85.8 MB
// of int8 q and k, their scales and bf16 v and o: bound by the tensor cores
// (0.066 ms at the int8 peak plus 0.132 ms at the bf16 peak), not by bytes.
// Beside K1's softmax, each score costs a consumer thread an int32 -> fp32
// convert and two multiplies (the row and key scales): that ALU work, not
// the int8 product, decides whether int8 can beat bf16 attention here, as
// it decided against it on the TPU (the JAX docstring). The quantization
// reads bf16 q and k (56.6 MB at that shape) and writes 28.3 MB of int8
// rows and 0.9 MB of scales: bound by bytes (0.026 ms).
//
// Design of the attention (attention_fwd.cu's structure on hopper.cuh; one
// CTA of three warpgroups per 128 query rows of one (batch, head)):
//   * the producer warpgroup gives up its registers (setmaxnreg) and one of
//     its threads issues every TMA load: the int8 Q tile once (128 rows x
//     128 bytes: one 128-byte-swizzled box, an int8 row being exactly one
//     swizzle row), then per 128 keys the int8 K tile with its 128 key
//     scales on one mbarrier and the bf16 V tile on another, into a ring of
//     kStages stages, a stage refilled once both consumers released it. The
//     scales are one box of a 2-D map over the (B H, S) scale rows, so a
//     ragged last tile reads zeros past S and nothing outside its row. TMA
//     steps rows in 16-byte units, so the rows lie `pitch` values apart, a
//     multiple of 4: S itself, or the wrapper's zero-padded copy when S is
//     not a multiple of 4 (a 1-D map over the flat scales, whose boxes
//     start at (b H + h) S + k0, off 16-byte boundaries when S is not a
//     multiple of 4, faulted with an illegal instruction at S = 77);
//   * two consumer warpgroups own 64 query rows each. S = Q K^T is four
//     m64n128k32 s8 wgmma with both operands in shared memory, K-major as
//     they lie in memory. Q stays in shared memory rather than in registers:
//     TMA leaves it in the layout the descriptor reads, so there is no
//     fragment gather, and its 16 registers stay free for the S, O and P
//     registers of the softmax;
//   * the int32 tile is converted to fp32 and multiplied by the row factor
//     s_q sm_scale log2(e) and then by the scale of each accumulator's own
//     key column (8n + 2 (lane % 4) + c, not the key whose bytes a thread
//     loaded), read as a float2 from shared memory: the order of the plain
//     version, with log2(e) folded into the row factor for the base-2
//     online softmax;
//   * O += P V as in K1: P re-packed to bf16 as the register A operand of
//     m64n128k16 wgmma, V read MN-major (transposed by the descriptor).
// There is no split over keys: each output row is summed by one warpgroup
// in one order, so the result is bitwise repeatable.
//
// The quantization: one half-warp per row of 128 values (8 per lane, one
// 16-byte load for bf16), the absmax by a butterfly of fmaxf (exact in any
// order), then the scale and each quotient by IEEE division (__fdiv_rn) and
// rounding half to even (rintf), clipped to +-127: bitwise the plain
// version's arithmetic.
//
// Layouts: q and k (bf16 or fp32, for the quantization), the int8 rows and
// v and o (bf16 or fp32) are (B, S, H, D) with D contiguous, read and
// written through their strides; the int8 rows the quantization writes are
// contiguous; the scales are (B, H, S) fp32, contiguous; kv_valid is (B, S)
// bytes, nonzero for a valid key, or null.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;                      // head dim
constexpr int kBlockM = 128;                 // query rows per CTA
constexpr int kBlockN = 128;                 // keys per K/V tile
constexpr int kStages = 3;                   // K/V ring depth
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kI8TileBytes = 128 * kD;       // 128 int8 rows: one box
constexpr int kVTileBytes = 128 * kD * 2;    // 128 bf16 rows: two boxes
constexpr int kVBoxBytes = kVTileBytes / 2;  // one 64-column half
constexpr int kScaleBytes = kBlockN * 4;     // one tile's key scales
constexpr int kSmemBytes = (1 + kStages) * kI8TileBytes +
                           kStages * (kVTileBytes + kScaleBytes) +
                           (1 + 3 * kStages) * 8 + 1024;
constexpr float kMaskedScore = -1e30f;       // the JAX kernel's fill

struct Params {
  const float* qs;                           // (B, H, S)
  const uint8_t* kv_valid;
  void* o;
  int B, S, H;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale_log2;                          // log2(e) * sm_scale
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_ks,
                      const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;                             // int8 [128][128]
  unsigned char* sK = sQ + kI8TileBytes;                // [kStages] tiles
  unsigned char* sV = sK + kStages * kI8TileBytes;      // [kStages] tiles
  float* sKs = reinterpret_cast<float*>(sV + kStages * kVTileBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKs + kStages * kBlockN);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int S = p.S;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], 8);              // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(q_full, kI8TileBytes);
      tma_load_4d(sQ, &map_q, q_full, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&k_full[st], kI8TileBytes + kScaleBytes);
        tma_load_4d(sK + st * kI8TileBytes, &map_k, &k_full[st], 0,
                    j * kBlockN, h, b);
        tma_load_2d(sKs + st * kBlockN, &map_ks, &k_full[st], j * kBlockN,
                    bh);
        unsigned char* v_dst = sV + st * kVTileBytes;
        mbar_expect_tx(&v_full[st], kVTileBytes);
        tma_load_4d(v_dst, &map_v, &v_full[st], 0, j * kBlockN, h, b);
        tma_load_4d(v_dst + kVBoxBytes, &map_v, &v_full[st], 64,
                    j * kBlockN, h, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 ----
    setmaxnreg_inc<240>();
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;       // warp within the warpgroup
    const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

    // this thread's two rows, 16 warp + lane/4 (+ 8) of the warpgroup's 64,
    // and their row factors s_q * sm_scale * log2(e)
    float q_scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + i * 8;
      q_scale[i] = row < S ? p.qs[(long long)bh * S + row] * p.scale_log2
                           : 0.f;
    }
    float o_acc[kD / 2];                     // 64 x 128 fp32, wgmma layout
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;
    float m_row[2] = {kMaskedScore, kMaskedScore};   // running max (base 2)
    float l_row[2] = {0.f, 0.f};             // this thread's partial sums
    const unsigned char* cQ = sQ + wg * 64 * 128;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int k0 = j * kBlockN;
      const unsigned char* cK = sK + st * kI8TileBytes;
      const unsigned char* cV = sV + st * kVTileBytes;
      const float* cKs = sKs + st * kBlockN;

      // S = Q K^T in int32: this warpgroup's 64 rows x 128 keys, k32 steps
      int32_t sc[kBlockN / 2];
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        wgmma_ss_s8(sc, make_desc(cQ + kk * 32, 16, 1024),
                    make_desc(cK + kk * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // rescale (row factor, then the key scale of the accumulator's own
      // column), mask, online softmax
      float s[kBlockN / 2];
      float mx[2] = {m_row[0], m_row[1]};
      const bool edge = mb != nullptr || k0 + kBlockN > S;
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        const float2 ks = *reinterpret_cast<const float2*>(cKs + col);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float k_scale = c ? ks.y : ks.x;
          float fill = 0.f;
          bool keep = true;
          if (edge) {
            const int key = k0 + col + c;
            if (key >= S) {
              keep = false;
              fill = -INFINITY;              // not a key at all
            } else if (mb != nullptr && mb[key] == 0) {
              keep = false;
              fill = kMaskedScore;
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + c;
            s[e] = keep ? (float)sc[e] * q_scale[i] * k_scale : fill;
            mx[i] = fmaxf(mx[i], s[e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m starts at -1e30 and never falls: no -inf - -inf here
        const float alpha = exp2f(m_row[i] - mx[i]);
        m_row[i] = mx[i];
        l_row[i] *= alpha;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          o_acc[4 * n + 2 * i] *= alpha;
          o_acc[4 * n + 2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * n + e] = exp2f(s[4 * n + e] - m_row[e >> 1]);
          l_row[e >> 1] += s[4 * n + e];
        }
      }
      uint32_t pf[kBlockN / 16][4];          // P as A operands, k16 steps
      pack_a<kBlockN / 16>(pf, s);

      // O += P V: V is [key][d], read MN-major (d contiguous)
      mbar_wait(&v_full[st], ph);
      fence_regs(pf);
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_n128<1>(o_acc, pf[kk],
                         make_desc(cV + kk * 16 * 128, kVBoxBytes, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: O = acc / max(l, 1e-30), as the JAX kernel divides
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + i * 8;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(l_row[i], 1e-30f);
      OutT* orow = static_cast<OutT*>(p.o) + b * p.o_sb + row * p.o_ss +
                   h * p.o_sh;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        store2(orow + col, o_acc[4 * n + 2 * i] * inv,
               o_acc[4 * n + 2 * i + 1] * inv);
      }
    }
  }
}

// ---- the row quantization ---------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kRowsPerBlock = kQuantThreads / 16;   // one half-warp per row

struct QuantParams {
  const void* x[2];                          // q, k: (B, S, H, 128)
  long long sb[2], ss[2], sh[2];             // their element strides
  int8_t* xq[2];                             // (B, S, H, 128), contiguous
  float* xs[2];                              // (B, H, S), contiguous
  uint32_t rows;                             // B S H < 2^31
  uint32_t S, H;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename InT>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_int8_kernel(const QuantParams p) {
  const uint32_t row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 4);
  if (row >= p.rows) return;                 // a whole half-warp at once
  const int lane = threadIdx.x & 15;
  const unsigned half = (threadIdx.x & 16) ? 0xFFFF0000u : 0x0000FFFFu;
  const uint32_t bs = row / p.H;
  const int h = (int)(row - bs * p.H);
  const uint32_t b = bs / p.S;
  const int s = (int)(bs - b * p.S);
  // blockIdx.y: 0 for q, 1 for k. The fields are selected, not indexed: a
  // parameter array indexed by a variable is copied to the stack first
  const bool is_k = blockIdx.y == 1;
  const InT* x = static_cast<const InT*>(is_k ? p.x[1] : p.x[0]) +
                 b * (is_k ? p.sb[1] : p.sb[0]) +
                 s * (is_k ? p.ss[1] : p.ss[0]) +
                 h * (is_k ? p.sh[1] : p.sh[0]) + 8 * lane;
  float v[8];
  load8(x, v);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(half, amax, o));
  }
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.f), 127.f);
    packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)r << (8 * (i % 4));
  }
  int8_t* xq = is_k ? p.xq[1] : p.xq[0];
  *reinterpret_cast<uint2*>(xq + (long long)row * kD + 8 * lane) =
      make_uint2(packed[0], packed[1]);
  if (lane == 0) {
    (is_k ? p.xs[1] : p.xs[0])[((long long)b * p.H + h) * p.S + s] = scale;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes; the caller checks shapes, dtypes,
// strides and alignment before calling, and each launches on `stream`.
//
// The attention builds the TMA maps of the int8 q and k rows, of v and of
// the key scales ((B H, S) rows `ks_pitch` values apart, a multiple of 4),
// and returns 0, a CUDA error code, or hopper::kTmaRefused + ... for a map
// that cuTensorMapEncodeTiled refused (q, k, v, k_scale numbered 0, 1, 2,
// 4). O is fp32 when out_f32 is nonzero, else bf16.
extern "C" int arcflow_flash_int8(
    const void* q, const void* k, const void* v, const void* q_scale,
    const void* k_scale, const void* kv_valid, void* o, int B, int S, int H,
    int out_f32, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long m_sb, long long ks_pitch, float scale_log2,
    void* stream) {
  // a runtime call first: it makes the device's context current on this
  // thread, which libcuda's map encoder needs (make_bshd_map_of)
  cudaError_t e = cudaFuncSetAttribute(
      out_f32 ? (const void*)flash_int8_kernel<float>
              : (const void*)flash_int8_kernel<__nv_bfloat16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_q, map_k, map_v, map_ks;
  int err = make_bshd_map_of(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, B,
                             S, H, q_sb, q_ss, q_sh, kBlockM, 0);
  if (err == 0) err = make_bshd_map_of(&map_k, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                       1, k, B, S, H, k_sb, k_ss, k_sh,
                                       kBlockN, 1);
  if (err == 0) err = make_bshd_map(&map_v, v, B, S, H, v_sb, v_ss, v_sh,
                                    kBlockN, 2);
  if (err == 0) err = make_f32_rows_map(&map_ks, k_scale, (long long)B * H,
                                        S, ks_pitch, kBlockN, 4);
  if (err != 0) return err;
  Params p;
  p.qs = static_cast<const float*>(q_scale);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.o = o;
  p.B = B;
  p.S = S;
  p.H = H;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = scale_log2;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    flash_int8_kernel<float><<<grid, kThreads, kSmemBytes, st>>>(
        map_q, map_k, map_v, map_ks, p);
  } else {
    flash_int8_kernel<__nv_bfloat16><<<grid, kThreads, kSmemBytes, st>>>(
        map_q, map_k, map_v, map_ks, p);
  }
  return (int)cudaGetLastError();
}

// The quantization of q and k, one launch: reads (B, S, H, 128) rows, bf16
// (in_f32 == 0) or fp32, through their strides; writes contiguous int8 rows
// qq, kq and fp32 (B, H, S) scales qs, ks. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for B S H >= 2^31 rows.
extern "C" int arcflow_quantize_rows_int8(
    const void* q, const void* k, int in_f32, int B, int S, int H,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, void* qq, void* qs, void* kq, void* ks,
    void* stream) {
  QuantParams p;
  p.x[0] = q; p.x[1] = k;
  p.sb[0] = q_sb; p.ss[0] = q_ss; p.sh[0] = q_sh;
  p.sb[1] = k_sb; p.ss[1] = k_ss; p.sh[1] = k_sh;
  p.xq[0] = static_cast<int8_t*>(qq); p.xq[1] = static_cast<int8_t*>(kq);
  p.xs[0] = static_cast<float*>(qs); p.xs[1] = static_cast<float*>(ks);
  const long long rows = (long long)B * S * H;
  if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  p.rows = (uint32_t)rows;
  p.S = S;
  p.H = H;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock), 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32) {
    quantize_rows_int8_kernel<float><<<grid, kQuantThreads, 0, st>>>(p);
  } else {
    quantize_rows_int8_kernel<__nv_bfloat16><<<grid, kQuantThreads, 0, st>>>(
        p);
  }
  return (int)cudaGetLastError();
}
