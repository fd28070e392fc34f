// Non-causal attention forward for Hopper (sm_90a): bf16 q/k/v, fp32 softmax.
//
// Replaces the TPU attention kernels of the JAX package:
//   arcflow_tpu/models/layers.py:_splash_call (splash attention, the serving
//     path for unmasked attention) and
//   arcflow_tpu/models/layers.py:_flash_call (flash attention forward, with
//     the key-padding mask it lowers to segment ids).
// One kernel covers both: the mask is an optional per-key validity vector.
//
// What bounds it on the card: at the FLUX serving shape (B1 S4608 H24 D128)
// one call does 4*S*S*D*H = 261 GFLOP on 113 MB of q, k, v and o, about 2300
// operations per byte of device memory, far above the H100's balance point of
// about 295 bf16 operations per byte. It is bound by tensor-core throughput,
// and only wgmma reaches the card's full bf16 rate; K and V tiles are re-read
// by every query tile, but those re-reads are served from the 50 MB L2.
//
// Design (warp specialised, one CTA of three warpgroups per 128 query rows of
// one (batch, head)):
//   * the producer warpgroup gives up its registers (setmaxnreg) and one of
//     its threads issues every TMA load: Q once (128 x 128), then 128-key K
//     and V tiles into a ring of kStages stages, each stage's K and V on
//     their own mbarrier, a stage refilled once both consumers have
//     released it;
//   * two consumer warpgroups own 64 query rows each. Per K/V tile:
//     S = Q K^T as eight m64n128k16 wgmma with both operands in shared
//     memory (K-major), the online softmax in fp32 registers in base 2 with
//     the scale folded in, then O += P V as eight m64n128k16 wgmma with P
//     re-packed from the S accumulator as the register A operand and V read
//     MN-major (transposed by the descriptor);
//   * every tile lies in shared memory 128-byte swizzled, as TMA writes it
//     and the wgmma descriptors read it (hopper.cuh).
// What it leaves on the table: each consumer waits for its own S before its
// softmax and for P V before the next S. Issuing the next tile's S before
// this tile's softmax, and ping-pong scheduling of the two consumers, are
// the next steps.
//
// Keys at or past S arrive as zero rows (TMA fills them) and are masked to
// -inf, as are keys whose kv_valid byte is 0. A query row with no valid key
// gets O = 0 and LSE = -inf. There is no split over keys: each output row is
// summed by one warpgroup in one order, so the result is bitwise repeatable.
//
// Layouts: q, k, v and o are (B, S, H, D) with D contiguous, read (by TMA)
// and written through their strides; kv_valid is (B, S) bytes, nonzero for a
// valid key, or null; lse is (B, H, S) fp32, contiguous.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;                      // head dim
constexpr int kBlockM = 128;                 // query rows per CTA
constexpr int kBlockN = 128;                 // keys per K/V tile
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kTileBytes = 128 * kD * 2;     // one 128-row bf16 tile
constexpr int kBoxBytes = kTileBytes / 2;    // its 64-column half
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes +
                           (1 + 3 * kStages) * 8 + 1024;

struct Params {
  const uint8_t* kv_valid;
  __nv_bfloat16* o;
  float* lse;
  int B, S, H;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale_log2;                          // log2(e) / sqrt(D)
};

__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;                               // [2][128][128 B]
  unsigned char* sK = sQ + kTileBytes;                    // [kStages] tiles
  unsigned char* sV = sK + kStages * kTileBytes;          // [kStages] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
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
      mbar_expect_tx(q_full, kTileBytes);
      tma_load_4d(sQ, &map_q, q_full, 0, q0, h, b);
      tma_load_4d(sQ + kBoxBytes, &map_q, q_full, 64, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        unsigned char* k_dst = sK + st * kTileBytes;
        unsigned char* v_dst = sV + st * kTileBytes;
        mbar_expect_tx(&k_full[st], kTileBytes);
        tma_load_4d(k_dst, &map_k, &k_full[st], 0, j * kBlockN, h, b);
        tma_load_4d(k_dst + kBoxBytes, &map_k, &k_full[st], 64, j * kBlockN,
                    h, b);
        mbar_expect_tx(&v_full[st], kTileBytes);
        tma_load_4d(v_dst, &map_v, &v_full[st], 0, j * kBlockN, h, b);
        tma_load_4d(v_dst + kBoxBytes, &map_v, &v_full[st], 64, j * kBlockN,
                    h, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63 ----
    setmaxnreg_inc<240>();
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;       // warp within the warpgroup
    const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

    float o_acc[kD / 2];                     // 64 x 128 fp32, wgmma layout
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;
    // this thread's two rows: 16 warp + lane/4 (+ 8) of the warpgroup's 64
    float m_row[2] = {-INFINITY, -INFINITY}; // running max (base-2 domain)
    float l_row[2] = {0.f, 0.f};             // this thread's partial sums

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const int k0 = j * kBlockN;
      const unsigned char* cK = sK + st * kTileBytes;
      const unsigned char* cV = sV + st * kTileBytes;

      // S = Q K^T: this warpgroup's 64 rows x 128 keys, over d in k16 steps
      float s[kBlockN / 2];
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128<0, 0>(s, make_desc(sQ + off + wg * 64 * 128, 16, 1024),
                            make_desc(cK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scale, mask, online softmax
      float mx[2] = {m_row[0], m_row[1]};
      if (mb != nullptr || k0 + kBlockN > S) {
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + n * 8 + (lane & 3) * 2 + c;
            const bool ok = key < S && (mb == nullptr || mb[key] != 0);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * n + 2 * i + c];
              x = ok ? x * p.scale_log2 : -INFINITY;
              mx[i] = fmaxf(mx[i], x);
            }
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * n + e] *= p.scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
          }
        }
      }
      float ref[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row with no valid key so far keeps -inf as its max; exponentiate
        // against 0 instead, so that exp2(-inf - ref) = 0 and nothing is NaN
        ref[i] = mx[i] == -INFINITY ? 0.f : mx[i];
        const float alpha = exp2f(m_row[i] - ref[i]);
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
          s[4 * n + e] = exp2f(s[4 * n + e] - ref[e >> 1]);
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
                         make_desc(cV + kk * 16 * 128, kBoxBytes, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: normalise, write O (bf16) and LSE (natural log)
    constexpr float kLn2 = 0.69314718055994530942f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + i * 8;
      if (row >= S) continue;
      const float inv = l_row[i] > 0.f ? 1.f / l_row[i] : 0.f;
      __nv_bfloat16* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
            o_acc[4 * n + 2 * i] * inv, o_acc[4 * n + 2 * i + 1] * inv);
      }
      if ((lane & 3) == 0) {
        p.lse[((long long)b * p.H + h) * S + row] =
            l_row[i] > 0.f ? m_row[i] * kLn2 + logf(l_row[i]) : -INFINITY;
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Builds the TMA maps of q, k and v
// from their pointers and strides, launches on `stream` and returns 0, a
// CUDA error code, or hopper::kTmaRefused + ... for a map the driver
// refused (q, k, v numbered 0-2); the caller checks shapes, dtypes, strides
// and alignment before calling.
extern "C" int arcflow_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* o, void* lse, int B, int S, int H, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long m_sb, void* stream) {
  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's map encoder needs (make_bshd_map)
  cudaError_t e = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_q, map_k, map_v;
  int err = make_bshd_map(&map_q, q, B, S, H, q_sb, q_ss, q_sh, kBlockM, 0);
  if (err == 0) err = make_bshd_map(&map_k, k, B, S, H, k_sb, k_ss, k_sh,
                                    kBlockN, 1);
  if (err == 0) err = make_bshd_map(&map_v, v, B, S, H, v_sb, v_ss, v_sh,
                                    kBlockN, 2);
  if (err != 0) return err;
  Params p;
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.H = H;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)kD);
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(map_q, map_k,
                                                              map_v, p);
  return (int)cudaGetLastError();
}

extern "C" const char* arcflow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
