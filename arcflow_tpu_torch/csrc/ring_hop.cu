// One hop of ring attention for Hopper (sm_90a): bf16 q/k/v, fp32 carry.
//
// Replaces the TPU ring hop of the JAX package,
//   arcflow_tpu/parallel/ring_attention.py:_hop_stats_pallas
// (the Pallas flash kernel with save_residuals=True, which returns the
// normalized block output and each row's (l, m)), together with the fp32
// merge that _ring_flash_core does after every hop (lines 187-190): here the
// hop folds the visiting K/V block straight into the running carry.
//
// Contract, per (batch, head, query row), over the keys seen so far:
//   m   (B, H, Sq) fp32: the largest scaled score, natural-log units, -inf
//       while no valid key has been seen;
//   l   (B, H, Sq) fp32: sum_j exp(s_j - m);
//   acc (B, Sq, H, 128) fp32: sum_j exp(s_j - m) v_j (not normalized).
// `first` starts the carry at (0, -inf, 0) instead of reading it; `last`
// also writes O = acc / l in bf16, or 0 where l = 0. The carry is always
// written back; each query row belongs to exactly one CTA, so the update in
// place has no race. Keys are masked by a per-key validity vector (nonzero =
// valid), and keys past Skv are masked as in attention_fwd.cu.
//
// What bounds it on the card: one hop at sp = 4 of the FLUX shape (Sq = Skv =
// 1152, H24, D128) does 4*Sq*Skv*D*H = 16.3 GFLOP (0.0165 ms at 989 TFLOP/s)
// and moves 21 MB of bf16 q/k/v plus 28 MB of fp32 carry read and written
// (0.015 ms at 3.35 TB/s): operations and bytes are nearly balanced, where the
// full-sequence attention is far above the balance point. The fp32 carry is
// the price of folding in the kernel; it saves the separate merge pass over
// the hop's output that the TPU path runs in XLA.
//
// Design: attention_fwd.cu's (warp specialised, one CTA of three warpgroups
// per 128 query rows of one (batch, head), on hopper.cuh):
//   * the producer warpgroup gives up its registers and one of its threads
//     issues every TMA load: Q once, the CTA's 128 rows of the carried acc
//     (fp32, four 32-column boxes) beside it unless `first`, then 128-key K
//     and V tiles into a two-stage mbarrier ring;
//   * two consumer warpgroups own 64 query rows each: S = Q K^T and O += P V
//     as m64n128k16 wgmma, the online softmax in fp32 registers in base 2.
//     m and l come from device memory into registers at entry; the carried
//     acc is read from shared memory into the O accumulators while the first
//     S product runs, so its load never delays that product;
//   * on exit the carry goes back from registers, and with `last` O too.
// What it leaves on the table: at the FLUX hop (216 CTAs of 9 key tiles on
// 132 SMs) the second wave runs 84 CTAs, and each CTA's carry in and out is
// large next to its 9 tiles of products; a persistent grid that overlaps one
// tile's epilogue with the next one's loads is the next step.
//
// Keys at or past Skv arrive as zero rows (TMA fills them) and are masked to
// -inf, as are keys whose kv_valid byte is 0. There is no split over keys:
// each output row is summed by one warpgroup in one order, so the result is
// bitwise repeatable, and a row that has seen no valid key keeps l = 0 and
// m = -inf exactly.
//
// Layouts: q (B, Sq, H, D), k and v (B, Skv, H, D) and o (B, Sq, H, D) with D
// contiguous, read (by TMA) and written through their strides; kv_valid (B,
// Skv) bytes or null; acc, m and l contiguous in the shapes above.

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
constexpr int kAccBytes = kBlockM * kD * 4;  // the CTA's fp32 acc rows
constexpr int kAccBoxBytes = kAccBytes / 4;  // one 32-column box of them
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + kAccBytes +
                           (2 + 3 * kStages) * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994530942f;

struct Params {
  const uint8_t* kv_valid;
  float* acc;
  float* m;
  float* l;
  __nv_bfloat16* o;
  int Sq, Skv, H;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale_log2;                          // log2(e) / sqrt(D)
  int first, last;
};

// Byte offset of fp32 column c of row r in the acc tile: four 128-byte
// swizzled boxes of 32 columns, as TMA writes them.
__device__ __forceinline__ uint32_t acc_offset(int r, int c) {
  return (c >> 5) * kAccBoxBytes + r * 128 +
         (((((c & 31) >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

__global__ void __launch_bounds__(kThreads, 1)
    ring_hop_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_acc,
                    const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;                               // [2][128][128 B]
  unsigned char* sK = sQ + kTileBytes;                    // [kStages] tiles
  unsigned char* sV = sK + kStages * kTileBytes;          // [kStages] tiles
  unsigned char* sAcc = sV + kStages * kTileBytes;        // [4][128][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sAcc + kAccBytes);
  uint64_t* acc_full = q_full + 1;
  uint64_t* k_full = acc_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int Sq = p.Sq, Skv = p.Skv;
  const int n_tiles = (Skv + kBlockN - 1) / kBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(acc_full, 1);
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
        if (j == 0 && !p.first) {            // the carry, behind K0
          mbar_expect_tx(acc_full, kAccBytes);
          for (int c = 0; c < 4; ++c) {
            tma_load_4d(sAcc + c * kAccBoxBytes, &map_acc, acc_full, 32 * c,
                        q0, h, b);
          }
        }
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
    const int r_cta = wg * 64 + warp * 16 + (lane >> 2);  // row in the CTA
    const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

    // this thread's two rows r_cta and r_cta + 8: the carried m (base 2)
    // and l (held by the quad's first thread; the others start at 0)
    float m_row[2], l_row[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_cta + i * 8;
      const bool read = !p.first && row < Sq;
      const long long st = ((long long)b * p.H + h) * Sq + row;
      m_row[i] = read ? p.m[st] * kLog2e : -INFINITY;
      l_row[i] = read && (lane & 3) == 0 ? p.l[st] : 0.f;
    }
    float o_acc[kD / 2];                     // 64 x 128 fp32, wgmma layout
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;

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
      if (j == 0 && !p.first) {
        // the carried acc into the O accumulators while S runs: row
        // r_cta (+ 8), columns 8 n + 2 (lane % 4) + {0, 1}
        mbar_wait(acc_full, 0);
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 a = *reinterpret_cast<const float2*>(
                sAcc + acc_offset(r_cta + 8 * i, n * 8 + (lane & 3) * 2));
            o_acc[4 * n + 2 * i] = a.x;
            o_acc[4 * n + 2 * i + 1] = a.y;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(s);

      // scale, mask, online softmax
      float mx[2] = {m_row[0], m_row[1]};
      if (mb != nullptr || k0 + kBlockN > Skv) {
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + n * 8 + (lane & 3) * 2 + c;
            const bool ok = key < Skv && (mb == nullptr || mb[key] != 0);
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

    // epilogue: the carry out (m in natural log), and O on the last hop
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
      const int row = q0 + r_cta + i * 8;
      if (row >= Sq) continue;
      if ((lane & 3) == 0) {
        const long long st = ((long long)b * p.H + h) * Sq + row;
        p.m[st] = m_row[i] * kLn2;
        p.l[st] = l_row[i];
      }
      float* arow = p.acc + (((long long)b * Sq + row) * p.H + h) * kD;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        *reinterpret_cast<float2*>(arow + n * 8 + (lane & 3) * 2) =
            make_float2(o_acc[4 * n + 2 * i], o_acc[4 * n + 2 * i + 1]);
      }
      if (p.last) {
        const float inv = l_row[i] > 0.f ? 1.f / l_row[i] : 0.f;
        __nv_bfloat16* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          const int col = n * 8 + (lane & 3) * 2;
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
              o_acc[4 * n + 2 * i] * inv, o_acc[4 * n + 2 * i + 1] * inv);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Builds the TMA maps of q, k, v
// and acc from their pointers and strides, launches on `stream` and returns
// 0, a CUDA error code, or hopper::kTmaRefused + ... for a map libcuda
// refused (q, k, v, acc numbered 0-3); the caller checks shapes, dtypes,
// strides and alignment before calling. `o` may be null unless `last`.
extern "C" int arcflow_ring_hop(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* acc, void* m, void* l, void* o, int B, int Sq, int Skv, int H,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long m_sb, int first, int last, void* stream) {
  // a runtime call first: it makes the device's context current on this
  // thread, which libcuda's map encoder needs (make_bshd_map)
  cudaError_t e = cudaFuncSetAttribute(
      ring_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map_q, map_k, map_v, map_acc;
  int err = make_bshd_map(&map_q, q, B, Sq, H, q_sb, q_ss, q_sh, kBlockM, 0);
  if (err == 0) err = make_bshd_map(&map_k, k, B, Skv, H, k_sb, k_ss, k_sh,
                                    kBlockN, 1);
  if (err == 0) err = make_bshd_map(&map_v, v, B, Skv, H, v_sb, v_ss, v_sh,
                                    kBlockN, 2);
  if (err == 0) {
    err = make_bshd_map_of(&map_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc,
                           B, Sq, H, (long long)Sq * H * kD, (long long)H * kD,
                           kD, kBlockM, 3);
  }
  if (err != 0) return err;
  Params p;
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  p.first = first;
  p.last = last;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  ring_hop_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(map_q, map_k, map_v,
                                                         map_acc, p);
  return (int)cudaGetLastError();
}
