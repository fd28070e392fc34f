// Non-causal attention backward for Hopper (sm_90a): dq, dk, dv in bf16 from
// bf16 q/k/v/o/dO and the forward's fp32 log-sum-exp.
//
// Replaces the TPU backward kernels of the JAX package: the custom VJP of
//   arcflow_tpu/models/layers.py:_flash_call (the library flash-attention
//   dq and dkv Pallas kernels, block sizes at layers.py:569-573), with the
//   key-padding mask that call lowers to segment ids.
//
// What bounds it on the card: at the FLUX training shape (B1 S4608 H24 D128)
// the gradients need five S x S x D products per head (S = Q K^T and
// dP = dO V^T once each, dV = P^T dO, dK = dS^T Q, dQ = dS K): 652 GFLOP on
// 227 MB of inputs and outputs, far above the H100's balance point of about
// 295 bf16 operations per byte, so it is bound by tensor-core throughput, and
// only wgmma reaches the card's full bf16 rate.
//
// Design: two launches on one stream, five products, no unordered atomics.
//   * preprocess, one warp per (batch, head, row): delta = rowsum(dO * O)
//     and the LSE in base 2 (+inf for a row with no valid key, so that its
//     P is 0), both padded with zero and +inf to whole 64-row query tiles;
//     it also zeroes the dQ tile counters;
//   * main: one CTA of three warpgroups per (batch * head, 128-key tile).
//     The producer warpgroup gives up its registers (setmaxnreg); one of its
//     threads issues every load: K and V once by TMA (resident), then
//     64-query tiles of Q and dO by TMA and their LSE and delta rows by bulk
//     copy, into a ring of kStages stages under mbarriers; two others write
//     dQ (below). Two consumer warpgroups own 64 keys each, keep their dK
//     and dV (64 x 128 fp32) in registers and, per query tile, run every
//     product as wgmma:
//       S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in shared
//       memory, K-major), P^T = exp2(S^T - LSE), dS^T = P^T (dP^T - delta);
//       dV += P^T dO and dK += dS^T Q (m64n128k16, P^T and dS^T re-packed
//       from the accumulators as register A operands, dO and Q read
//       MN-major);
//       dS^T is written once to shared memory (128-byte swizzled); then each
//       warpgroup computes one 64-column half of the tile's dQ partial,
//       dS K over the CTA's 128 keys (m64n64k16, dS and K both read
//       MN-major through the descriptors' transpose bits).
//   * the dQ partials of one query tile meet in an fp32 scratch in key-tile
//     order. Each consumer warpgroup stages its 64 x 64 half in shared
//     memory (two buffers under mbarriers) for its own dQ writer, a thread
//     of the producer warpgroup, which for key tile kt waits until the
//     tile's counter reads kt, adds the half with one TMA bulk reduction
//     (key tile 0 stores it), waits for it to complete and releases the
//     counter to kt + 1, off the consumers' path. The last key tile reads
//     the sum, scales it and writes dq in bf16. Every dq element is summed
//     in one fixed order, so two launches give the same bits;
//   * so that a writer rarely waits, where the card holds all n_kt CTAs of
//     a (batch, head) at once (`stagger`, from the occupancy at launch),
//     they walk the query tiles from starts spread evenly over them, and a
//     tile's order is the order in which they reach it (sum_rank): each
//     CTA's predecessor got there a step or two before. A CTA may then wait
//     for one of its (batch, head) with a higher blockIdx; that one can
//     start, since the card dispatches CTAs in blockIdx order, those of
//     earlier (batch, head)s finish, and fewer than n_kt hold the card.
//     (Kernels on other streams that hold SMs meanwhile are not counted.)
//     Where the card holds fewer, every CTA walks from tile 0 and the order
//     is the key-tile order, in which a CTA waits only for ones dispatched
//     before it (0.2 ms slower at the FLUX shape, PERF.md).
// What it leaves on the table: each consumer waits for its products before
// the next stage (no overlap of softmax with wgmma inside a warpgroup), the
// two consumers meet at every query tile (dQ needs both halves of dS), and
// the dQ partials cross L2 once per key tile: S^2 / 128 x 128 fp32 per head.
//
// Masks: a key at or past S (TMA fills its rows with zeros), or with
// kv_valid false, gets P = 0, so it adds nothing to dQ and its dK and dV rows
// are 0. A query row whose LSE is -inf (no valid key) has P = 0 on every key:
// its dQ is 0 and it adds nothing to dK or dV. Query rows past S read as zero
// rows with LSE +inf for the same end and are never stored.
//
// Layouts: q, k, v, o, dO, dq, dk and dv are (B, S, H, D) with D contiguous,
// read (by TMA, or directly for o) and written through their strides; lse is
// (B, H, S) fp32, contiguous; kv_valid is (B, S) bytes, nonzero for a valid
// key, or null; the workspace is laid out by `Workspace` below.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 128;                      // head dim
constexpr int kBlockK = 128;                 // keys per CTA
constexpr int kBlockQ = 64;                  // queries per streamed tile
constexpr int kStages = 2;                   // Q/dO ring depth
constexpr int kThreads = 384;                // 2 consumer + 1 producer WG
constexpr int kPreThreads = 256;             // preprocess: 8 rows per block
constexpr int kKvBytes = kBlockK * kD * 2;   // a resident K or V tile
constexpr int kQBytes = kBlockQ * kD * 2;    // a streamed Q or dO tile
constexpr int kDsBytes = kBlockK * kBlockQ * 2;  // dS^T, 128 keys x 64 rows
constexpr int kRowBytes = kBlockQ * 4;       // a tile's LSE or delta row
constexpr int kDqBytes = kBlockQ * 64 * 4;   // a warpgroup's dQ partial
constexpr int kSmemBytes = 2 * kKvBytes + 2 * kStages * kQBytes +
                           2 * kDsBytes + 2 * 2 * kDqBytes +
                           2 * kStages * kRowBytes + (1 + 2 * kStages + 8) * 8 +
                           1024;
constexpr float kLog2e = 1.4426950408889634f;

struct Tensor4 {                             // (B, S, H, D), D contiguous
  __nv_bfloat16* ptr;
  long long sb, ss, sh;
  __device__ __forceinline__ __nv_bfloat16* head(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

// The fp32 workspace of one call, in this order: the base-2 LSE and delta
// (B*H rows of s_pad), the dQ tile counters (two per (batch, head, query
// tile), one per consumer warpgroup) and the dQ scratch (B*H x s_pad x D,
// as (batch * head, query tile, warpgroup) blocks of 64 x 64).
struct Workspace {
  long long bh, n_qt, s_pad, n_counters;
  Workspace(int B, int S, int H)
      : bh((long long)B * H), n_qt((S + kBlockQ - 1) / kBlockQ),
        s_pad(n_qt * kBlockQ), n_counters((bh * n_qt * 2 + 3) / 4 * 4) {}
  long long lse2() const { return 0; }
  long long delta() const { return bh * s_pad; }
  long long counters() const { return 2 * bh * s_pad; }
  long long dq_acc() const { return 2 * bh * s_pad + n_counters; }
  long long bytes() const { return 4 * (dq_acc() + bh * s_pad * kD); }
};

struct Params {
  Tensor4 q, k, v, o, dout, dq, dk, dv;
  const float* lse;
  float* lse2;                               // (B*H, s_pad), base 2
  float* delta;                              // (B*H, s_pad)
  int* counters;                             // (B*H, n_qt, 2)
  float* dq_acc;                             // (B*H, n_qt, 2, 64 * 64)
  const uint8_t* kv_valid;
  long long m_sb;
  int B, S, H, n_qt, s_pad;
  bool stagger;                              // staggered starts (note)
  float scale;                               // 1 / sqrt(D)
  float scale_log2;                          // log2(e) / sqrt(D)
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The query tiles in the order the CTA of key tile kt visits them: from
// `first_tile` on, cyclically. With `stagger` the n_kt CTAs of a (batch,
// head) start evenly spread over the n_qt tiles; else all start at tile 0.
__device__ __forceinline__ int first_tile(int kt, int n_kt, int n_qt,
                                          bool stagger) {
  return stagger ? (int)((long long)kt * n_qt / n_kt) : 0;
}

// The place of key tile kt in the fixed order in which the dQ partials of
// query tile `it` are summed: the order in which the CTAs reach that tile.
// Staggered, the CTAs whose first tile is at or before `it` come first,
// nearest first (f - 1, ..., 0), then the rest (n_kt - 1, ..., f), so that
// each CTA's predecessor reached the tile a step or two earlier.
__device__ __forceinline__ int sum_rank(int kt, int it, int n_kt, int n_qt,
                                        bool stagger) {
  if (!stagger) return kt;
  const int f = min(n_kt, (int)(((long long)(it + 1) * n_kt + n_qt - 1) /
                                n_qt));
  return (f - 1 - kt + n_kt) % n_kt;
}

__global__ void __launch_bounds__(kPreThreads)
    attention_bwd_preprocess_kernel(const Params p) {
  const long long row =
      ((long long)blockIdx.x * kPreThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.s_pad) return;
  if (lane == 0 && row < (long long)p.B * p.H * p.n_qt * 2) {
    p.counters[row] = 0;
  }
  const int s = (int)(row % p.s_pad);
  const int bh = (int)(row / p.s_pad);
  const int b = bh / p.H;
  const int h = bh % p.H;
  if (s >= p.S) {
    if (lane == 0) {
      p.delta[row] = 0.f;
      p.lse2[row] = INFINITY;
    }
    return;
  }
  const uint2 ov = *reinterpret_cast<const uint2*>(
      p.o.head(b, h) + s * p.o.ss + lane * 4);
  const uint2 dv = *reinterpret_cast<const uint2*>(
      p.dout.head(b, h) + s * p.dout.ss + lane * 4);
  const float2 o0 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&ov.x));
  const float2 o1 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&ov.y));
  const float2 d0 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&dv.x));
  const float2 d1 = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&dv.y));
  float acc = o0.x * d0.x + o0.y * d0.y + o1.x * d1.x + o1.y * d1.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float l = p.lse[(long long)bh * p.S + s];
    p.delta[row] = acc;
    p.lse2[row] = l == -INFINITY ? INFINITY : l * kLog2e;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;                          // [2][128][128 B]
  unsigned char* sV = sK + kKvBytes;                 // [2][128][128 B]
  unsigned char* sQ = sV + kKvBytes;                 // [kStages][2][64][128 B]
  unsigned char* sdO = sQ + kStages * kQBytes;       // [kStages][2][64][128 B]
  unsigned char* sdS = sdO + kStages * kQBytes;      // [2][128][128 B]
  float* sdQ = reinterpret_cast<float*>(sdS + 2 * kDsBytes);  // [2][2][4096]
  float* sL = sdQ + 2 * 2 * (kDqBytes / 4);                  // [kStages][64]
  float* sDl = sL + kStages * kBlockQ;                       // [kStages][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDl + kStages * kBlockQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;       // [buffer * 2 + warpgroup]
  uint64_t* dq_empty = dq_full + 4;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int kt = blockIdx.x;
  const int n_kt = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kt * kBlockK;
  const int S = p.S;
  const int n_qt = p.n_qt;
  const int it0 = first_tile(kt, n_kt, n_qt, p.stagger);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);              // one arrival per consumer warp
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(&dq_full[i], 128);           // every thread of a consumer WG
      mbar_init(&dq_empty[i], 1);            // its dQ writer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 256) {
      mbar_expect_tx(kv_full, 2 * kKvBytes);
      tma_load_4d(sK, &map_k, kv_full, 0, k0, h, b);
      tma_load_4d(sK + kKvBytes / 2, &map_k, kv_full, 64, k0, h, b);
      tma_load_4d(sV, &map_v, kv_full, 0, k0, h, b);
      tma_load_4d(sV + kKvBytes / 2, &map_v, kv_full, 64, k0, h, b);
      const float* lse2 = p.lse2 + (long long)bh * p.s_pad;
      const float* delta = p.delta + (long long)bh * p.s_pad;
      for (int j = 0; j < n_qt; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        const int r0 = ((it0 + j) % n_qt) * kBlockQ;
        unsigned char* q_dst = sQ + st * kQBytes;
        unsigned char* do_dst = sdO + st * kQBytes;
        mbar_expect_tx(&full[st], 2 * kQBytes + 2 * kRowBytes);
        tma_load_4d(q_dst, &map_q, &full[st], 0, r0, h, b);
        tma_load_4d(q_dst + kQBytes / 2, &map_q, &full[st], 64, r0, h, b);
        tma_load_4d(do_dst, &map_do, &full[st], 0, r0, h, b);
        tma_load_4d(do_dst + kQBytes / 2, &map_do, &full[st], 64, r0, h, b);
        bulk_load(sL + st * kBlockQ, lse2 + r0, kRowBytes, &full[st]);
        bulk_load(sDl + st * kBlockQ, delta + r0, kRowBytes, &full[st]);
      }
    } else if (tid == 288 || tid == 320) {
      // dQ writer of consumer warpgroup w: adds each staged block to the
      // scratch at its place in the tile's order (module note), waits for
      // the addition to complete and releases the tile's counter and the
      // staging buffer
      const int w = (tid - 288) / 32;
      uint32_t uses = 0;                     // bit b: uses of buffer b, mod 2
      for (int j = 0; j < n_qt; ++j) {
        const int it = (it0 + j) % n_qt;
        const int rank = sum_rank(kt, it, n_kt, n_qt, p.stagger);
        if (rank == n_kt - 1) continue;      // the consumers finish the tile
        const int buf = j & 1;
        mbar_wait(&dq_full[buf * 2 + w], (uses >> buf) & 1);
        int* ctr = p.counters + ((long long)bh * n_qt + it) * 2 + w;
        float* blk = p.dq_acc + (((long long)bh * n_qt + it) * 2 + w) *
                                    (kDqBytes / 4);
        const float* stage = sdQ + (buf * 2 + w) * (kDqBytes / 4);
        if (rank > 0) {
          while (ld_acquire(ctr) != rank) {
          }
          fence_proxy_async_global();
          bulk_reduce_add(blk, stage, kDqBytes);
        } else {
          bulk_store(blk, stage, kDqBytes);
        }
        bulk_commit();
        bulk_wait<0>();
        fence_proxy_async_global();
        st_release(ctr, rank + 1);
        mbar_arrive(&dq_empty[buf * 2 + w]);
        uses ^= 1u << buf;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63 --
    setmaxnreg_inc<240>();
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;       // warp within the warpgroup
    const int wtid = tid & 127;
    const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

    // this thread's two keys: rows 16 warp + lane/4 (+ 8) of the 64
    bool key_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + wg * 64 + warp * 16 + (lane >> 2) + i * 8;
      key_ok[i] = key < S && (mb == nullptr || mb[key] != 0);
    }

    float dv_acc[kD / 2];                    // 64 keys x 128 fp32
    float dk_acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

    uint32_t uses = 0;                       // bit b: uses of buffer b, mod 2
    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_qt; ++j) {
      const int it = (it0 + j) % n_qt;       // the query tile of this step
      const int st = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const unsigned char* cQ = sQ + st * kQBytes;
      const unsigned char* cdO = sdO + st * kQBytes;
      const float* cL = sL + st * kBlockQ;
      const float* cDl = sDl + st * kBlockQ;
      unsigned char* cdS = sdS + (j & 1) * kDsBytes;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, over d
      float s[kBlockQ / 2], dp[kBlockQ / 2];
      mbar_wait(&full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off_k = (kk / 4) * (kKvBytes / 2) + (kk % 4) * 32 +
                          wg * 64 * 128;
        const int off_q = (kk / 4) * (kQBytes / 2) + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(s, make_desc(sK + off_k, 16, 1024),
                           make_desc(cQ + off_q, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off_k = (kk / 4) * (kKvBytes / 2) + (kk % 4) * 32 +
                          wg * 64 * 128;
        const int off_q = (kk / 4) * (kQBytes / 2) + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dp, make_desc(sV + off_k, 16, 1024),
                           make_desc(cdO + off_q, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(S^T scale - LSE) and dS^T = P^T (dP^T - delta), in place
#pragma unroll
      for (int n = 0; n < kBlockQ / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n * 8 + (lane & 3) * 2 + c;
          const float lse = cL[col];
          const float dl = cDl[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * n + 2 * i + c;
            const float pv =
                key_ok[i] ? exp2f(s[e] * p.scale_log2 - lse) : 0.f;
            s[e] = pv;
            dp[e] = pv * (dp[e] - dl);
          }
        }
      }
      uint32_t pf[kBlockQ / 16][4], dsf[kBlockQ / 16][4];
      pack_a<kBlockQ / 16>(pf, s);
      pack_a<kBlockQ / 16>(dsf, dp);

      // dS^T rows of this warpgroup's keys into the swizzled [key][query]
      // tile that both warpgroups read for dQ
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wg * 64 + warp * 16 + (lane >> 2) + i * 8;
            const int c = kk * 16 + hh * 8 + (lane & 3) * 2;
            *reinterpret_cast<uint32_t*>(cdS + swizzle128_offset(r, c)) =
                dsf[kk][2 * hh + i];
          }
        }
      }
      fence_proxy_async();

      // dV += P^T dO and dK += dS^T Q: dO and Q are [query][d], MN-major
      fence_regs(pf);
      fence_regs(dsf);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        wgmma_rs_n128<1>(dv_acc, pf[kk],
                         make_desc(cdO + kk * 16 * 128, kQBytes / 2, 1024),
                         1);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockQ / 16; ++kk) {
        wgmma_rs_n128<1>(dk_acc, dsf[kk],
                         make_desc(cQ + kk * 16 * 128, kQBytes / 2, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();                       // frees P^T and dS^T registers
      fence_regs(pf);
      fence_regs(dsf);
      fence_regs(dv_acc);
      fence_regs(dk_acc);

      // dQ columns 64 wg .. 64 wg + 63 of this query tile: dS K over the
      // CTA's 128 keys; A = dS from the [key][query] tile (MN-major), B = K
      // from its [key][d] box wg (MN-major)
      named_bar_sync(1, 256);                // both halves of dS^T written
      float dq[kBlockQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wgmma_ss_n64<1, 1>(
            dq, make_desc(cdS + kk * 16 * 128, kDsBytes, 1024),
            make_desc(sK + wg * (kKvBytes / 2) + kk * 16 * 128,
                      kKvBytes / 2, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[st]);

      // The tile's dQ partials meet in the order of sum_rank, one 16 KB
      // block per warpgroup (its 64 columns), laid out fragment-major:
      // float2 f = 2 n + i of thread t at (f * 128 + t). All but the last
      // place stage the block in shared memory for the warpgroup's dQ
      // writer; the last place reads the sum and writes dq.
      const int rank = sum_rank(kt, it, n_kt, n_qt, p.stagger);
      if (rank < n_kt - 1) {
        const int buf = j & 1;
        mbar_wait(&dq_empty[buf * 2 + wg], ((uses >> buf) & 1) ^ 1);
        float* stage = sdQ + (buf * 2 + wg) * (kDqBytes / 4);
#pragma unroll
        for (int f = 0; f < kBlockQ / 4; ++f) {
          reinterpret_cast<float2*>(stage)[f * 128 + wtid] =
              make_float2(dq[2 * f], dq[2 * f + 1]);
        }
        fence_proxy_async();
        mbar_arrive(&dq_full[buf * 2 + wg]);
        uses ^= 1u << buf;
      } else {
        const float2* blk = reinterpret_cast<const float2*>(
            p.dq_acc + (((long long)bh * n_qt + it) * 2 + wg) *
                           (kDqBytes / 4));
        if (wtid == 0 && rank > 0) {
          const int* ctr = p.counters + ((long long)bh * n_qt + it) * 2 + wg;
          while (ld_acquire(ctr) != rank) {
          }
        }
        named_bar_sync(2 + wg, 128);         // the sum before it is complete
#pragma unroll
        for (int f = 0; f < kBlockQ / 4; ++f) {
          float2 v = make_float2(dq[2 * f], dq[2 * f + 1]);
          if (rank > 0) {
            const float2 prev = __ldcg(blk + f * 128 + wtid);
            v.x += prev.x;
            v.y += prev.y;
          }
          // f = 2 n + i: row 16 warp + lane/4 + 8 i, column 8 n + 2 (lane % 4)
          const int q = it * kBlockQ + warp * 16 + (lane >> 2) + (f & 1) * 8;
          const int col = wg * 64 + (f >> 1) * 8 + (lane & 3) * 2;
          if (q < S) {
            *reinterpret_cast<uint32_t*>(p.dq.head(b, h) + q * p.dq.ss +
                                         col) =
                pack_bf16(v.x * p.scale, v.y * p.scale);
          }
        }
      }
    }

    // dK and dV rows of this warpgroup's keys; keys at or past S are not
    // written
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + wg * 64 + warp * 16 + (lane >> 2) + i * 8;
      if (key >= S) continue;
      __nv_bfloat16* dvrow = p.dv.head(b, h) + key * p.dv.ss;
      __nv_bfloat16* dkrow = p.dk.head(b, h) + key * p.dk.ss;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(dvrow + col) =
            pack_bf16(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dkrow + col) =
            pack_bf16(dk_acc[4 * n + 2 * i] * p.scale,
                      dk_acc[4 * n + 2 * i + 1] * p.scale);
      }
    }
  }
}

Tensor4 tensor4(void* ptr, const long long* strides) {
  Tensor4 t;
  t.ptr = static_cast<__nv_bfloat16*>(ptr);
  t.sb = strides[0];
  t.ss = strides[1];
  t.sh = strides[2];
  return t;
}

}  // namespace

// Bytes of the fp32 workspace that arcflow_attention_bwd takes as `work`.
extern "C" long long arcflow_attention_bwd_workspace_bytes(int B, int S,
                                                           int H) {
  return Workspace(B, S, H).bytes();
}

// Plain C entry point, bound with ctypes. `strides` holds the (batch,
// sequence, head) strides, in elements, of q, k, v, o, dout, dq, dk and dv,
// in that order (24 values). `work` is the workspace (uninitialised, of
// arcflow_attention_bwd_workspace_bytes). Builds the TMA maps, launches the
// preprocess and main kernels on `stream` and returns 0, the first CUDA
// error code that is not 0, or hopper::kTmaRefused + ... for a map the
// driver refused (q, k, v, o, dout numbered 0-4); the caller checks shapes,
// dtypes, strides and alignment before calling.
extern "C" int arcflow_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_valid, void* work,
    void* dq, void* dk, void* dv, int B, int S, int H,
    const long long* strides, long long m_sb, void* stream) {
  Params p;
  p.q = tensor4(const_cast<void*>(q), strides);
  p.k = tensor4(const_cast<void*>(k), strides + 3);
  p.v = tensor4(const_cast<void*>(v), strides + 6);
  p.o = tensor4(const_cast<void*>(o), strides + 9);
  p.dout = tensor4(const_cast<void*>(dout), strides + 12);
  p.dq = tensor4(dq, strides + 15);
  p.dk = tensor4(dk, strides + 18);
  p.dv = tensor4(dv, strides + 21);
  const Workspace ws(B, S, H);
  float* base = static_cast<float*>(work);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = base + ws.lse2();
  p.delta = base + ws.delta();
  p.counters = reinterpret_cast<int*>(base + ws.counters());
  p.dq_acc = base + ws.dq_acc();
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.m_sb = m_sb;
  p.B = B;
  p.S = S;
  p.H = H;
  p.n_qt = (int)ws.n_qt;
  p.s_pad = (int)ws.s_pad;
  p.scale = 1.f / sqrtf((float)kD);
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's map encoder needs (make_bshd_map)
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  // staggered starts only where the card holds all n_kt CTAs of a (batch,
  // head) at once (module note)
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_bwd_kernel, kThreads, kSmemBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int n_kt = (S + kBlockK - 1) / kBlockK;
  p.stagger = n_kt <= sms * per_sm;
  CUtensorMap map_q, map_k, map_v, map_do;
  int err = make_bshd_map(&map_q, q, B, S, H, p.q.sb, p.q.ss, p.q.sh,
                          kBlockQ, 0);
  if (err == 0) err = make_bshd_map(&map_k, k, B, S, H, p.k.sb, p.k.ss,
                                    p.k.sh, kBlockK, 1);
  if (err == 0) err = make_bshd_map(&map_v, v, B, S, H, p.v.sb, p.v.ss,
                                    p.v.sh, kBlockK, 2);
  if (err == 0) err = make_bshd_map(&map_do, dout, B, S, H, p.dout.sb,
                                    p.dout.ss, p.dout.sh, kBlockQ, 4);
  if (err != 0) return err;

  const long long rows = ws.bh * ws.s_pad;
  const int pre_blocks = (int)((rows * 32 + kPreThreads - 1) / kPreThreads);
  attention_bwd_preprocess_kernel<<<pre_blocks, kPreThreads, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_kt, B * H);
  attention_bwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      map_q, map_k, map_v, map_do, p);
  return (int)cudaGetLastError();
}
