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
// 295 bf16 operations per byte, so it is bound by tensor-core throughput.
// This design runs seven such products (the dQ pass recomputes S and dP, so
// that no pass needs atomics) and mma.sync, not wgmma.
//
// Design (a simple, correct first version), three launches on one stream:
//   * preprocess: delta_i = sum_d dO[i, d] * O[i, d] in fp32, one warp per
//     (batch, head, row);
//   * dK/dV: one block of 4 warps per (batch * head, 64-key tile); each warp
//     owns 16 keys and keeps their dK and dV (16 x 128 fp32 each) in
//     registers while the block streams 32-query tiles of Q and dO (two
//     shared-memory buffers, cp.async). Per tile: S^T = K Q^T and
//     dP^T = V dO^T, P^T = exp(S^T - LSE), dS^T = P^T (dP^T - delta), then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T re-packed in registers
//     as bf16 A operands;
//   * dQ: one block of 4 warps per (batch * head, 64-query tile); each warp
//     owns 16 queries and keeps their dQ in registers while the block streams
//     64-key tiles of K and V. Per tile: S and dP, dS, dQ += dS K.
//   All products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
//   operands loaded by ldmatrix (.trans where the tile is the B operand along
//   its rows). Two passes and no atomics: each output element is written by
//   one thread once, so the result is deterministic.
// What it leaves on the table: wgmma, TMA, warp specialisation and keeping
// both dQ and dK/dV in one pass (with dQ in fp32 atomics) are later work.
//
// Masks: a key at or past S, or with kv_valid false, gets P = 0, so it adds
// nothing to dQ and its dK and dV rows are 0. A query row whose LSE is -inf
// (no valid key) has P = 0 on every key: its dQ is 0 and it adds nothing to
// dK or dV. Query rows past S are zero-filled with LSE +inf for the same end.
//
// Layouts: q, k, v, o, dO, dq, dk and dv are (B, S, H, D) with D contiguous,
// read and written through their strides; lse and delta are (B, H, S) fp32,
// contiguous; kv_valid is (B, S) bytes, nonzero for a valid key, or null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                      // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;      // keys of a dK/dV block, queries
                                             // of a dQ block
constexpr int kTileQ = 32;                   // queries per streamed dK/dV tile
constexpr int kTileK = 64;                   // keys per streamed dQ tile
constexpr int kLds = kD + 8;                 // smem row stride: +16 bytes, so
                                             // ldmatrix rows hit distinct banks
constexpr int kPreThreads = 256;             // preprocess: 8 rows per block
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemDkdv =
    (2 * kBlockRows * kLds + 4 * kTileQ * kLds) * (int)sizeof(__nv_bfloat16) +
    4 * kTileQ * (int)sizeof(float);
constexpr int kSmemDq =
    (2 * kBlockRows * kLds + 4 * kTileK * kLds) * (int)sizeof(__nv_bfloat16);

struct Tensor4 {                             // (B, S, H, D), D contiguous
  __nv_bfloat16* ptr;
  long long sb, ss, sh;
  __device__ __forceinline__ __nv_bfloat16* head(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

struct Params {
  Tensor4 q, k, v, o, dout, dq, dk, dv;
  const float* lse;
  float* delta;
  const uint8_t* kv_valid;
  long long m_sb;
  int B, S, H;
  float scale;                               // 1 / sqrt(D)
  float scale_log2;                          // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with ok == false it writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of one (batch, head) slice into a smem tile;
// rows at or past S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int S, int tid) {
  constexpr int kChunksPerRow = kD / 8;      // 16-byte chunks
#pragma unroll
  for (int i = 0; i < ROWS * kChunksPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g = ok ? base + (row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * kLds + col, g, ok);
  }
}

// A query row's LSE in base 2, with +inf for a row that has no valid key or
// lies past S, so that exp2(s - lse) is 0 there and never NaN.
__device__ __forceinline__ float lse_log2(const float* lse, int row, int S) {
  const float l = row < S ? lse[row] : -INFINITY;
  return l == -INFINITY ? INFINITY : l * kLog2e;
}

// A fragments (16 x 16 bf16) of a 16 x (2 * N8) fp32 accumulator
template <int N16>
__device__ __forceinline__ void pack_a(uint32_t (*f)[4], float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < N16; ++kk) {
    f[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    f[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    f[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Write this thread's two rows of a warp's 16 x 128 fp32 accumulator, times
// `mul`, as bf16 rows of `out` (row0 is the warp's first row); rows at or
// past S are not written.
__device__ __forceinline__ void store_rows(float (*acc)[4],
                                           __nv_bfloat16* base,
                                           long long row_stride, int row0,
                                           int S, int lane, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + (lane >> 2) + i * 8;
    if (row >= S) continue;
    __nv_bfloat16* out = base + row * row_stride;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + col) =
          pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

__global__ void __launch_bounds__(kPreThreads)
    attention_bwd_preprocess_kernel(const Params p) {
  const long long row = ((long long)blockIdx.x * kPreThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.S) return;
  const int s = (int)(row % p.S);
  const int h = (int)((row / p.S) % p.H);
  const int b = (int)(row / ((long long)p.S * p.H));
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
  if (lane == 0) p.delta[row] = acc;        // (B, H, S): row = (b*H + h)*S + s
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kBlockRows * kLds;
  __nv_bfloat16* sQ = sV + kBlockRows * kLds;     // [2][kTileQ][kLds]
  __nv_bfloat16* sdO = sQ + 2 * kTileQ * kLds;    // [2][kTileQ][kLds]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTileQ * kLds);  // [2][kTileQ]
  float* sDelta = sLse + 2 * kTileQ;                                // [2][kTileQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kBlockRows;
  const int S = p.S;

  const __nv_bfloat16* qb = p.q.head(b, h);
  const __nv_bfloat16* kb = p.k.head(b, h);
  const __nv_bfloat16* vb = p.v.head(b, h);
  const __nv_bfloat16* dob = p.dout.head(b, h);
  const float* lse = p.lse + ((long long)b * p.H + h) * S;
  const float* delta = p.delta + ((long long)b * p.H + h) * S;
  const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

  // cp.async groups, in commit order: {K, V, Q0, dO0}, then {Q(j+1), dO(j+1)}
  // at the top of iteration j
  load_rows<kBlockRows>(sK, kb, p.k.ss, k0, S, tid);
  load_rows<kBlockRows>(sV, vb, p.v.ss, k0, S, tid);
  load_rows<kTileQ>(sQ, qb, p.q.ss, 0, S, tid);
  load_rows<kTileQ>(sdO, dob, p.dout.ss, 0, S, tid);
  cp_async_commit();
  if (tid < kTileQ) {
    sLse[tid] = lse_log2(lse, tid, S);
    sDelta[tid] = tid < S ? delta[tid] : 0.f;
  }

  // this thread's two keys: rows lane/4 and lane/4 + 8 of the warp's 16
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + (lane >> 2) + i * 8;
    key_ok[i] = key < S && (mb == nullptr || mb[key] != 0);
  }

  float dv_acc[kD / 8][4];                   // 16 keys x 128 fp32
  float dk_acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.f;

  const int n_tiles = (S + kTileQ - 1) / kTileQ;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {                   // prefetch the next query tile
      const int r0 = (j + 1) * kTileQ;
      load_rows<kTileQ>(sQ + (buf ^ 1) * kTileQ * kLds, qb, p.q.ss, r0, S, tid);
      load_rows<kTileQ>(sdO + (buf ^ 1) * kTileQ * kLds, dob, p.dout.ss, r0,
                        S, tid);
      cp_async_commit();
      if (tid < kTileQ) {
        sLse[(buf ^ 1) * kTileQ + tid] = lse_log2(lse, r0 + tid, S);
        sDelta[(buf ^ 1) * kTileQ + tid] = r0 + tid < S ? delta[r0 + tid] : 0.f;
      }
      cp_async_wait<1>();                    // tile j (and K, V) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + buf * kTileQ * kLds;
    const __nv_bfloat16* cdO = sdO + buf * kTileQ * kLds;
    const float* cL = sLse + buf * kTileQ;
    const float* cD = sDelta + buf * kTileQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kTileQ queries
    float st[kTileQ / 8][4];
    float dpt[kTileQ / 8][4];
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t kf[4], vf[4];
      const int m = lane >> 3;
      const int row = warp * 16 + (m & 1) * 8 + (lane & 7);
      const int col = kk * 16 + (m >> 1) * 8;
      ldmatrix_x4(kf, sK + row * kLds + col);
      ldmatrix_x4(vf, sV + row * kLds + col);
#pragma unroll
      for (int pp = 0; pp < kTileQ / 16; ++pp) {
        // matrices: queries 0-7 x d 0-7, queries 0-7 x d 8-15, queries 8-15
        // x d 0-7, queries 8-15 x d 8-15 -> (b0, b1) of query tiles 2pp and
        // 2pp + 1
        const int qr = pp * 16 + (lane >> 4) * 8 + (lane & 7);
        const int qc = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, cQ + qr * kLds + qc);
        mma_bf16(st[2 * pp], kf, r[0], r[1]);
        mma_bf16(st[2 * pp + 1], kf, r[2], r[3]);
        ldmatrix_x4(r, cdO + qr * kLds + qc);
        mma_bf16(dpt[2 * pp], vf, r[0], r[1]);
        mma_bf16(dpt[2 * pp + 1], vf, r[2], r[3]);
      }
    }

    // P^T = exp(S^T / sqrt(D) - LSE) and dS^T = P^T (dP^T - delta), in place
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane & 3) * 2 + (e & 1);
        const float pv =
            key_ok[e >> 1] ? exp2f(st[n][e] * p.scale_log2 - cL[col]) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - cD[col]);
      }
    }
    uint32_t pf[kTileQ / 16][4];
    uint32_t dsf[kTileQ / 16][4];
    pack_a<kTileQ / 16>(pf, st);
    pack_a<kTileQ / 16>(dsf, dpt);

    // dV += P^T dO and dK += dS^T Q; B operands are the [query][d] tiles
#pragma unroll
    for (int kk = 0; kk < kTileQ / 16; ++kk) {
#pragma unroll
      for (int qq = 0; qq < kD / 16; ++qq) {
        // transposed matrices: queries 0-7 x d 0-7, queries 8-15 x d 0-7,
        // queries 0-7 x d 8-15, queries 8-15 x d 8-15 -> (b0, b1) of d
        // tiles 2qq and 2qq + 1
        const int qr = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int dc = qq * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, cdO + qr * kLds + dc);
        mma_bf16(dv_acc[2 * qq], pf[kk], r[0], r[1]);
        mma_bf16(dv_acc[2 * qq + 1], pf[kk], r[2], r[3]);
        ldmatrix_x4_trans(r, cQ + qr * kLds + dc);
        mma_bf16(dk_acc[2 * qq], dsf[kk], r[0], r[1]);
        mma_bf16(dk_acc[2 * qq + 1], dsf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with `buf`
  }

  const int row0 = k0 + warp * 16;
  store_rows(dv_acc, p.dv.head(b, h), p.dv.ss, row0, S, lane, 1.f);
  store_rows(dk_acc, p.dk.head(b, h), p.dk.ss, row0, S, lane, p.scale);
}

__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kBlockRows * kLds;
  __nv_bfloat16* sK = sdO + kBlockRows * kLds;    // [2][kTileK][kLds]
  __nv_bfloat16* sV = sK + 2 * kTileK * kLds;     // [2][kTileK][kLds]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int S = p.S;

  const __nv_bfloat16* qb = p.q.head(b, h);
  const __nv_bfloat16* kb = p.k.head(b, h);
  const __nv_bfloat16* vb = p.v.head(b, h);
  const __nv_bfloat16* dob = p.dout.head(b, h);
  const float* lse = p.lse + ((long long)b * p.H + h) * S;
  const float* delta = p.delta + ((long long)b * p.H + h) * S;
  const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;

  // cp.async groups: {Q, dO, K0, V0}, then {K(j+1), V(j+1)} in iteration j
  load_rows<kBlockRows>(sQ, qb, p.q.ss, q0, S, tid);
  load_rows<kBlockRows>(sdO, dob, p.dout.ss, q0, S, tid);
  load_rows<kTileK>(sK, kb, p.k.ss, 0, S, tid);
  load_rows<kTileK>(sV, vb, p.v.ss, 0, S, tid);
  cp_async_commit();

  // this thread's two query rows: lane/4 and lane/4 + 8 of the warp's 16
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    row_lse[i] = lse_log2(lse, row, S);
    row_delta[i] = row < S ? delta[row] : 0.f;
  }

  float dq_acc[kD / 8][4];                   // 16 queries x 128 fp32
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  const int n_tiles = (S + kTileK - 1) / kTileK;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int k0 = j * kTileK;
    if (j + 1 < n_tiles) {                   // prefetch the next key tile
      load_rows<kTileK>(sK + (buf ^ 1) * kTileK * kLds, kb, p.k.ss,
                        k0 + kTileK, S, tid);
      load_rows<kTileK>(sV + (buf ^ 1) * kTileK * kLds, vb, p.v.ss,
                        k0 + kTileK, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + buf * kTileK * kLds;
    const __nv_bfloat16* cV = sV + buf * kTileK * kLds;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x kTileK keys
    float s[kTileK / 8][4];
    float dp[kTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qf[4], df[4];
      const int m = lane >> 3;
      const int row = warp * 16 + (m & 1) * 8 + (lane & 7);
      const int col = kk * 16 + (m >> 1) * 8;
      ldmatrix_x4(qf, sQ + row * kLds + col);
      ldmatrix_x4(df, sdO + row * kLds + col);
#pragma unroll
      for (int pp = 0; pp < kTileK / 16; ++pp) {
        const int key = pp * 16 + (lane >> 4) * 8 + (lane & 7);
        const int kc = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, cK + key * kLds + kc);
        mma_bf16(s[2 * pp], qf, r[0], r[1]);
        mma_bf16(s[2 * pp + 1], qf, r[2], r[3]);
        ldmatrix_x4(r, cV + key * kLds + kc);
        mma_bf16(dp[2 * pp], df, r[0], r[1]);
        mma_bf16(dp[2 * pp + 1], df, r[2], r[3]);
      }
    }

    // dS = P (dP - delta), P = exp(S / sqrt(D) - LSE), in place of S
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const bool ok = key < S && (mb == nullptr || mb[key] != 0);
        const float pv =
            ok ? exp2f(s[n][e] * p.scale_log2 - row_lse[e >> 1]) : 0.f;
        s[n][e] = pv * (dp[n][e] - row_delta[e >> 1]);
      }
    }
    uint32_t dsf[kTileK / 16][4];
    pack_a<kTileK / 16>(dsf, s);

    // dQ += dS K; B operand is the [key][d] tile, transposed loads
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
      for (int qq = 0; qq < kD / 16; ++qq) {
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int dc = qq * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, cK + key * kLds + dc);
        mma_bf16(dq_acc[2 * qq], dsf[kk], r[0], r[1]);
        mma_bf16(dq_acc[2 * qq + 1], dsf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with `buf`
  }

  store_rows(dq_acc, p.dq.head(b, h), p.dq.ss, q0 + warp * 16, S, lane,
             p.scale);
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

// Plain C entry point, bound with ctypes. `strides` holds the (batch,
// sequence, head) strides, in elements, of q, k, v, o, dout, dq, dk and dv,
// in that order (24 values). `delta` is (B, H, S) fp32 scratch. Launches the
// preprocess, dK/dV and dQ kernels on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 on success); the caller checks shapes,
// dtypes, strides and alignment before calling.
extern "C" int arcflow_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_valid, void* delta,
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
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.m_sb = m_sb;
  p.B = B;
  p.S = S;
  p.H = H;
  p.scale = 1.f / sqrtf((float)kD);
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemDkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemDq);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * H * S;
  const int pre_blocks = (int)((rows * 32 + kPreThreads - 1) / kPreThreads);
  attention_bwd_preprocess_kernel<<<pre_blocks, kPreThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, B * H);
  attention_bwd_dkdv_kernel<<<grid, kThreads, kSmemDkdv, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<<<grid, kThreads, kSmemDq, st>>>(p);
  return (int)cudaGetLastError();
}
