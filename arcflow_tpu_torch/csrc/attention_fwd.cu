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
// not by bytes; K and V tiles are re-read by every query tile, but those
// re-reads are served from the 50 MB L2.
//
// Design (a simple, correct first version):
//   * one block of 4 warps per (batch * head, 64-query tile); each warp owns
//     16 query rows, whose Q fragments stay in registers for the whole loop;
//   * K and V tiles of 64 keys are copied to shared memory with cp.async;
//     the next K tile is in flight while the current tile's softmax and P.V
//     run, and the next V tile while the next Q.K^T runs;
//   * both products use mma.sync m16n8k16 (bf16 in, fp32 accumulate), with
//     operands loaded by ldmatrix; the S accumulator is re-packed in registers
//     as the A operand of P.V (the FlashAttention-2 dataflow);
//   * online softmax per row in fp32, in base 2 with the scale folded in.
// What it leaves on the table: mma.sync reaches only part of Hopper's dense
// bf16 rate. wgmma (warpgroup MMA fed from shared memory), TMA loads with
// mbarriers, warp specialisation (a producer warp and consumer warpgroups),
// a deeper K/V pipeline and 128-row query tiles are what a fast Hopper
// attention uses; they are later work.
//
// A query row with no valid key (every key masked) gets O = 0 and LSE = -inf.
//
// Layouts: q, k, v and o are (B, S, H, D) with D contiguous, read and written
// through their strides (no transposes); kv_valid is (B, S) bytes, nonzero
// for a valid key, or null; lse is (B, H, S) fp32, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                      // head dim
constexpr int kBlockM = 64;                  // query rows per block
constexpr int kBlockN = 64;                  // keys per K/V tile
constexpr int kWarps = kBlockM / 16;         // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;                 // smem row stride: +16 bytes, so
                                             // ldmatrix rows hit distinct banks
constexpr int kTileElems = kBlockM * kLds;   // kBlockM == kBlockN
constexpr int kSmemBytes = 3 * kTileElems * (int)sizeof(__nv_bfloat16);

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* kv_valid;
  __nv_bfloat16* o;
  float* lse;
  int B, S, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
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

// Copy rows [row0, row0 + 64) of one (batch, head) slice into a smem tile;
// rows at or past S are zero-filled (their keys are also masked, and a zero
// V row keeps 0 * garbage out of P.V).
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int S, int tid) {
  constexpr int kChunksPerRow = kD / 8;      // 16-byte chunks
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g = ok ? base + (row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * kLds + col, g, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTileElems;
  __nv_bfloat16* sV = sK + kTileElems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int S = p.S;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  // cp.async groups, in commit order: {Q, K0}, {V0}, then per tile j
  // {K(j+1)} after Q.K^T and {V(j+1)} after P.V.
  load_tile(sQ, qb, p.q_ss, q0, S, tid);
  load_tile(sK, kb, p.k_ss, 0, S, tid);
  cp_async_commit();
  load_tile(sV, vb, p.v_ss, 0, S, tid);
  cp_async_commit();

  uint32_t qf[kD / 16][4];                   // A fragments of this warp's Q
  float o_acc[kD / 8][4];                    // 16 x 128 fp32 output
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16
  float m_row[2] = {-INFINITY, -INFINITY};   // running max (base-2 domain)
  float l_row[2] = {0.f, 0.f};               // this thread's partial sums

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    cp_async_wait<1>();                      // K(j) (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int m = lane >> 3;
        const int row = warp * 16 + (m & 1) * 8 + (lane & 7);
        ldmatrix_x4(qf[kk], sQ + row * kLds + kk * 16 + (m >> 1) * 8);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int pp = 0; pp < kBlockN / 16; ++pp) {
        // matrices: keys 0-7 x d 0-7, keys 0-7 x d 8-15, keys 8-15 x d 0-7,
        // keys 8-15 x d 8-15 -> (b0, b1) of key tiles 2pp and 2pp + 1
        const int key = pp * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, sK + key * kLds + col);
        mma_bf16(s[2 * pp], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * pp + 1], qf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with K(j)
    if (j + 1 < n_tiles) {
      load_tile(sK, kb, p.k_ss, k0 + kBlockN, S, tid);
      cp_async_commit();
    }

    // scale, mask, online softmax
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        bool ok = key < S;
        if (ok && mb) ok = mb[key] != 0;
        s[n][e] = ok ? s[n][e] * p.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
        o_acc[n][2 * i] *= alpha;
        o_acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - ref[e >> 1]);
        l_row[e >> 1] += s[n][e];
      }
    }
    // P as A fragments: key step kk covers S tiles 2kk and 2kk + 1
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    if (j + 1 < n_tiles) {
      cp_async_wait<1>();                    // V(j) has landed, K(j+1) may not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int qq = 0; qq < kD / 16; ++qq) {
        // transposed matrices: keys 0-7 x d 0-7, keys 8-15 x d 0-7,
        // keys 0-7 x d 8-15, keys 8-15 x d 8-15 -> (b0, b1) of d tiles
        // 2qq and 2qq + 1
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = qq * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, sV + key * kLds + col);
        mma_bf16(o_acc[2 * qq], pf[kk], r[0], r[1]);
        mma_bf16(o_acc[2 * qq + 1], pf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with V(j)
    if (j + 1 < n_tiles) {
      load_tile(sV, vb, p.v_ss, k0 + kBlockN, S, tid);
      cp_async_commit();
    }
  }

  // epilogue: normalise, write O (bf16) and LSE (natural log)
  constexpr float kLn2 = 0.69314718055994530942f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    if (row >= S) continue;
    const float inv = l_row[i] > 0.f ? 1.f / l_row[i] : 0.f;
    __nv_bfloat16* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(o_acc[n][2 * i] * inv, o_acc[n][2 * i + 1] * inv);
    }
    if ((lane & 3) == 0) {
      p.lse[((long long)b * p.H + h) * S + row] =
          l_row[i] > 0.f ? m_row[i] * kLn2 + logf(l_row[i]) : -INFINITY;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks shapes, dtypes,
// strides and alignment before calling.
extern "C" int arcflow_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* o, void* lse, int B, int S, int H, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long m_sb, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)kD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* arcflow_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
