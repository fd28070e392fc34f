// Forward flash attention with an int8 QK^T for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/flash_int8.py:flash_attention_int8 (_flash_int8_kernel):
// q and k arrive quantized per (batch, token, head) row to symmetric int8
// with fp32 scales s_q, s_k (the quantization runs before the kernel, as the
// JAX package runs it before its Pallas call); the score of query i and key
// j is the int8 dot product rescaled exactly,
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
//
// Design (a simple, correct first version; attention_fwd.cu's structure):
//   * one block of 4 warps per (batch * head, 64-query tile); each warp owns
//     16 query rows, whose int8 Q fragments stay in registers;
//   * int8 K tiles (64 keys x 128 bytes, half a bf16 tile) and bf16 V tiles
//     are copied to shared memory with cp.async, the next K tile in flight
//     during the softmax and P.V, the next V tile during the next QK^T;
//   * QK^T with mma.sync m16n8k32 s8 x s8 -> s32, operands by ldmatrix (the
//     b16 form, two int8 per element, as in w4a8_matmul.cu); the int32 tile
//     is rescaled in fp32 by the row's scale (with 1/sqrt(D) and log2(e)
//     folded in) and by the k scale of each accumulator's own column: the
//     C fragment holds columns 2 (lane % 4) + {0, 1} of each 8-key tile,
//     not the key lane / 4 whose bytes the B fragment brought;
//   * online softmax per row in base 2; P re-packed in registers as the A
//     operand of P.V (mma.sync m16n8k16 bf16, V by ldmatrix.trans).
// What it leaves on the table: wgmma, TMA, warp specialisation and a fused
// quantization (the int8 rows make a pass over q and k before the kernel);
// those are later work.
//
// Layouts: q and k int8 and v and o (bf16 or fp32) are (B, S, H, D) with D
// contiguous, read and written through their strides; the scales are
// (B, H, S) fp32, contiguous; kv_valid is (B, S) bytes, nonzero for a valid
// key, or null.

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
constexpr int kLdI8 = kD + 16;               // int8 smem row stride (bytes):
                                             // +16, so ldmatrix rows hit
                                             // distinct banks
constexpr int kLdV = kD + 8;                 // bf16 smem row stride (elements)
constexpr float kMaskedScore = -1e30f;       // the JAX kernel's fill

struct Params {
  const int8_t* q;
  const int8_t* k;
  const __nv_bfloat16* v;
  const float* qs;
  const float* ks;
  const uint8_t* kv_valid;
  void* o;
  int B, S, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale_log2;                          // log2(e) * sm_scale
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

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, col-major)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Copy rows [row0, row0 + 64) of one (batch, head) int8 slice into a smem
// tile; rows at or past S are zero-filled.
__device__ __forceinline__ void load_tile_i8(int8_t* tile, const int8_t* base,
                                             long long row_stride, int row0,
                                             int S, int tid) {
  constexpr int kChunksPerRow = kD / 16;     // 16-byte chunks
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 16;
    const bool ok = row0 + r < S;
    const int8_t* g = ok ? base + (row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * kLdI8 + col, g, ok);
  }
}

// The same for a bf16 V tile; a zero row keeps 0 * garbage out of P.V.
__device__ __forceinline__ void load_tile_v(__nv_bfloat16* tile,
                                            const __nv_bfloat16* base,
                                            long long row_stride, int row0,
                                            int S, int tid) {
  constexpr int kChunksPerRow = kD / 8;
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* g = ok ? base + (row0 + r) * row_stride + col : base;
    cp_async_16(tile + r * kLdV + col, g, ok);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_int8_kernel(const Params p) {
  __shared__ __align__(16) int8_t sQ[kBlockM * kLdI8];
  __shared__ __align__(16) int8_t sK[kBlockN * kLdI8];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kLdV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int S = p.S;

  const int8_t* qb = p.q + b * p.q_sb + h * p.q_sh;
  const int8_t* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;
  const long long scale_row = ((long long)b * p.H + h) * S;
  const float* ksb = p.ks + scale_row;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  // cp.async groups, in commit order: {Q, K0}, {V0}, then per tile j
  // {K(j+1)} after Q.K^T and {V(j+1)} after P.V.
  load_tile_i8(sQ, qb, p.q_ss, q0, S, tid);
  load_tile_i8(sK, kb, p.k_ss, 0, S, tid);
  cp_async_commit();
  load_tile_v(sV, vb, p.v_ss, 0, S, tid);
  cp_async_commit();

  // this thread's two rows: lane/4 and lane/4 + 8 of the warp's 16, their
  // q scales with 1/sqrt(D) and log2(e) folded in
  float q_scale[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    q_scale[i] = row < S ? p.qs[scale_row + row] * p.scale_log2 : 0.f;
  }
  uint32_t qf[kD / 32][4];                   // A fragments of this warp's Q
  float o_acc[kD / 8][4];                    // 16 x 128 fp32 output
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_row[2] = {kMaskedScore, kMaskedScore};   // running max (base 2)
  float l_row[2] = {0.f, 0.f};               // this thread's partial sums

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    cp_async_wait<1>();                      // K(j) (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        // matrices: rows 0-7 / 8-15 x bytes 0-15, then x bytes 16-31
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qf[kk], sQ + row * kLdI8 + kk * 32 + (lane >> 4) * 16);
      }
    }

    // S = Q K^T in int32 for this warp's 16 rows x 64 keys
    int sc[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0;
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int pp = 0; pp < kBlockN / 16; ++pp) {
        // matrices: keys 0-7 x bytes 0-15, 0-7 x 16-31, 8-15 x 0-15,
        // 8-15 x 16-31 -> (b0, b1) of key tiles 2pp and 2pp + 1
        const int key = pp * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk * 32 + ((lane >> 3) & 1) * 16;
        uint32_t r[4];
        ldmatrix_x4(r, sK + key * kLdI8 + col);
        mma_s8(sc[2 * pp], qf[kk], r[0], r[1]);
        mma_s8(sc[2 * pp + 1], qf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with K(j)
    if (j + 1 < n_tiles) {
      load_tile_i8(sK, kb, p.k_ss, k0 + kBlockN, S, tid);
      cp_async_commit();
    }

    // rescale (row scale, then the scale of the accumulator's own key
    // column), mask, online softmax
    float s[kBlockN / 8][4];
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float val;
        if (key >= S) {
          val = -INFINITY;                   // not a key at all
        } else if (mb && mb[key] == 0) {
          val = kMaskedScore;
        } else {
          val = (float)sc[n][e] * q_scale[e >> 1] * __ldg(ksb + key);
        }
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
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
        o_acc[n][2 * i] *= alpha;
        o_acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_row[e >> 1]);
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
        ldmatrix_x4_trans(r, sV + key * kLdV + col);
        mma_bf16(o_acc[2 * qq], pf[kk], r[0], r[1]);
        mma_bf16(o_acc[2 * qq + 1], pf[kk], r[2], r[3]);
      }
    }
    __syncthreads();                         // every warp is done with V(j)
    if (j + 1 < n_tiles) {
      load_tile_v(sV, vb, p.v_ss, k0 + kBlockN, S, tid);
      cp_async_commit();
    }
  }

  // epilogue: O = acc / max(l, 1e-30), as the JAX kernel divides
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l_row[i], 1e-30f);
    OutT* orow = static_cast<OutT*>(p.o) + b * p.o_sb + row * p.o_ss +
                 h * p.o_sh;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      store2(orow + col, o_acc[n][2 * i] * inv, o_acc[n][2 * i + 1] * inv);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks shapes, dtypes,
// strides and alignment before calling. O is fp32 when out_f32 is nonzero,
// else bf16.
extern "C" int arcflow_flash_int8(
    const void* q, const void* k, const void* v, const void* q_scale,
    const void* k_scale, const void* kv_valid, void* o, int B, int S, int H,
    int out_f32, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long m_sb, float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.qs = static_cast<const float*>(q_scale);
  p.ks = static_cast<const float*>(k_scale);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.o = o;
  p.B = B;
  p.S = S;
  p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = scale_log2;
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    flash_int8_kernel<float><<<grid, kThreads, 0, st>>>(p);
  } else {
    flash_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
