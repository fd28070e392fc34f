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
// written back; each query row belongs to exactly one block, so the update in
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
// Design (a simple, correct first version): attention_fwd.cu's structure --
// 4 warps per (batch * head, 64-query tile), each warp owning 16 query rows
// whose Q fragments stay in registers; K and V tiles of 64 keys copied to
// shared memory with cp.async, the next tile in flight during the current
// one's math; mma.sync m16n8k16 bf16 with fp32 accumulators; online softmax
// in base 2 -- with the running (acc, m, l) loaded from device memory on
// entry (acc straight into the output fragments) and stored on exit. wgmma,
// TMA and overlapping the hop with the next rotation are later work.
//
// Layouts: q (B, Sq, H, D), k and v (B, Skv, H, D) and o (B, Sq, H, D) with D
// contiguous, read and written through their strides; kv_valid (B, Skv) bytes
// or null; acc, m and l contiguous in the shapes above.

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994530942f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* kv_valid;
  float* acc;
  float* m;
  float* l;
  __nv_bfloat16* o;
  int B, Sq, Skv, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  float scale_log2;                          // log2(e) / sqrt(D)
  int first, last;
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

__global__ void __launch_bounds__(kThreads) ring_hop_kernel(const Params p) {
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
  const int Sq = p.Sq, Skv = p.Skv;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mb = p.kv_valid ? p.kv_valid + b * p.m_sb : nullptr;
  const int n_tiles = (Skv + kBlockN - 1) / kBlockN;

  // cp.async groups, in commit order: {Q, K0}, {V0}, then per tile j
  // {K(j+1)} after Q.K^T and {V(j+1)} after P.V.
  load_tile(sQ, qb, p.q_ss, q0, Sq, tid);
  load_tile(sK, kb, p.k_ss, 0, Skv, tid);
  cp_async_commit();
  load_tile(sV, vb, p.v_ss, 0, Skv, tid);
  cp_async_commit();

  // The carry in, while the first tiles land. This thread's two rows are
  // lane/4 and lane/4 + 8 of the warp's 16; of each row it holds columns
  // n * 8 + (lane % 4) * 2 + {0, 1} of acc, and the quad's first thread
  // holds l (the others start their partial sums at 0).
  uint32_t qf[kD / 16][4];                   // A fragments of this warp's Q
  float o_acc[kD / 8][4];                    // 16 x 128 fp32 accumulator
  float m_row[2], l_row[2];                  // running max (base 2), sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    const bool read = !p.first && row < Sq;
    const long long st = ((long long)b * p.H + h) * Sq + row;
    m_row[i] = read ? p.m[st] * kLog2e : -INFINITY;
    l_row[i] = read && (lane & 3) == 0 ? p.l[st] : 0.f;
    const float* arow = p.acc + (((long long)b * Sq + row) * p.H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      float2 a = make_float2(0.f, 0.f);
      if (read) {
        a = *reinterpret_cast<const float2*>(arow + n * 8 + (lane & 3) * 2);
      }
      o_acc[n][2 * i] = a.x;
      o_acc[n][2 * i + 1] = a.y;
    }
  }

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
      load_tile(sK, kb, p.k_ss, k0 + kBlockN, Skv, tid);
      cp_async_commit();
    }

    // scale, mask, online softmax
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        bool ok = key < Skv;
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
    // acc += P V
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
      load_tile(sV, vb, p.v_ss, k0 + kBlockN, Skv, tid);
      cp_async_commit();
    }
  }

  // epilogue: the carry out (m in natural log), and O on the last hop
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
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
          make_float2(o_acc[n][2 * i], o_acc[n][2 * i + 1]);
    }
    if (p.last) {
      const float inv = l_row[i] > 0.f ? 1.f / l_row[i] : 0.f;
      __nv_bfloat16* orow = p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o_acc[n][2 * i] * inv, o_acc[n][2 * i + 1] * inv);
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks shapes, dtypes,
// strides and alignment before calling. `o` may be null unless `last`.
extern "C" int arcflow_ring_hop(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* acc, void* m, void* l, void* o, int B, int Sq, int Skv, int H,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long m_sb, int first, int last, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  p.first = first;
  p.last = last;
  cudaError_t err = cudaFuncSetAttribute(
      ring_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  ring_hop_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
