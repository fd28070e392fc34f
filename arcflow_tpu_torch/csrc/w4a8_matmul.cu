// w4a8 grouped matmul for Hopper (sm_90a): int8 activations x int4 weights.
//
// Replaces the TPU kernel of the JAX package
//   arcflow_tpu/ops/quant_matmul.py:w4a8_matmul_pallas (_w4a8_kernel):
//   out[m, n] = sum_g scale[g, n] * sum_{k in g} xq[m, k] * w4[k, n]
// with xq (M, K) int8, w4 nibble-packed (K/2, N) int8 in the group-local
// half-split layout (utils/quantize.py:pack_int4: packed row j of group g
// holds input row g*group + j in its low nibble and g*group + group/2 + j in
// its high nibble), scale (G, N) fp32 and out (M, N) fp32. The per-token
// activation scale is applied by the caller.
//
// What bounds it on the card: at the Qwen-Image serving shapes (M = 4096
// image tokens, K and N of 3072 or 12288) one call does 2*M*K*N = 103-309
// GOP on 12-75 MB, thousands of operations per byte: tensor-core bound. At
// M = 1 (the AdaLN modulations) it reads K*N/2 bytes of weights for 2*K*N
// operations and is bound by the weight read.
//
// Design (a simple, correct first version):
//   * one block of 8 warps per 128 x 128 output tile; warps are laid out
//     2 (M) x 4 (N), each owning 64 x 32 outputs;
//   * K advances in tiles of 128 through two shared-memory stages: the
//     activation tile is copied with cp.async; the packed weight tile (64
//     packed rows x 128 columns) is read into registers during the previous
//     tile's products, then unpacked and transposed into shared memory as
//     [n][k] bytes, because mma.sync's B operand wants K contiguous per
//     column while the packing keeps N contiguous (ldmatrix.trans moves only
//     16-bit elements, so the transpose happens in the unpack);
//   * mma.sync m16n8k32 s8 x s8 -> s32 with operands loaded by ldmatrix;
//     the int32 accumulator covers one scale group (a partial sum below
//     2^24, exact) and is scaled into an fp32 accumulator in registers at
//     each group's end, so K tiles may span several groups of 32 or 64;
//   * any M and N % 8 == 0: ragged rows and columns are zero-filled on load
//     and not stored.
// What it leaves on the table: wgmma (Hopper's warpgroup MMA, about twice
// mma.sync's int8 rate), TMA loads with mbarriers, a deeper pipeline, and a
// smaller tile for M = 1; those are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 128;                 // K per shared-memory stage
constexpr int kThreads = 256;            // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMTiles = kWarpM / 16;     // m16 tiles per warp
constexpr int kNTiles = kWarpN / 8;      // n8 tiles per warp
constexpr int kLd = kBK + 16;            // smem row stride in bytes: +16, so
                                         // ldmatrix rows hit distinct banks
constexpr int kTileA = kBM * kLd;        // [m][k] activation bytes
constexpr int kTileB = kBN * kLd;        // [n][k] weight bytes, unpacked
constexpr int kStage = kTileA + kTileB;
constexpr int kSmemBytes = 2 * kStage;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* s;
  float* out;
  int M, N, K, group;
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

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, col-major)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The low / high nibble of each byte of w, sign-extended to a byte:
// (n ^ 8) - 8 maps 0..7 to 0..7 and 8..15 to -8..-1, byte by byte.
__device__ __forceinline__ uint32_t sext_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t sext_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// 4 x 4 byte transpose: in[r] holds byte c of row r at byte c; out[c]
// holds byte r of column c at byte r.
__device__ __forceinline__ void transpose4(const uint32_t* in, uint32_t* out) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// Activation tile: rows [m0, m0 + 128) x bytes [k0, k0 + 128) into sA.
__device__ __forceinline__ void load_a(uint8_t* sA, const Params& p, int m0,
                                       int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBK / 16);
    const int col = (c % (kBK / 16)) * 16;
    const bool ok = m0 + r < p.M && k0 + col < p.K;
    const int8_t* g =
        ok ? p.x + (long long)(m0 + r) * p.K + k0 + col : p.x;
    cp_async_16(sA + r * kLd + col, g, ok);
  }
}

// Packed weight tile for K [k0, k0 + 128): packed rows k0/2 + [0, 64), this
// thread's 4 consecutive rows x 8 consecutive columns, into registers.
__device__ __forceinline__ void load_b(uint2* r, const Params& p, int n0,
                                       int k0, int tid) {
  const int rq = tid & 15;
  const int n = n0 + (tid >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int prow = (k0 >> 1) + rq * 4 + i;
    r[i] = (n < p.N && prow < (p.K >> 1))
               ? __ldg(reinterpret_cast<const uint2*>(
                     p.w + (long long)prow * p.N + n))
               : make_uint2(0u, 0u);
  }
}

// Unpack the registers of load_b and store them transposed: packed row j
// of the tile's group gl gives K offsets gl*group + j (low nibble) and
// gl*group + group/2 + j (high nibble); 4 consecutive rows stay inside one
// group (group/2 is a multiple of 16), so each column gets two 4-byte words.
__device__ __forceinline__ void store_b(uint8_t* sB, const uint2* r,
                                        int group, int tid) {
  const int ph = group >> 1;
  const int j0 = (tid & 15) * 4;
  const int klo = (j0 / ph) * group + j0 % ph;
  const int khi = klo + ph;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t lo[4], hi[4], lo_t[4], hi_t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = h ? r[i].y : r[i].x;
      lo[i] = sext_lo(w);
      hi[i] = sext_hi(w);
    }
    transpose4(lo, lo_t);
    transpose4(hi, hi_t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint8_t* col = sB + ((tid >> 4) * 8 + h * 4 + c) * kLd;
      *reinterpret_cast<uint32_t*>(col + klo) = lo_t[c];
      *reinterpret_cast<uint32_t*>(col + khi) = hi_t[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    w4a8_matmul_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;              // 0..1
  const int warp_n = warp & 3;               // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_tiles = (p.K + kBK - 1) / kBK;

  int iacc[kMTiles][kNTiles][4];             // this scale group, exact
  float facc[kMTiles][kNTiles][4];           // scaled, over groups
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNTiles; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[mi][nj][e] = 0;
        facc[mi][nj][e] = 0.f;
      }

  uint2 breg[4];
  load_a(smem, p, m0, 0, tid);
  cp_async_commit();
  load_b(breg, p, n0, 0, tid);
  store_b(smem + kTileA, breg, p.group, tid);

  for (int t = 0; t < n_tiles; ++t) {
    const uint8_t* sA = smem + (t & 1) * kStage;
    const uint8_t* sB = sA + kTileA;
    uint8_t* next = smem + ((t + 1) & 1) * kStage;
    const bool more = t + 1 < n_tiles;
    if (more) {
      load_a(next, p, m0, (t + 1) * kBK, tid);
      cp_async_commit();
      load_b(breg, p, n0, (t + 1) * kBK, tid);   // in flight during the mma
      cp_async_wait<1>();                        // tile t's activations
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      const int kg = t * kBK + s * 32;           // K of this k32 step
      if (kg >= p.K) break;                      // uniform over the block
      uint32_t af[kMTiles][4];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        // matrices: rows 0-7 / 8-15 x bytes 0-15, then x bytes 16-31
        const int row = warp_m * kWarpM + mi * 16 + (lane & 7) +
                        ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[mi], sA + row * kLd + s * 32 + (lane >> 4) * 16);
      }
      uint32_t bf[kNTiles][2];
#pragma unroll
      for (int pp = 0; pp < kNTiles / 2; ++pp) {
        // matrices: columns 0-7 x bytes 0-15, 0-7 x 16-31, 8-15 x 0-15,
        // 8-15 x 16-31 -> (b0, b1) of n tiles 2pp and 2pp + 1
        const int n = warp_n * kWarpN + pp * 16 + (lane & 7) +
                      (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, sB + n * kLd + s * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * pp][0] = r[0];
        bf[2 * pp][1] = r[1];
        bf[2 * pp + 1][0] = r[2];
        bf[2 * pp + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNTiles; ++nj)
          mma_s8(iacc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);

      if ((kg + 32) % p.group == 0) {            // end of a scale group
        const float* srow = p.s + (long long)(kg / p.group) * p.N;
#pragma unroll
        for (int nj = 0; nj < kNTiles; ++nj) {
          const int col = n0 + warp_n * kWarpN + nj * 8 + (lane & 3) * 2;
          const float2 sc =
              col < p.N ? __ldg(reinterpret_cast<const float2*>(srow + col))
                        : make_float2(0.f, 0.f);
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi) {
            facc[mi][nj][0] += (float)iacc[mi][nj][0] * sc.x;
            facc[mi][nj][1] += (float)iacc[mi][nj][1] * sc.y;
            facc[mi][nj][2] += (float)iacc[mi][nj][2] * sc.x;
            facc[mi][nj][3] += (float)iacc[mi][nj][3] * sc.y;
#pragma unroll
            for (int e = 0; e < 4; ++e) iacc[mi][nj][e] = 0;
          }
        }
      }
    }

    if (more) store_b(next + kTileA, breg, p.group, tid);
    __syncthreads();
  }

  // epilogue: rows lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1}
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const int row = m0 + warp_m * kWarpM + mi * 16 + (lane >> 2);
#pragma unroll
    for (int nj = 0; nj < kNTiles; ++nj) {
      const int col = n0 + warp_n * kWarpN + nj * 8 + (lane & 3) * 2;
      if (col >= p.N) continue;
      if (row < p.M)
        *reinterpret_cast<float2*>(p.out + (long long)row * p.N + col) =
            make_float2(facc[mi][nj][0], facc[mi][nj][1]);
      if (row + 8 < p.M)
        *reinterpret_cast<float2*>(p.out + (long long)(row + 8) * p.N + col) =
            make_float2(facc[mi][nj][2], facc[mi][nj][3]);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks that the tensors are
// contiguous and 16-byte aligned, group in {32, 64, 128}, K % group == 0,
// N % 8 == 0 and ceil(M / 128) <= 65535 before calling.
extern "C" int arcflow_w4a8_matmul(const void* xq, const void* packed,
                                   const void* scale, void* out, int M, int N,
                                   int K, int group, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(xq);
  p.w = static_cast<const int8_t*>(packed);
  p.s = static_cast<const float*>(scale);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  cudaError_t err = cudaFuncSetAttribute(
      w4a8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w4a8_matmul_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
