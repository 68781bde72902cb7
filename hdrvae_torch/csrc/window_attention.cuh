// Building blocks of the three kernels of the staged Swin chain (K9-K11,
// swin_chain.cu; the Swin block kernel K7, swin_block.cu, takes its exact
// GELU, cp.async copies and atom layout from here): cp.async copies of
// bf16 rows into shared memory, a 64-row block GEMM whose B operand (a
// weight matrix in global memory, read by every window from L2) streams
// through a two-buffer cp.async ring (ldmatrix + mma.sync m16n8k16), the
// LayerNorm rows and exact GELU of the block's MLP half, and the [64 x 32]
// bf16 atoms with the 64-byte swizzle that K7's and K9's wgmma products
// read (their descriptor, layout and the store of an accumulator fragment).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace winattn {

typedef __nv_bfloat16 bf16;

constexpr int NT = 512;        // threads per block: 16 warps, four a scheduler
constexpr int NWARPS = NT / 32;
constexpr int RB = 64;         // rows per row block: four 16-row tiles
constexpr int HDP = 32;        // padded head dim
constexpr int ATOM = 64 * HDP * 2;   // a [64 x 32] bf16 atom: 4 KB

// 16-byte global -> shared copy (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows x cols bf16 (cols a multiple of 8) from src (row
// stride lds) to dst (row stride ldd); the caller commits and waits.
__device__ __forceinline__ void copy_rows_async(bf16* dst, int ldd,
                                                const bf16* src, int lds,
                                                int rows, int cols) {
  const int per_row = cols / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += NT) {
    const int r = e / per_row, c = (e % per_row) * 8;
    cp_async16(dst + r * ldd + c, src + static_cast<size_t>(r) * lds + c);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 16, columns 8 * (l / 16) of a 16x16 tile): the A fragment of
// mma.m16n8k16, or with .trans the B fragments of two n8 tiles of a
// row-major [k][n] tile.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float* d, const unsigned* a,
                                               const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The weight GEMM's ring: pieces of KP rows x NC columns of B, row stride
// LDB (8 columns of pad: conflict-free ldmatrix rows), two buffers.  The
// pieces are deep because each one costs a block-wide wait and barrier
// (measured on the H100: 64-row pieces ran the same GEMMs at ~80 TFLOP/s,
// 96-row ones at ~100).
constexpr int KP = 96, NC = 128, LDB = NC + 8, NSTAGE = 2;
constexpr int RING_ELEMS = NSTAGE * KP * LDB;

// C[nrt*16, N] = A[nrt*16, K] @ B[K, N] for one row block of nrt (<= 4)
// row tiles: A row major in shared memory (lda a multiple of 8), B a
// row-major bf16 matrix in global memory (ldb a multiple of 8; K a
// multiple of 16, N of WC) that streams through `ring` (RING_ELEMS of
// shared memory) one KP x NC piece at a time, the next piece loading by
// cp.async while this one multiplies.  NC / WC warps share the columns of
// a piece, the other NWARPS * WC / NC the four row tiles: warp w owns the
// WC columns w % (NC / WC) of each NC-wide chunk over two row tiles;
// ldmatrix + mma.sync m16n8k16, each B fragment serving every row tile of
// the warp.  Each finished 16x16 tile goes through the warp's float32
// stage (256 floats) to epi(row within the row block, first column, v[8]),
// eight consecutive values a lane.  Every thread of the block must call
// it; it synchronizes the block.
template <typename Epi>
__device__ __forceinline__ void gemm_weights(const bf16* A, int lda, int nrt,
                                             const bf16* __restrict__ B,
                                             int ldb, int K, int N,
                                             bf16* ring, float* stage,
                                             Epi epi) {
  constexpr int WC = 16;                           // columns of one warp
  constexpr int CW = NC / WC;                      // warps across a chunk
  constexpr int RT_PER_WARP = 4 / (NWARPS / CW);   // row tiles of one warp
  constexpr int NT8 = WC / 8;                      // n8 tiles of one warp
  static_assert(NWARPS % CW == 0 && RT_PER_WARP >= 1, "warp grid");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % CW, rt0 = (warp / CW) * RT_PER_WARP;
  const int npk = (K + KP - 1) / KP;
  const int total = npk * ((N + NC - 1) / NC);
  auto load = [&](int i) {   // piece i, or an empty group past the end
    if (i < total) {
      const int c0 = (i / npk) * NC, k0 = (i % npk) * KP;
      copy_rows_async(ring + (i % NSTAGE) * KP * LDB, LDB,
                      B + static_cast<size_t>(k0) * ldb + c0, ldb,
                      min(KP, K - k0), min(NC, N - c0));
    }
    cp_async_commit();
  };
  const int nr = min(RT_PER_WARP, nrt - rt0);   // this warp's row tiles
  float acc[RT_PER_WARP][NT8][4];               // [row tile][n8 tile]
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) load(i);
  for (int i = 0; i < total; ++i) {
    load(i + NSTAGE - 1);
    cp_async_wait<NSTAGE - 1>();   // piece i has landed
    __syncthreads();
    const int p = i % npk, k0 = p * KP;
    const int ct = (i / npk) * CW + wc;   // the warp's WC-wide column group
    if (p == 0) {
#pragma unroll
      for (int r = 0; r < RT_PER_WARP; ++r)
#pragma unroll
        for (int e = 0; e < NT8 * 4; ++e) acc[r][e / 4][e % 4] = 0.0f;
    }
    if (ct * WC < N && nr > 0) {
      const bf16* bp = ring + (i % NSTAGE) * KP * LDB + wc * WC +
                       (lane & 15) * LDB + (lane >> 4) * 8;
      const bf16* ap = A + static_cast<size_t>(rt0 * 16 + (lane & 15)) * lda +
                       k0 + (lane >> 4) * 8;
      const int ksteps = min(KP, K - k0) / 16;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned bf[NT8 / 2][4];
#pragma unroll
        for (int j = 0; j < NT8 / 2; ++j)
          ldsm_x4_trans(bf[j], bp + ks * 16 * LDB + j * 16);
#pragma unroll
        for (int r = 0; r < RT_PER_WARP; ++r) {
          if (r >= nr) continue;
          unsigned af[4];
          ldsm_x4(af, ap + static_cast<size_t>(r) * 16 * lda + ks * 16);
#pragma unroll
          for (int j = 0; j < NT8 / 2; ++j) {
            mma_bf16_16816(acc[r][2 * j], af, bf[j]);
            mma_bf16_16816(acc[r][2 * j + 1], af, bf[j] + 2);
          }
        }
      }
      if (p == npk - 1) {
#pragma unroll
        for (int r = 0; r < RT_PER_WARP; ++r) {
          if (r >= nr) continue;
          const int row = lane >> 2, col = (lane & 3) * 2;
#pragma unroll
          for (int hh = 0; hh < NT8 / 2; ++hh) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              float* s = stage + row * 16 + nt * 8 + col;
              s[0] = acc[r][2 * hh + nt][0];
              s[1] = acc[r][2 * hh + nt][1];
              s[128] = acc[r][2 * hh + nt][2];     // row + 8
              s[129] = acc[r][2 * hh + nt][3];
            }
            __syncwarp();
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = stage[lane * 8 + e];
            epi((rt0 + r) * 16 + (lane >> 1),
                ct * WC + hh * 16 + (lane & 1) * 8, v);
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();   // the next load overwrites this buffer
  }
}

// Eight float32 values as eight bf16 in one 16-byte store (dst 16-byte
// aligned).
__device__ __forceinline__ void store_bf16x8(bf16* dst, const float* v) {
  __align__(16) bf16 t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(t);
}

constexpr int MAXC = 8;   // channels a lane holds: C <= 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The mean and 1 / sqrt(var + 1e-5) (two-pass variance) of a row of C
// values that a warp holds MAXC a lane (lane + 32 i; zero past C).
__device__ __forceinline__ void row_stats(const float (&v)[MAXC], int C,
                                          float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) s += v[i];
  mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const float d = v[i] - mean;
    if (lane + 32 * i < C) q += d * d;
  }
  rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
}

// LayerNorm (eps 1e-5) of nrows token rows into bf16 rows of `out`
// (stride ldo), or with NORM false the rows as they are (v2's attention
// input).  row(tok) points at the C values of a token of the window (bf16
// in global or float32 in shared memory); a lane keeps its MAXC of them in
// registers.  Rows of tokens >= n and columns >= C are zero.
template <bool NORM, typename Row>
__device__ __forceinline__ void layer_norm_rows(
    Row row, int tok0, int nrows, int n, int C, int CP, const float* g,
    const float* be, bf16* out, int ldo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += NWARPS) {
    const int tok = tok0 + r;
    bf16* o = out + static_cast<size_t>(r) * ldo;
    if (tok >= n) {
      for (int c = lane; c < CP; c += 32) o[c] = __float2bfloat16(0.0f);
      continue;
    }
    const auto* src = row(tok);
    float v[MAXC];
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f32(src[c]) : 0.0f;
    }
    float mean = 0.0f, rstd = 1.0f;
    if constexpr (NORM) row_stats(v, C, mean, rstd);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      const float t = NORM ? (v[i] - mean) * rstd * g[c] + be[c] : v[i];
      if (c < CP) o[c] = __float2bfloat16(c < C ? t : 0.0f);
    }
  }
}

// Exact (erf) GELU of x in float32.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// The wgmma descriptor of [64 x 32] bf16 atoms with the 64-byte swizzle
// (64-byte rows, 8-row groups 512 B apart): K-major A / B tiles and
// MN-major B tiles one atom wide (the leading offset is then unused).
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return hopper::make_desc(addr, 16, 512, hopper::LAYOUT_B64);
}

// Byte offset of element (r, c) of a K-major region of [64 x 32] atoms
// (64-byte rows, the 64-byte swizzle: 16-byte chunk bits 4-5 XOR address
// bits 7-8); atoms at 4 KB strides along c.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const uint32_t e = r * 32 + (c & 31);
  return (c >> 5) * ATOM + 2 * (e ^ (((e >> 6) & 3) << 3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64n32 accumulator fragment (f[4 j + 2 i + e]: row 16 w + g + 8 i,
// column 8 j + 2 t + e of warp w, lane 4 g + t) rounded to bf16 into a
// [64 x 32] atom with the 64-byte swizzle.
__device__ __forceinline__ void frag_to_atom(unsigned char* atom,
                                             const float* f, int wl, int g,
                                             int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(atom + swz(16 * wl + g + 8 * i,
                                              8 * j + 2 * t)) =
          pack_bf16(f[4 * j + 2 * i], f[4 * j + 2 * i + 1]);
}

}  // namespace winattn
