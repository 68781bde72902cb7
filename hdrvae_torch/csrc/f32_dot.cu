// A float32 matrix product y[M, N] = x[M, K] @ w[K, N] in three precisions,
// the probe that prices float32 contractions against bf16 tensor-core
// passes on the H100.
//
// Replaces the TPU kernel K12 of the JAX package:
//   tools/perf/pallas_f32_dot_probe.py::pallas_dot (M = 8192, K = N = 256,
//   BM = 512 rows a grid step, DEFAULT and HIGHEST; Mosaic refused HIGH)
// Modes:
//  * highest (0): exact float32 on the CUDA cores, one fmaf a product in
//    k order (no TF32: it keeps 10 mantissa bits).  64 x 64 output tiles,
//    x and w in 16-deep shared-memory slices, 4 x 4 outputs a thread.
//  * high (1): the bf16x3 split of hdrvae/kernels/attention.py::_dot3,
//    each operand v = hi + lo (hi = bf16(v), lo = bf16(v - hi)), hi.hi +
//    hi.lo + lo.hi on mma.sync m16n8k16 into one float32 accumulator (lo.lo
//    is below float32 rounding and skipped, as XLA's HIGH does).
//  * default (2): what the TPU's DEFAULT float32 dot does: each operand
//    rounded to bf16 once, one mma.sync pass, float32 accumulation.
// The tensor-core modes convert 64 x 32 / 32 x 64 float32 slices to bf16
// (hi, lo) in shared memory and feed ldmatrix; four warps a 64 x 64 tile.
//
// What bounds it on the H100 at the probe's shape: 16.8 MB of operands and
// output (5.0 us at 3.35 TB/s) against 1.07 GFLOP a pass: FFMA is bound by
// its operations (16.0 us at 67 TFLOP/s), the bf16 passes by bytes.

#include "window_attention.cuh"

namespace {

using winattn::bf16;

constexpr int TB = 64;   // output tile: TB x TB

// ---------------------------------------------------------------------------
// highest: FFMA
// ---------------------------------------------------------------------------

constexpr int FK = 16;   // K slice
constexpr int FT = 256;  // threads: 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(FT)
dot_ffma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int N, int K) {
  __shared__ __align__(16) float xs[FK][TB + 4];   // x slice, transposed
  __shared__ __align__(16) float wsl[FK][TB];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TB, n0 = blockIdx.x * TB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    {
      const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m0 + r) * K + k0 + c);
      xs[c][r] = v.x;
      xs[c + 1][r] = v.y;
      xs[c + 2][r] = v.z;
      xs[c + 3][r] = v.w;
    }
    {
      const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
      *reinterpret_cast<float4*>(&wsl[r][c]) =
          *reinterpret_cast<const float4*>(
              w + static_cast<size_t>(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&wsl[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(
        y + static_cast<size_t>(m0 + ty * 4 + i) * N + n0 + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// high and default: bf16 passes on mma.sync
// ---------------------------------------------------------------------------

constexpr int TK = 32;          // K slice
constexpr int LDA = TK + 8;     // row strides in bf16 (conflict-free
constexpr int LDW = TB + 8;     // ldmatrix rows)
constexpr int TT = 128;         // threads: four warps, 32 x 32 each

// hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

template <bool SPLIT>
__global__ void __launch_bounds__(TT)
dot_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int N, int K) {
  __shared__ __align__(16) bf16 xh[TB][LDA], xl[SPLIT ? TB : 1][LDA];
  __shared__ __align__(16) bf16 wh[TK][LDW], wl[SPLIT ? TK : 1][LDW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TB, n0 = blockIdx.x * TB;
  float acc[2][4][4] = {};   // [m16 tile][n8 tile][mma C fragment]
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = threadIdx.x; e < TB * TK / 4; e += TT) {
      const int r = e / (TK / 4), c = (e % (TK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m0 + r) * K + k0 + c);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16 hi, lo;
        split(vv[q], hi, lo);
        xh[r][c + q] = hi;
        if constexpr (SPLIT) xl[r][c + q] = lo;
      }
    }
    for (int e = threadIdx.x; e < TK * TB / 4; e += TT) {
      const int r = e / (TB / 4), c = (e % (TB / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          w + static_cast<size_t>(k0 + r) * N + n0 + c);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16 hi, lo;
        split(vv[q], hi, lo);
        wh[r][c + q] = hi;
        if constexpr (SPLIT) wl[r][c + q] = lo;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TK; ks += 16) {
      // A fragments of the warp's two m16 tiles, B fragments of its four
      // n8 tiles (two per ldmatrix.x4.trans)
      unsigned ah[2][4], al[2][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + (lane & 15), c = ks + (lane >> 4) * 8;
        winattn::ldsm_x4(ah[i], &xh[r][c]);
        if constexpr (SPLIT) winattn::ldsm_x4(al[i], &xl[r][c]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ks + (lane & 15), c = wn + j * 16 + (lane >> 4) * 8;
        winattn::ldsm_x4_trans(bh[j], &wh[r][c]);
        if constexpr (SPLIT) winattn::ldsm_x4_trans(bl[j], &wl[r][c]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned* b_hi = bh[t / 2] + (t % 2) * 2;
          winattn::mma_bf16_16816(acc[i][t], ah[i], b_hi);
          if constexpr (SPLIT) {
            winattn::mma_bf16_16816(acc[i][t], ah[i], bl[t / 2] + (t % 2) * 2);
            winattn::mma_bf16_16816(acc[i][t], al[i], b_hi);
          }
        }
    }
    __syncthreads();
  }
  // mma's C layout: lane l holds rows l / 4 and l / 4 + 8, columns
  // 2 (l % 4) + {0, 1} of each n8 tile
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = m0 + wm + i * 16 + (lane >> 2);
      const int c = n0 + wn + t * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(y + static_cast<size_t>(r) * N + c) =
          make_float2(acc[i][t][0], acc[i][t][1]);
      *reinterpret_cast<float2*>(y + static_cast<size_t>(r + 8) * N + c) =
          make_float2(acc[i][t][2], acc[i][t][3]);
    }
}

}  // namespace

extern "C" {

// x [M, K], w [K, N], y [M, N] float32, row major and 16-byte aligned; M
// and N multiples of 64, K of 32.  mode: 0 highest, 1 high, 2 default.
// cudaErrorInvalidValue for shapes or modes it does not take.
int hdrvae_f32_dot(const void* x, const void* w, void* y, int M, int N,
                   int K, int mode, void* stream) {
  if (M < TB || N < TB || K < TK || M % TB || N % TB || K % TK || mode < 0 ||
      mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / TB, M / TB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (mode == 0)
    dot_ffma_kernel<<<grid, FT, 0, s>>>(xp, wp, yp, N, K);
  else if (mode == 1)
    dot_bf16_kernel<true><<<grid, TT, 0, s>>>(xp, wp, yp, N, K);
  else
    dot_bf16_kernel<false><<<grid, TT, 0, s>>>(xp, wp, yp, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
