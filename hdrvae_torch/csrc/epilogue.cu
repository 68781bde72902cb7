// The HDR epilogue's pass over the pre-conv_out map: the MAX-pool channel
// collapse and the map's global statistics in ONE streamed read.
//
// Replaces the TPU kernel K4 of the JAX package:
//   hdrvae/kernels/epilogue.py::collapse_and_stats_pallas
//   pre [M, C] -> collapsed [M, 3] (max over channels [0:42), [42:84),
//   [84:126) for C = 128, else over thirds of C) and min, max, mean and
//   std (ddof = 1) of all M * C values.
//
// What bounds it on the H100: one read of the map (M * C * 4 or 2 bytes)
// and a 3/C write, a handful of flops per byte: memory bandwidth.  The
// design reads each row once, coalesced, and keeps every partial in
// registers, so the map crosses the bus once instead of the five times
// the plain reductions take (min, max, mean, the squared deviations, the
// collapse).
//
// Design:
//  * Kernel 1: a block of 8 warps takes ROWS rows; a warp reads one row at
//    a time, lane l taking channels l, l + 32, ...  Each lane keeps a
//    Welford (n, mean, M2) and a min / max over what it read, and the
//    per-group maxes of the row, which three warp max-reductions finish.
//    The lanes' and warps' partials merge by Chan's parallel combine in a
//    fixed order, and the block writes one (n, mean, M2, min, max) row.
//    Blocks run in no order and nothing is carried between them: there is
//    no float atomic, so the result is deterministic.
//  * Kernel 2 (one block): merges the per-block rows in a fixed order in
//    double precision and writes min, max, mean, std.  Counts are doubles:
//    M * C reaches 2^31 at 4096^2 x 128, past int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 256;       // rows of [M, C] per block of kernel 1
constexpr int NTHREADS = 256;   // 8 warps
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);   // exact: v is one of the row's bf16 values
}

template <typename F>
struct Moments {
  F n, mean, m2;
  float mn, mx;
};

// Chan et al.'s combine of (n, mean, M2) pairs, plus min / max.
template <typename F>
__device__ __forceinline__ void merge(Moments<F>& a, const Moments<F>& b) {
  const F n = a.n + b.n;
  if (b.n > 0) {
    const F d = b.mean - a.mean;
    const F f = b.n / n;
    a.mean = a.mean + d * f;
    a.m2 = a.m2 + b.m2 + d * d * a.n * f;
    a.n = n;
  }
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) collapse_stats_kernel(
    const T* __restrict__ pre, T* __restrict__ collapsed,
    float* __restrict__ partial, long long M, int C, int b1, int b2,
    int b3) {
  __shared__ Moments<float> red[NWARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Moments<float> m = {0.0f, 0.0f, 0.0f, INFINITY, -INFINITY};
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  for (int r = warp; r < ROWS; r += NWARPS) {
    const long long row = row0 + r;
    if (row >= M) break;
    const T* __restrict__ p = pre + row * C;
    float g0 = -INFINITY, g1 = -INFINITY, g2 = -INFINITY;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(p[c]);
      m.n += 1.0f;
      const float d = v - m.mean;
      m.mean += d / m.n;
      m.m2 += d * (v - m.mean);
      m.mn = fminf(m.mn, v);
      m.mx = fmaxf(m.mx, v);
      if (c < b1)
        g0 = fmaxf(g0, v);
      else if (c < b2)
        g1 = fmaxf(g1, v);
      else if (c < b3)
        g2 = fmaxf(g2, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g0 = fmaxf(g0, __shfl_xor_sync(0xffffffffu, g0, off));
      g1 = fmaxf(g1, __shfl_xor_sync(0xffffffffu, g1, off));
      g2 = fmaxf(g2, __shfl_xor_sync(0xffffffffu, g2, off));
    }
    if (lane < 3) store(collapsed + row * 3 + lane,
                        lane == 0 ? g0 : (lane == 1 ? g1 : g2));
  }
  // lanes -> lane 0 (butterfly, a fixed order), warps -> thread 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments<float> o;
    o.n = __shfl_xor_sync(0xffffffffu, m.n, off);
    o.mean = __shfl_xor_sync(0xffffffffu, m.mean, off);
    o.m2 = __shfl_xor_sync(0xffffffffu, m.m2, off);
    o.mn = __shfl_xor_sync(0xffffffffu, m.mn, off);
    o.mx = __shfl_xor_sync(0xffffffffu, m.mx, off);
    merge(m, o);
  }
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    Moments<float> t = red[0];
    for (int w = 1; w < NWARPS; ++w) merge(t, red[w]);
    float* out = partial + static_cast<size_t>(blockIdx.x) * 5;
    out[0] = t.n;      // <= ROWS * C, exact in float32
    out[1] = t.mean;
    out[2] = t.m2;
    out[3] = t.mn;
    out[4] = t.mx;
  }
}

// partial [nblocks, 5] -> stats [min, max, mean, std (ddof = 1)]
__global__ void __launch_bounds__(NTHREADS) stats_finalize_kernel(
    const float* __restrict__ partial, int nblocks,
    float* __restrict__ stats) {
  __shared__ Moments<double> red[NTHREADS];
  Moments<double> m = {0.0, 0.0, 0.0, INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < nblocks; i += NTHREADS) {
    const float* p = partial + static_cast<size_t>(i) * 5;
    const Moments<double> o = {p[0], p[1], p[2], p[3], p[4]};
    merge(m, o);
  }
  red[threadIdx.x] = m;
  __syncthreads();
  for (int stride = NTHREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) merge(red[threadIdx.x], red[threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const Moments<double> t = red[0];
    stats[0] = t.mn;
    stats[1] = t.mx;
    stats[2] = static_cast<float>(t.mean);
    stats[3] = static_cast<float>(sqrt(t.m2 / fmax(t.n - 1.0, 1.0)));
  }
}

template <typename T>
int launch(const void* pre, void* collapsed, void* partial, void* stats,
           long long M, int C, int b1, int b2, int b3, cudaStream_t s) {
  const long long nblocks = (M + ROWS - 1) / ROWS;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  collapse_stats_kernel<T><<<static_cast<unsigned>(nblocks), NTHREADS, 0, s>>>(
      static_cast<const T*>(pre), static_cast<T*>(collapsed),
      static_cast<float*>(partial), M, C, b1, b2, b3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finalize_kernel<<<1, NTHREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<int>(nblocks),
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pre [M, C] f32 (is_bf16 = 0) or bf16; collapsed [M, 3] of pre's type;
// partial [ceil(M / 256), 5] f32 scratch; stats [4] f32 = min, max, mean,
// std.  (b1, b2, b3) are the group ends: channels [0, b1), [b1, b2),
// [b2, b3) collapse to R, G, B.
int hdrvae_collapse_and_stats(const void* pre, void* collapsed,
                              void* partial, void* stats, long long M, int C,
                              int b1, int b2, int b3, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(pre, collapsed, partial, stats, M, C, b1, b2, b3, s);
  return launch<float>(pre, collapsed, partial, stats, M, C, b1, b2, b3, s);
}

}  // extern "C"
