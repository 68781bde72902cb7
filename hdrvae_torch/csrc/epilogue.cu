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
// and a 3/C write, about a dozen operations per element: memory bandwidth
// (0.160 ms for a float32 1024^2 x 128 map at 3.35 TB/s, 0.080 in bf16).
// The design keeps ~100 KB of loads in flight on every SM without holding
// them in registers, and spends no divide, branch or 64-bit operation per
// element:
//
//  * Loads: every lane reads 16-byte vectors (8 or 4 bytes, or 2 for
//    bf16, where a row is no multiple of 16 bytes: a narrower instance of
//    the same kernel).  A row is read by TPR consecutive lanes, vector r of
//    the row by lane r % TPR, so each lane's channels, and with them their
//    collapse groups, are fixed: the membership of each element is a keep
//    mask computed once and applied by one bitwise select per element and
//    group (values outside a group become -inf).  Where a row is 4 to 32
//    vectors of 4 or more bytes (C = 128: 32 float32 or 16 bf16 vectors)
//    TPR is 8 (4 for 4 vectors), so a row's group maxes take three
//    shuffle levels, a lane holding up to four vectors of it, and each
//    warp streams its rows through its own ring of four batches in shared
//    memory by cp.async, three in flight while it works on the fourth,
//    each lane reading back only what it copied, so no barrier is needed.
//    Other rows take TPR = min(32, pow2 >= their vectors) and direct
//    loads, a batch of four vectors a lane at a time.
//  * Statistics with no divide per element: each lane sums d = v - K and
//    d^2 about a shift K, its first value, in float32 over a batch of a
//    few vectors, and adds each batch's sums into double accumulators.
//    Its (n, mean, M2) follows once at the end (mean = K + S1 / n, M2 = S2
//    - S1^2 / n), and lanes, warps and blocks merge by Chan's combine in
//    a fixed order.  The shift keeps it stable where |mean| >> std (the
//    reason the JAX kernel combines (n, mean, M2)): d is then of the
//    order of the spread, and v - K is exact where both are within a
//    factor of two.
//  * Grid: persistent, as many 256-thread blocks as fit on the SMs, each
//    warp walking 32-row chunks; the block writes one (n, mean, M2, min,
//    max) partial in double, so partials number in the hundreds.
//  * Collapse: each row's three group maxes are reduced across its lanes
//    by shuffles, staged per warp in shared memory for the chunk, and
//    stored as 16-byte vectors (the chunk's 96 values are contiguous).
//  * Finalize: a second one-block launch merges the partials in a fixed
//    order in double and writes min, max, mean and std.  It stays a
//    launch of its own: folding it in by a last-block ticket needs a
//    counter that is zero at every launch, and a cached one is shared by
//    launches on concurrent streams while a fresh one costs a fill launch.
// No float atomics anywhere, so the result is deterministic.  Counts are
// doubles in the merges: M * C reaches 2^31 at 4096^2 x 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;   // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int CHUNK = 32;       // rows a warp takes at a time
constexpr int UB = 4;           // a lane's vectors in flight (batch)
constexpr uint32_t NEG_INF = 0xff800000u;

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

// A vector of VB bytes.
template <int VB> struct Vec;
template <> struct Vec<16> { typedef uint4 type; };
template <> struct Vec<8> { typedef uint2 type; };
template <> struct Vec<4> { typedef uint32_t type; };
template <> struct Vec<2> { typedef uint16_t type; };

__device__ __forceinline__ void words(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void words(const uint2& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y;
}
__device__ __forceinline__ void words(uint32_t v, uint32_t* w) { w[0] = v; }
__device__ __forceinline__ void words(uint16_t v, uint32_t* w) { w[0] = v; }

// The E values of a vector as float32 bit patterns.
template <typename T, int VB>
__device__ __forceinline__ void unpack(const typename Vec<VB>::type& v,
                                       uint32_t* x) {
  constexpr int NW = VB >= 4 ? VB / 4 : 1;
  uint32_t w[NW];
  words(v, w);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < NW; ++i) x[i] = w[i];
  } else if constexpr (VB == 2) {
    x[0] = w[0] << 16;
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      x[2 * i] = w[i] << 16;
      x[2 * i + 1] = w[i] & 0xffff0000u;
    }
  }
}

// keep[k][e]: all ones where element e of the vector at channel c0 lies in
// collapse group k ([0, b1), [b1, b2), [b2, b3)), else zero.
template <int E>
__device__ __forceinline__ void group_keep(int c0, int b1, int b2, int b3,
                                           uint32_t (&keep)[3][E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = c0 + e;
    keep[0][e] = c < b1 ? ~0u : 0u;
    keep[1][e] = c >= b1 && c < b2 ? ~0u : 0u;
    keep[2][e] = c >= b2 && c < b3 ? ~0u : 0u;
  }
}

__device__ __forceinline__ float keep_or_neg_inf(uint32_t x, uint32_t keep) {
  return __uint_as_float((x & keep) | (NEG_INF & ~keep));
}

// A vector's keep masks: one a float32 element, or one a bf16 pair (KW =
// VB / 4 words; VB = 2 holds one bf16, kept as a float32).
template <typename T, int VB>
__host__ __device__ constexpr int keep_words() {
  return sizeof(T) == 2 && VB >= 4 ? VB / 4 : VB / static_cast<int>(sizeof(T));
}

template <typename T, int VB>
__device__ __forceinline__ void group_keep_vec(
    int c0, int b1, int b2, int b3,
    uint32_t (&keep)[3][keep_words<T, VB>()]) {
  constexpr int E = VB / static_cast<int>(sizeof(T));
  uint32_t ke[3][E];
  group_keep<E>(c0, b1, b2, b3, ke);
  if constexpr (sizeof(T) == 2 && VB >= 4) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < VB / 4; ++i)
        keep[k][i] = (ke[k][2 * i] & 0xffffu) | (ke[k][2 * i + 1] & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) keep[k][e] = ke[k][e];
  }
}

// bf16 pairs: max / min of two words (exact: maxes of bf16 values), the
// low and high value as float32
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmin2(*reinterpret_cast<__nv_bfloat162*>(&a),
                                   *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16* p, float v) {
  *p = __float2bfloat16(v);   // exact: v is one of the row's bf16 values
}

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(VB));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A lane's running statistics: the shift K (its first value), float32
// sums of d = v - K and d^2 over a batch (two of each: even and odd
// elements, so the chains of dependent adds stay short), flushed into
// double, the count, min and max.
struct LaneStats {
  bool have_k;
  float K, mn, mx, s1[2], s2[2];
  double S1, S2;
  long long n;
};

// The max of x[0 .. N) as a tree (dependent chains of log2 N).
template <int N>
__device__ __forceinline__ float tree_max(const float* x) {
  if constexpr (N == 1) return x[0];
  else return fmaxf(tree_max<N / 2>(x), tree_max<N - N / 2>(x + N / 2));
}
template <int N>
__device__ __forceinline__ float tree_min(const float* x) {
  if constexpr (N == 1) return x[0];
  else return fminf(tree_min<N / 2>(x), tree_min<N - N / 2>(x + N / 2));
}

// One vector's E values (float32 bit patterns) into the lane's statistics
// and the row's three group maxes.
template <int E>
__device__ __forceinline__ void take(LaneStats& st, const uint32_t (&x)[E],
                                     const uint32_t (&keep)[3][E],
                                     float (&g)[3]) {
  if (!st.have_k) {
    st.K = __uint_as_float(x[0]);
    st.have_k = true;
  }
  float v[E], gk[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = __uint_as_float(x[e]);
    const float d = v[e] - st.K;
    st.s1[e & 1] += d;
    st.s2[e & 1] = fmaf(d, d, st.s2[e & 1]);
  }
  st.mn = fminf(st.mn, tree_min<E>(v));
  st.mx = fmaxf(st.mx, tree_max<E>(v));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) gk[e] = keep_or_neg_inf(x[e], keep[k][e]);
    g[k] = fmaxf(g[k], tree_max<E>(gk));
  }
  st.n += E;
}

// One vector of W bf16 pairs: the statistics in float32, min, max and the
// group maxes on the pairs (half the instructions of float32 ones).
template <int W>
__device__ __forceinline__ void take_bf16(LaneStats& st,
                                          const uint32_t (&w)[W],
                                          const uint32_t (&keep)[3][W],
                                          float (&g)[3]) {
  if (!st.have_k) {
    st.K = lo_f(w[0]);
    st.have_k = true;
  }
  uint32_t mn = w[0], mx = w[0];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float d0 = lo_f(w[i]) - st.K, d1 = hi_f(w[i]) - st.K;
    st.s1[0] += d0;
    st.s2[0] = fmaf(d0, d0, st.s2[0]);
    st.s1[1] += d1;
    st.s2[1] = fmaf(d1, d1, st.s2[1]);
    if (i > 0) {
      mn = min2(mn, w[i]);
      mx = max2(mx, w[i]);
    }
  }
  st.mn = fminf(st.mn, fminf(lo_f(mn), hi_f(mn)));
  st.mx = fmaxf(st.mx, fmaxf(lo_f(mx), hi_f(mx)));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t m = (w[0] & keep[k][0]) | (0xff80ff80u & ~keep[k][0]);
#pragma unroll
    for (int i = 1; i < W; ++i)
      m = max2(m, (w[i] & keep[k][i]) | (0xff80ff80u & ~keep[k][i]));
    g[k] = fmaxf(g[k], fmaxf(lo_f(m), hi_f(m)));
  }
  st.n += 2 * W;
}

// One vector into the lane's statistics and the row's group maxes.
template <typename T, int VB>
__device__ __forceinline__ void take_vec(
    LaneStats& st, const typename Vec<VB>::type& v,
    const uint32_t (&keep)[3][keep_words<T, VB>()], float (&g)[3]) {
  constexpr int KW = keep_words<T, VB>();
  if constexpr (sizeof(T) == 2 && VB >= 4) {
    uint32_t w[KW];
    words(v, w);
    take_bf16<KW>(st, w, keep, g);
  } else {
    uint32_t x[KW];
    unpack<T, VB>(v, x);
    take<KW>(st, x, keep, g);
  }
}

__device__ __forceinline__ void flush(LaneStats& st) {
  st.S1 += st.s1[0] + st.s1[1];
  st.S2 += st.s2[0] + st.s2[1];
  st.s1[0] = st.s1[1] = st.s2[0] = st.s2[1] = 0.0f;
}

// A row's group maxes reduced across its tpr lanes (every lane of the warp
// calls it); the row's first lane stages them at sr.
template <typename T>
__device__ __forceinline__ void stage_row(float (&g)[3], int tpr, bool lead,
                                          T* sr) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int o = tpr / 2; o > 0; o >>= 1)
      g[k] = fmaxf(g[k], __shfl_xor_sync(0xffffffffu, g[k], o));
  if (lead)
#pragma unroll
    for (int k = 0; k < 3; ++k) store_value(sr + k, g[k]);
}

// A chunk's staged collapsed rows out, contiguous in the output.
template <typename T>
__device__ __forceinline__ void store_chunk(const T* stage, T* collapsed,
                                            long long row0, long long M,
                                            int lane) {
  __syncwarp();
  const int nrows = static_cast<int>(min(static_cast<long long>(CHUNK),
                                         M - row0));
  T* dst = collapsed + row0 * 3;
  if (nrows == CHUNK) {
    constexpr int NV = CHUNK * 3 * static_cast<int>(sizeof(T)) / 16;
    if (lane < NV)
      reinterpret_cast<uint4*>(dst)[lane] =
          reinterpret_cast<const uint4*>(stage)[lane];
  } else {
    for (int i = lane; i < nrows * 3; i += 32) dst[i] = stage[i];
  }
  __syncwarp();
}

constexpr int NSTAGE = 4;   // a warp's cp.async ring: batches in flight

// NS > 0 (a row of 4 to 32 vectors of at least 4 bytes): tpr = 4 or 8
// lanes a row, lane r % tpr taking vectors r, r + tpr, ... (NS of them,
// past the row masked), so a row's group maxes take three shuffle levels;
// the lane's keep masks stay in registers, and its vectors come through
// the warp's own ring of NSTAGE batches (four vectors a lane each) in
// shared memory by cp.async, each lane reading back only what it copied
// (no barrier).  NS = 0: a lane takes vectors r, r + 32, ... of each row
// by direct loads and computes their masks as it goes.
template <typename T, int VB, int NS>
__global__ void __launch_bounds__(NTHREADS, NS > 0 ? 2 : 1)
collapse_stats_kernel(
    const T* __restrict__ pre, T* __restrict__ collapsed,
    double* __restrict__ partial, long long M, int C, int b1, int b2,
    int b3, int tpr, long long nchunk) {
  typedef typename Vec<VB>::type V;
  constexpr int KW = keep_words<T, VB>();
  __shared__ __align__(16) unsigned char stage_raw[NWARPS][CHUNK * 3 *
                                                         sizeof(T)];
  __shared__ Moments<double> red[NWARPS];
  extern __shared__ __align__(16) unsigned char ring_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vpr = C * static_cast<int>(sizeof(T)) / VB;   // vectors a row
  const int rpw = 32 / tpr;            // rows a warp reads in one step
  const int rl = lane % tpr, rsub = lane / tpr;
  const int steps = CHUNK / rpw;       // a chunk's steps
  const V* __restrict__ src = reinterpret_cast<const V*>(pre);
  T* stage = reinterpret_cast<T*>(stage_raw[warp]);   // this warp's rows
  // this warp's chunks: first, first + stride, ...
  const long long first = static_cast<long long>(blockIdx.x) * NWARPS + warp;
  const long long stride = static_cast<long long>(gridDim.x) * NWARPS;
  const long long nmine = first < nchunk ? (nchunk - 1 - first) / stride + 1
                                         : 0;
  LaneStats st = {false, 0.0f, INFINITY, -INFINITY, {0.0f, 0.0f},
                  {0.0f, 0.0f}, 0.0, 0.0, 0};

  if constexpr (NS > 0) {
    constexpr int UB1 = UB / NS;       // steps a batch: four vectors a lane
    constexpr int E = VB / static_cast<int>(sizeof(T));
    uint32_t keepn[NS][3][KW];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
      group_keep_vec<T, VB>((rl + tpr * sl) * E, b1, b2, b3, keepn[sl]);
    unsigned char* ring = ring_raw + warp * NSTAGE * UB * 32 * VB;
    const int bpc = steps / UB1;       // batches a chunk
    auto live_at = [&](long long row, int sl) {
      return rl + tpr * sl < vpr && row < M;
    };
    // the next batch to issue: chunk ic of this warp's, batch iq of it,
    // into ring slot islot (an empty group past the end)
    long long ic = 0;
    int iq = 0, islot = 0, cslot = 0;
    auto issue = [&]() {
      if (ic < nmine) {
        const long long r0 =
            (first + ic * stride) * CHUNK + iq * UB1 * rpw + rsub;
        unsigned char* dst = ring + islot * UB * 32 * VB + lane * VB;
#pragma unroll
        for (int u = 0; u < UB1; ++u)
#pragma unroll
          for (int sl = 0; sl < NS; ++sl) {
            const long long row = r0 + u * rpw;
            if (live_at(row, sl))
              cp_async<VB>(dst + (u * NS + sl) * 32 * VB,
                           src + row * vpr + rl + tpr * sl);
          }
        if (++iq == bpc) {
          iq = 0;
          ++ic;
        }
      }
      cp_async_commit();
      islot = (islot + 1) % NSTAGE;
    };
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) issue();
    for (long long c = 0; c < nmine; ++c) {
      const long long row0 = (first + c * stride) * CHUNK;
      for (int q = 0; q < bpc; ++q) {
        issue();
        cp_async_wait<NSTAGE - 1>();   // this batch has landed
        const unsigned char* cur = ring + cslot * UB * 32 * VB + lane * VB;
#pragma unroll
        for (int u = 0; u < UB1; ++u) {
          const long long row = row0 + (q * UB1 + u) * rpw + rsub;
          float g[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
          for (int sl = 0; sl < NS; ++sl)
            if (live_at(row, sl))
              take_vec<T, VB>(
                  st,
                  *reinterpret_cast<const V*>(cur + (u * NS + sl) * 32 * VB),
                  keepn[sl], g);
          stage_row(g, tpr, rl == 0,
                    stage + ((q * UB1 + u) * rpw + rsub) * 3);
        }
        flush(st);
        cslot = (cslot + 1) % NSTAGE;
      }
      store_chunk(stage, collapsed, row0, M, lane);
    }
    cp_async_wait<0>();
  } else {
    constexpr int E = VB / static_cast<int>(sizeof(T));
    const int ns = (vpr + tpr - 1) / tpr;   // a lane's vectors a row
    uint32_t keep[3][KW];
    for (long long c = 0; c < nmine; ++c) {
      const long long row0 = (first + c * stride) * CHUNK;
      for (int st0 = 0; st0 < steps; st0 += UB) {
        float g[UB][3];
#pragma unroll
        for (int u = 0; u < UB; ++u)
#pragma unroll
          for (int k = 0; k < 3; ++k) g[u][k] = -INFINITY;
        for (int s = 0; s < ns; ++s) {
          const int vi = rl + tpr * s;       // the vector within the row
          group_keep_vec<T, VB>(vi * E, b1, b2, b3, keep);
          V buf[UB];
          bool live[UB];
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const long long row = row0 + (st0 + u) * rpw + rsub;
            live[u] = st0 + u < steps && row < M && vi < vpr;
            if (live[u]) buf[u] = __ldg(src + row * vpr + vi);
          }
#pragma unroll
          for (int u = 0; u < UB; ++u)
            if (live[u]) take_vec<T, VB>(st, buf[u], keep, g[u]);
          flush(st);
        }
#pragma unroll
        for (int u = 0; u < UB; ++u)
          if (st0 + u < steps)   // uniform over the warp
            stage_row(g[u], tpr, rl == 0,
                      stage + ((st0 + u) * rpw + rsub) * 3);
      }
      store_chunk(stage, collapsed, row0, M, lane);
    }
  }

  // this lane's (n, mean, M2), then lanes -> lane 0 and warps -> thread 0
  Moments<double> m = {0.0, 0.0, 0.0, st.mn, st.mx};
  if (st.n > 0) {
    m.n = static_cast<double>(st.n);
    m.mean = st.K + st.S1 / m.n;
    m.m2 = fmax(st.S2 - st.S1 * st.S1 / m.n, 0.0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments<double> o;
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
    Moments<double> t = red[0];
    for (int w = 1; w < NWARPS; ++w) merge(t, red[w]);
    double* out = partial + static_cast<size_t>(blockIdx.x) * 5;
    out[0] = t.n;
    out[1] = t.mean;
    out[2] = t.m2;
    out[3] = t.mn;
    out[4] = t.mx;
  }
}

// partial [nblocks, 5] -> stats [min, max, mean, std (ddof = 1)]
__global__ void __launch_bounds__(NTHREADS) stats_finalize_kernel(
    const double* __restrict__ partial, int nblocks,
    float* __restrict__ stats) {
  __shared__ Moments<double> red[NTHREADS];
  Moments<double> m = {0.0, 0.0, 0.0, INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < nblocks; i += NTHREADS) {
    const double* p = partial + static_cast<size_t>(i) * 5;
    const Moments<double> o = {p[0], p[1], p[2], static_cast<float>(p[3]),
                               static_cast<float>(p[4])};
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

template <typename T, int VB, int NS>
int launch_vb(const void* pre, void* collapsed, void* partial, void* stats,
              long long M, int C, int b1, int b2, int b3, int tpr,
              int max_blocks, cudaStream_t s) {
  auto kernel = collapse_stats_kernel<T, VB, NS>;
  const int ring = NS > 0 ? NWARPS * NSTAGE * UB * 32 * VB : 0;
  const long long nchunk = (M + CHUNK - 1) / CHUNK;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NTHREADS, ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (nchunk + NWARPS - 1) / NWARPS;
  const int nblocks = static_cast<int>(
      std::max(1LL, std::min<long long>({want,
                                         static_cast<long long>(sms) * per_sm,
                                         max_blocks})));
  kernel<<<nblocks, NTHREADS, ring, s>>>(
      static_cast<const T*>(pre), static_cast<T*>(collapsed),
      static_cast<double*>(partial), M, C, b1, b2, b3, tpr, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finalize_kernel<<<1, NTHREADS, 0, s>>>(
      static_cast<const double*>(partial), nblocks,
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// The cp.async ring where a row is 4 to 32 vectors of at least 4 bytes
// (tpr 4 or 8, NS = 1, 2 or 4 vectors a lane), direct loads otherwise (tpr
// = min(32, pow2 >= vectors a row)).
template <typename T, int VB>
int launch_pipe(const void* pre, void* collapsed, void* partial, void* stats,
                long long M, int C, int b1, int b2, int b3, int max_blocks,
                cudaStream_t s) {
  const int vpr = C * static_cast<int>(sizeof(T)) / VB;
  if constexpr (VB >= 4) {   // cp.async copies 4, 8 or 16 bytes
    const int tpr = vpr <= 4 ? 4 : 8;
    if (vpr >= 4 && vpr <= 8)
      return launch_vb<T, VB, 1>(pre, collapsed, partial, stats, M, C, b1, b2,
                                 b3, tpr, max_blocks, s);
    if (vpr > 8 && vpr <= 16)
      return launch_vb<T, VB, 2>(pre, collapsed, partial, stats, M, C, b1, b2,
                                 b3, tpr, max_blocks, s);
    if (vpr > 16 && vpr <= 32)
      return launch_vb<T, VB, 4>(pre, collapsed, partial, stats, M, C, b1, b2,
                                 b3, tpr, max_blocks, s);
  }
  int tpr = 1;
  while (tpr < vpr && tpr < 32) tpr *= 2;
  return launch_vb<T, VB, 0>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                             tpr, max_blocks, s);
}

// The widest vector (16, 8, 4 or, for bf16, 2 bytes) that divides both a
// row's bytes and the map's address.
template <typename T>
int launch(const void* pre, void* collapsed, void* partial, void* stats,
           long long M, int C, int b1, int b2, int b3, int max_blocks,
           cudaStream_t s) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(pre) |
                          static_cast<uintptr_t>(C * sizeof(T));
  if (align % 16 == 0)
    return launch_pipe<T, 16>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                             max_blocks, s);
  if (align % 8 == 0)
    return launch_pipe<T, 8>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                            max_blocks, s);
  if (sizeof(T) == 4 || align % 4 == 0)
    return launch_pipe<T, 4>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                            max_blocks, s);
  return launch_pipe<T, (sizeof(T) == 2 ? 2 : 4)>(
      pre, collapsed, partial, stats, M, C, b1, b2, b3, max_blocks, s);
}

}  // namespace

extern "C" {

// pre [M, C] f32 (is_bf16 = 0) or bf16, C >= 3; collapsed [M, 3] of pre's
// type (16-byte aligned); partial [max_blocks, 5] float64 scratch; stats
// [4] f32 = min, max, mean, std.  (b1, b2, b3) are the group ends:
// channels [0, b1), [b1, b2), [b2, b3) collapse to R, G, B.
int hdrvae_collapse_and_stats(const void* pre, void* collapsed,
                              void* partial, void* stats, long long M, int C,
                              int b1, int b2, int b3, int is_bf16,
                              int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 3 || max_blocks < 1 ||
      reinterpret_cast<uintptr_t>(collapsed) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<bf16>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                        max_blocks, s);
  return launch<float>(pre, collapsed, partial, stats, M, C, b1, b2, b3,
                       max_blocks, s);
}

}  // extern "C"
