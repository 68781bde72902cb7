// A float32 matrix product y[M, N] = x[M, K] @ w[K, N] in three precisions,
// the probe that prices float32 contractions against bf16 tensor-core
// passes on the H100.
//
// Replaces the TPU kernel K12 of the JAX package:
//   tools/perf/pallas_f32_dot_probe.py::pallas_dot (M = 8192, K = N = 256,
//   BM = 512 rows a grid step, DEFAULT and HIGHEST; Mosaic refused HIGH)
// Modes:
//  * highest (0): exact float32 on the CUDA cores, one fmaf a product in
//    k order (no TF32: it keeps 10 mantissa bits).
//  * high (1): the bf16x3 split of hdrvae/kernels/attention.py::_dot3,
//    each operand v = hi + lo (hi = bf16(v), lo = bf16(v - hi)), hi.hi +
//    hi.lo + lo.hi into one float32 accumulator (lo.lo is below float32
//    rounding and skipped, as XLA's HIGH does).
//  * default (2): what the TPU's DEFAULT float32 dot does: each operand
//    rounded to bf16 once, one pass, float32 accumulation.
//
// What bounds it on the H100 at the probe's shape: 16.8 MB of operands and
// output (5.0 us at 3.35 TB/s) against 1.07 GFLOP a pass.  FFMA is bound
// by its operations (16.0 us at 67 TFLOP/s), the bf16 passes by bytes.
//  * highest (ffma::kernel): 128 x 128 output tiles (128 blocks at the
//    probe's shape: one wave on 132 SMs), 256 threads of 8 x 8 outputs
//    each (rows ty + 16 i, columns 4 tx + {0..3} and 64 + 4 tx + {0..3}).
//    x and w come in 32-deep slices by cp.async through a three-stage
//    ring, so the copies of slices k + 1 and k + 2 are in flight while
//    slice k multiplies; one __syncthreads a slice.  x stays row-major (a
//    warp's two rows on distinct banks); a thread reads its 8 rows as
//    16-byte vectors across 4 k and w as two 16-byte vectors a k, each a
//    step ahead of the FFMAs that take it.  At 8 x 8 outputs a thread a
//    k's 16 shared-memory wavefronts a warp take as long as its 64 FFMAs,
//    which sets the pace (PERF.md, section 6).
//  * high / default (tc::kernel): w is split once a launch into bf16
//    parts, transposed ([N, K], K-major: wgmma's B as TMA lays it), by
//    split_w_kernel; the tensor-core kernel is a programmatic dependent
//    launch that starts beside it and waits (griddepcontrol.wait) only
//    before it loads w.  A block owns a 64-row band of x across 256
//    columns of y (N > 256: more blocks along N), so each x element is
//    read from HBM and split once at N <= 256.  One warpgroup: every x
//    chunk ([64 x 32] float32) of a 256-deep k group is requested by TMA
//    at once; w's part tiles ([256 x 32]) come by TMA through as many
//    slots as fit (4 high, 8 default).  The threads split chunk c + 1
//    into the 64-byte-swizzled bf16 atoms wgmma reads from shared memory
//    (A in shared memory: ptxas serialized wgmmas with A from registers)
//    while chunk c's wgmma m64n256k16 run, and chunk c's products are
//    issued before chunk c - 1's are waited for.  y leaves through a
//    shared-memory tile (128-byte swizzle) by TMA stores, which clip past
//    M and N.  Load, products and stores still run one after another in
//    every block (PERF.md, section 6).

#include "hopper.cuh"
#include "window_attention.cuh"

namespace {

using winattn::bf16;

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   winattn::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// ---------------------------------------------------------------------------
// highest: FFMA
// ---------------------------------------------------------------------------

namespace ffma {

constexpr int BM = 128, BN = 128;   // output tile
constexpr int BK = 32;              // k slice
constexpr int XS = BK + 4;   // x row stride in floats (a warp's rows on
                             // distinct banks)
constexpr int NS = 3;        // ring stages
constexpr int TN = 8;        // outputs a thread along N (8 along M)
constexpr int TX = BN / TN, NT = 16 * TX;   // threads: 16 x TX
constexpr int STAGE = BM * XS + BK * BN;   // floats: x, w
constexpr int SMEM = NS * STAGE * 4;       // 102 KB

// Stage kt % NS <- x[m0 .. +BM, k0 .. +BK] and w[k0 .. +BK, n0 .. +BN],
// rows past M and columns past N zero-filled.
__device__ __forceinline__ void load(float* smem, const float* x,
                                     const float* w, int M, int N, int K,
                                     int m0, int n0, int kt) {
  float* xs = smem + (kt % NS) * STAGE;
  float* ws = xs + BM * XS;
  const int k0 = kt * BK;
#pragma unroll
  for (int q = 0; q < BM * BK / 4 / NT; ++q) {
    const int e = threadIdx.x + NT * q;
    const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
    const bool ok = m0 + r < M;
    cp_async16_zfill(xs + r * XS + c,
                     x + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + c,
                     ok ? 16 : 0);
  }
#pragma unroll
  for (int q = 0; q < BK * BN / 4 / NT; ++q) {
    const int e = threadIdx.x + NT * q;
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const bool ok = n0 + c < N;
    cp_async16_zfill(ws + r * BN + c,
                     w + static_cast<size_t>(k0 + r) * N + (ok ? n0 + c : 0),
                     ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NT, 1)
kernel(const float* __restrict__ x, const float* __restrict__ w,
       float* __restrict__ y, int M, int N, int K) {
  constexpr int NV = TN / 4;   // 16-byte vectors of w a k
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;
  float acc[8][TN] = {};
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(smem, x, w, M, N, K, m0, n0, s);
    winattn::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    winattn::cp_async_wait<NS - 2>();
    __syncthreads();   // slice kt landed; slice kt - 1's stage is free
    if (kt + NS - 1 < nk) load(smem, x, w, M, N, K, m0, n0, kt + NS - 1);
    winattn::cp_async_commit();
    // the thread's rows ty + 16 i of x (4 k a vector) and columns
    // BN / NV h + 4 tx + {0..3} of w, each read one step ahead of the
    // FFMAs that take it (registers double-buffered)
    const float* xr = smem + (kt % NS) * STAGE + ty * XS;
    const float* wr = smem + (kt % NS) * STAGE + BM * XS + 4 * tx;
    float4 a[2][8], b[2][NV];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[0][i] = *reinterpret_cast<const float4*>(xr + 16 * i * XS);
#pragma unroll
    for (int h = 0; h < NV; ++h)
      b[0][h] = *reinterpret_cast<const float4*>(wr + BN / NV * h);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int g = (k >> 2) & 1, q = k & 3;
      if (q == 0 && k + 4 < BK) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[g ^ 1][i] = *reinterpret_cast<const float4*>(
              xr + 16 * i * XS + k + 4);
      }
      if (k + 1 < BK) {
#pragma unroll
        for (int h = 0; h < NV; ++h)
          b[(k + 1) & 1][h] = *reinterpret_cast<const float4*>(
              wr + (k + 1) * BN + BN / NV * h);
      }
      float bv[TN];
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const float4 v = b[k & 1][h];
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = q == 0 ? a[g][i].x : q == 1 ? a[g][i].y
                       : q == 2 ? a[g][i].z : a[g][i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      const int c = n0 + BN / NV * h + 4 * tx;
      if (c < N)
        *reinterpret_cast<float4*>(y + static_cast<size_t>(r) * N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

int launch(const float* x, const float* w, float* y, int M, int N, int K,
           cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NT, SMEM, s>>>(x, w, y, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// high and default: w's bf16 parts, then wgmma
// ---------------------------------------------------------------------------

// parts [LO ? 2 : 1, N, K] <- hi = bf16(w^T), lo = bf16(w^T - hi): a 32 x
// 32 tile a block, transposed through shared memory.
template <bool LO>
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, bf16* __restrict__ parts, int K,
               int N) {
  // the tensor-core kernel after it may start now: it waits for these
  // parts itself (griddepcontrol.wait) before it loads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = w[static_cast<size_t>(k0 + i) * N + n0 + tx];
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const float v = tile[tx][i];   // w[k0 + tx][n0 + i]
    const bf16 hi = __float2bfloat16(v);
    const size_t o = static_cast<size_t>(n0 + i) * K + k0 + tx;
    parts[o] = hi;
    if (LO)
      parts[static_cast<size_t>(N) * K + o] =
          __float2bfloat16(v - __bfloat162float(hi));
  }
}

namespace tc {

using winattn::ATOM;

constexpr int BM = 64;        // a band's rows
constexpr int BN = 256;       // the block's columns of y
constexpr int BK = 32;        // k chunk: one [64 x 32] atom of x
constexpr int NCH = 8;        // chunks a k group (x's float32 slots)
constexpr int NA = 3;         // x part buffers: two read by queued products,
                              // one being split
constexpr int NT = 128;       // one warpgroup
constexpr int SMEM_MAX = 232448;
constexpr int XB = BM * BK * 4;   // bytes of a float32 x chunk: 8 KB
constexpr int WB = BN * BK * 2;   // bytes of a w part tile [256 x 32]
constexpr int YB = BM * 32 * 4;   // bytes of a [64 x 32] float32 y box

template <bool SPLIT>
struct Layout {
  static constexpr int NP = SPLIT ? 2 : 1;   // parts of each operand
  static constexpr int WSLOT = NP * WB;
  static constexpr int X = 0;                    // x chunks (then y staging)
  static constexpr int A = X + NCH * XB;         // x's parts
  static constexpr int W = A + NA * NP * ATOM;   // w ring
  // as many w slots as fit, at most a k group's tiles: 4 for high, 8 for
  // default
  static constexpr int NSW = (SMEM_MAX - 2048 - W) / WSLOT < NCH
                                 ? (SMEM_MAX - 2048 - W) / WSLOT : NCH;
  static constexpr int BAR = W + NSW * WSLOT;    // x, then w barriers
  static constexpr int SMEM = BAR + 8 * (NCH + NSW) + 1024;  // + slack
  static_assert(NSW >= 2 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(BN / 32 * YB <= NCH * XB, "y staging fits the x chunks");
};

// Byte offset of element (r, c), c < 32, of a [64 x 32] float32 box with
// the 128-byte swizzle (16-byte chunk bits 4-6 XOR row bits 7-9).
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
}

template <bool SPLIT>
__global__ void __launch_bounds__(NT, 1)
kernel(const __grid_constant__ CUtensorMap xmap,
       const __grid_constant__ CUtensorMap wmap,
       const __grid_constant__ CUtensorMap ymap, int N, int K, int wrows) {
  using L = Layout<SPLIT>;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t xbar = base + L::BAR, wbar = xbar + 8 * NCH;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;   // chunks, and w tiles of the block's walk

  if (tid == 0) {
    for (int b = 0; b < NCH + L::NSW; ++b) hopper::mbar_init(xbar + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // x chunk c -> slot c % NCH; w tile c -> slot c % NSW
  auto load_x = [&](int c) {
    const uint32_t bar = xbar + 8 * (c % NCH);
    hopper::mbar_expect_tx(bar, XB);
    hopper::tma_load_2d(base + L::X + (c % NCH) * XB, &xmap, bar, c * BK, m0);
  };
  auto load_w = [&](int c) {
    const uint32_t bar = wbar + 8 * (c % L::NSW);
    hopper::mbar_expect_tx(bar, L::NP * wrows * BK * 2);
#pragma unroll
    for (int p = 0; p < L::NP; ++p)
      hopper::tma_load_3d(base + L::W + (c % L::NSW) * L::WSLOT + p * WB,
                          &wmap, bar, c * BK, n0, p);
  };
  if (tid == 0) {
    for (int c = 0; c < min(NCH, nk); ++c) load_x(c);
    // w's parts are the split kernel's output: its grid may still run
    // (programmatic dependent launch) while x comes in
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int c = 0; c < min(L::NSW, nk); ++c) load_w(c);
  }

  // x chunk c (landed in its slot) -> bf16 hi [/ lo] atoms in buffer c %
  // NA: four 16-byte vectors a thread, 4 elements of a row each
  auto split = [&](int c) {
    hopper::mbar_wait(xbar + 8 * (c % NCH), (c / NCH) & 1);
    const float4* xs =
        reinterpret_cast<const float4*>(smem + L::X + (c % NCH) * XB);
    unsigned char* ah = smem + L::A + (c % NA) * L::NP * ATOM;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + NT * q;
      const int r = e >> 3, col = (e & 7) * 4;
      const float4 v = xs[e];
      const float vv[4] = {v.x, v.y, v.z, v.w};
      float h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = __bfloat162float(__float2bfloat16(vv[i]));
        l[i] = vv[i] - h[i];
      }
      const uint32_t off = winattn::swz(r, col);
      *reinterpret_cast<uint2*>(ah + off) =
          make_uint2(winattn::pack_bf16(h[0], h[1]),
                     winattn::pack_bf16(h[2], h[3]));
      if constexpr (SPLIT)
        *reinterpret_cast<uint2*>(ah + ATOM + off) =
            make_uint2(winattn::pack_bf16(l[0], l[1]),
                       winattn::pack_bf16(l[2], l[3]));
    }
    hopper::fence_proxy_async();
  };

  // Chunk c's products are issued before chunk c - 1's are waited for, so
  // the tensor cores always hold a group queued; a w slot is refilled
  // (tile + NSW, by thread 0 after a barrier) once its products are done.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  split(0);
  __syncthreads();
  if (tid == 0 && NCH < nk) {   // chunk 0's slot takes chunk NCH
    hopper::fence_proxy_async();
    load_x(NCH);
  }
  for (int c = 0; c < nk; ++c) {
    hopper::mbar_wait(wbar + 8 * (c % L::NSW), (c / L::NSW) & 1);
    const uint32_t a = base + L::A + (c % NA) * L::NP * ATOM;
    const uint32_t b = base + L::W + (c % L::NSW) * L::WSLOT;
    hopper::fence_operands<BN / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t ah = winattn::desc64(a) + 2 * ks;
      const uint64_t bh = winattn::desc64(b) + 2 * ks;
      hopper::wgmma_n256<0>(acc, ah, bh);
      if constexpr (SPLIT) {
        hopper::wgmma_n256<0>(acc, ah, winattn::desc64(b + WB) + 2 * ks);
        hopper::wgmma_n256<0>(acc, winattn::desc64(a + ATOM) + 2 * ks, bh);
      }
    }
    hopper::wgmma_commit();
    // chunk c + 1 split, into parts no queued product reads, while chunk
    // c's products run
    if (c + 1 < nk) split(c + 1);
    hopper::wgmma_wait<1>();   // chunk c - 1's products done
    hopper::fence_operands<BN / 2>(acc);
    __syncthreads();
    if (tid == 0) {
      hopper::fence_proxy_async();
      // the slot of chunk c + 1 (just split) takes chunk c + 1 + NCH; the
      // w slot of chunk c - 1 takes tile c - 1 + NSW
      if (c + 1 + NCH < nk) load_x(c + 1 + NCH);
      if (c >= 1 && c - 1 + L::NSW < nk) load_w(c - 1 + L::NSW);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands<BN / 2>(acc);

  // y: the accumulator (thread (warp w, lane 4 g + t): rows 16 w + g + 8 i,
  // columns 8 j + 2 t + e at acc[4 j + 2 i + e]) into eight [64 x 32]
  // boxes over the x chunks (all split, none in flight), then out by TMA
  const int wl = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          smem + L::X + (j >> 2) * YB +
          swz128(16 * wl + g + 8 * i, 8 * (j & 3) + 2 * t)) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int bx = 0; bx < BN / 32 && n0 + 32 * bx < N; ++bx)
      hopper::tma_store_2d(&ymap, base + L::X + bx * YB, n0 + 32 * bx, m0);
    hopper::bulk_commit();
    hopper::bulk_wait_read<0>();   // the staging read out before exit
  }
}

template <bool SPLIT>
int launch(const float* x, const bf16* parts, float* y, int M, int N, int K,
           cudaStream_t s) {
  using L = Layout<SPLIT>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int wrows = N < BN ? N : BN;
  CUtensorMap xmap, wmap, ymap;
  const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint32_t xb[2] = {BK, BM};
  const uint64_t wd[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N),
                          static_cast<uint64_t>(L::NP)};
  const uint32_t wb[3] = {BK, static_cast<uint32_t>(wrows), 1};
  const uint64_t yd[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint32_t yb[2] = {32, BM};
  int e = hopper::make_map(&xmap, x, 2, xd, xb, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e == 0)
    e = hopper::make_map(&wmap, parts, 3, wd, wb, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = hopper::make_map(&ymap, y, 2, yd, yb, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (e != 0) return e;
  // a programmatic dependent launch: the kernel starts beside the split
  // kernel before it and waits for its parts (griddepcontrol.wait) only
  // before loading w
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, M / BM);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t r =
      cudaLaunchKernelEx(&cfg, kernel<SPLIT>, xmap, wmap, ymap, N, K, wrows);
  return static_cast<int>(r != cudaSuccess ? r : cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// parts [with_lo ? 2 : 1, N, K] bf16 <- the parts of w [K, N] float32
// (hi = bf16(w^T), lo = bf16(w^T - hi)); K a multiple of 32, N of 64.
int hdrvae_f32_dot_split_w(const void* w, void* parts, int K, int N,
                           int with_lo, void* stream) {
  if (K < 32 || N < 64 || K % 32 || N % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / 32, K / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  bf16* pp = static_cast<bf16*>(parts);
  if (with_lo)
    split_w_kernel<true><<<grid, 256, 0, s>>>(wp, pp, K, N);
  else
    split_w_kernel<false><<<grid, 256, 0, s>>>(wp, pp, K, N);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K], y [M, N] float32, row major and 16-byte aligned; M and N
// multiples of 64, K of 32.  mode 0 (highest): w is w [K, N] float32;
// modes 1 (high) and 2 (default): w is the parts hdrvae_f32_dot_split_w
// wrote (two parts for high, one for default).  cudaErrorInvalidValue for
// shapes or modes it does not take.
int hdrvae_f32_dot(const void* x, const void* w, void* y, int M, int N,
                   int K, int mode, void* stream) {
  if (M < 64 || N < 64 || K < 32 || M % 64 || N % 64 || K % 32 || mode < 0 ||
      mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  if (mode == 0)
    return ffma::launch(xp, static_cast<const float*>(w), yp, M, N, K, s);
  const bf16* parts = static_cast<const bf16*>(w);
  return mode == 1 ? tc::launch<true>(xp, parts, yp, M, N, K, s)
                   : tc::launch<false>(xp, parts, yp, M, N, K, s);
}

}  // extern "C"
