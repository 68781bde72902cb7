// The decoder's streaming top-level junction as one kernel on Hopper's
// tensor cores (bf16 operands, float32 accumulation):
//
//   y = conv3x3_SAME(band) + bias,
//   band = bf16(silu(bf16(conv3x3_SAME(nearest2x(x)) + up_bias) * gamma
//                    + beta)), zero outside the image,
//
// and the per-channel (sum, sumsq) partials of y as stored, for the next
// GroupNorm.  x [B, H, W, Cin] -> y [B, 2H, 2W, Cout]; the upsampled map
// [B, 2H, 2W, Cm] exists only as one tile's band in shared memory.
//
// Replaces the TPU kernel hdrvae/kernels/conv3x3.py::upconv_gn_conv3x3
// (entry :1059, body _upconv_gn_conv_kernel :824): the upsample conv of
// the decoder's top level fused with block 0's norm1 + SiLU + conv1.  Its
// GroupNorm moments come from K2's stats_only pass (conv3x3.cu).  At a
// 4096^2 output the absent map is 8 GiB of bf16.
//
// What bounds it on the H100: at the 2048^2 decode's junction (x [1, 1024,
// 1024, 256] -> [1, 2048, 2048, 128], Cm 256) the up-conv's phase
// decomposition does 2 * 1024^2 * 16 * 256 * 256 = 2.20 TFLOP and conv1
// 2 * 2048^2 * 9 * 256 * 128 = 2.47 TFLOP against ~1.6 GB of input and
// output, so the bound is the tensor-core rate: 4.67 TFLOP / 989 TFLOP/s
// = 4.7 ms.  This first version is mma.sync m16n8k16 (ldmatrix operands)
// with one block an SM; wgmma, TMA and larger tiles are later work.
//
// Design, per block of 8 warps and one 8 x 16 output tile, all Cout:
//  * The band is the tile plus a 1-pixel halo, 10 x 18 pixels x all Cm
//    channels (conv1 contracts over every one of them), 95 KB at Cm 256.
//    Each block recomputes the up-conv over its halo: 180 band pixels for
//    128 output pixels, x1.41 on the up-conv half of the work.
//  * The band's up-conv reads a 6 x 10 low-resolution slab (all Cin,
//    zero-filled outside the image = SAME padding of the upsampled map),
//    loaded once.  Band pixels are grouped by output phase (a, b): each
//    phase is a GEMM of 45 pixels (3 row tiles) x Cm over 4 taps x Cin with
//    that phase's pre-summed weights (conv3x3.py::phase_kernels), whose A
//    rows are gathered from the slab by per-lane ldmatrix addresses.  Its
//    epilogue adds up_bias, rounds to bf16 (the map as the unfused pair
//    would have stored it), applies the GroupNorm affine and SiLU, rounds
//    to bf16 and writes the band, zero where the pixel is outside the
//    image (after the SiLU: silu(beta) must not leak into conv1's taps).
//  * conv1 runs from the band in shared memory: 9 taps x Cm, A rows again
//    gathered by ldmatrix, each warp 2 output rows x Cout / 2 channels.
//  * Weights (phase kernels [2,2,2,2,Cin,Cm], conv1 [3,3,Cm,Cout]) stream
//    from L2 through a two-buffer cp.async ring of 64-row pieces.
//  * A block owns all Cout = 128 channels, so no band is computed twice.
//  * Statistics are of y as stored, per-tile partials reduced in a fixed
//    order by conv3x3.cu's hdrvae_group_stats: deterministic, no atomics.

#include "window_attention.cuh"   // ldmatrix, mma.sync and cp.async helpers

namespace {

using winattn::bf16;
using winattn::cp_async_commit;
using winattn::cp_async_wait;
using winattn::ldsm_x4;
using winattn::ldsm_x4_trans;
using winattn::mma_bf16_16816;

constexpr int TH = 8;                  // output rows per tile
constexpr int TW = 16;                 // output pixels per row
constexpr int BR = TH + 2;             // band rows (1-pixel halo)
constexpr int BC = TW + 2;             // band columns
constexpr int LR = TH / 2 + 2;         // low-resolution slab rows
constexpr int LC = TW / 2 + 2;         // low-resolution slab columns
constexpr int PH_R = BR / 2;           // band rows of one phase
constexpr int PH_C = BC / 2;           // band columns of one phase
constexpr int PH_PIX = PH_R * PH_C;    // 45 band pixels a phase
constexpr int PH_MT = (PH_PIX + 15) / 16;   // its 3 row tiles
constexpr int KP = 64;                 // weight rows per ring piece
constexpr int NTHREADS = 256;          // 8 warps
constexpr int NWARPS = NTHREADS / 32;

template <int CM, int COUT>
struct Layout {
  static constexpr int LDM = CM + 8;                          // band pixel
  static constexpr int RLD = (CM > COUT ? CM : COUT) + 8;     // ring row
  static constexpr int BAND = BR * BC * LDM;                  // bf16 elems
  static constexpr int RING = 2 * KP * RLD;
  static constexpr int SLD = COUT + 4;                        // stage row
  static_assert(TH * TW * SLD * 4 <= (BAND + RING) * 2,
                "the epilogue stage reuses the band and ring");
  static int bytes(int cin) { return (BAND + RING + LR * LC * (cin + 8)) * 2; }
};

// 16-byte global -> shared copy; zero-fills when !valid (no bytes read).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = winattn::smem_addr(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float silu(float z) {
  return z * (1.0f / (1.0f + expf(-z)));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int CM, int COUT>
__global__ void __launch_bounds__(NTHREADS, 1) upconv_gn_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ pw,
    const float* __restrict__ up_bias, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w1,
    const float* __restrict__ bias, bf16* __restrict__ y,
    float* __restrict__ partial, int H, int W, int Cin) {
  typedef Layout<CM, COUT> L;
  constexpr int LDM = L::LDM, RLD = L::RLD;
  constexpr int NT8A = CM / NWARPS / 8;       // band n8 tiles of a warp
  constexpr int NT8B = COUT / 2 / 8;          // conv1 n8 tiles of a warp
  static_assert(NT8A % 2 == 0 && NT8B % 2 == 0, "x4 B fragments");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* band = reinterpret_cast<bf16*>(smem);
  bf16* ring = band + L::BAND;
  bf16* slab = ring + L::RING;
  float* stage = reinterpret_cast<float*>(smem);   // epilogue only

  const int LDS = Cin + 8;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_w = (W2 + TW - 1) / TW;
  const int oh0 = (blockIdx.x / tiles_w) * TH;
  const int ow0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The slab: low-resolution rows oh0/2 - 1 .. oh0/2 + 4 and columns
  // ow0/2 - 1 .. ow0/2 + 8.  Band pixel (br, bc) at output (oh0 - 1 + br,
  // ow0 - 1 + bc) = (2i + a, 2j + c) reads x[i - 1 + a + u][j - 1 + c + v];
  // with br = 2 ri + 1 - a that is slab row ri + u (column ci + v).
  const int lh0 = oh0 / 2 - 1, lw0 = ow0 / 2 - 1;
  const int vecs = Cin / 8;
  for (int i = tid; i < LR * LC * vecs; i += NTHREADS) {
    const int p = i / vecs, v = i % vecs;
    const int hh = lh0 + p / LC, ww = lw0 + p % LC;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const bf16* src =
        in ? x + ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin + v * 8
           : x;
    cp_async16z(slab + p * LDS + v * 8, src, in);
  }

  // Ring pieces: 4 phases x npa pieces of [4 Cin, Cm] phase weights (tap
  // (u, v) major, then input channel), then npb pieces of conv1's [9 Cm,
  // Cout].  The slab copies join the first piece's group.
  const int npa = 4 * Cin / KP;
  constexpr int npb = 9 * CM / KP;
  const int na = 4 * npa, total = na + npb;
  auto load = [&](int i) {
    if (i < total) {
      bf16* dst = ring + (i & 1) * KP * RLD;
      const bool up = i < na;
      const int cols = up ? CM : COUT;
      const bf16* src =
          up ? pw + (static_cast<size_t>(i / npa) * 4 * Cin +
                     static_cast<size_t>(i % npa) * KP) * CM
             : w1 + static_cast<size_t>(i - na) * KP * COUT;
      const int per_row = cols / 8;
      for (int e = tid; e < KP * per_row; e += NTHREADS) {
        const int r = e / per_row, c = (e % per_row) * 8;
        winattn::cp_async16(dst + r * RLD + c,
                            src + static_cast<size_t>(r) * cols + c);
      }
    }
    cp_async_commit();
  };

  // The A rows of this lane in the band GEMM: phase pixel m of row tile mt
  // (rows past the 45 repeat the last one; their sums are dropped).
  int prow[PH_MT], pcol[PH_MT];
#pragma unroll
  for (int mt = 0; mt < PH_MT; ++mt) {
    const int m = min(mt * 16 + (lane & 15), PH_PIX - 1);
    prow[mt] = m / PH_C;
    pcol[mt] = m % PH_C;
  }
  const int rp = warp & 3, chalf = warp >> 2;   // conv1: row pair, Cout half

  float acc_a[PH_MT][NT8A][4];
  float acc_b[2][NT8B][4];

  load(0);
  for (int i = 0; i < total; ++i) {
    load(i + 1);
    cp_async_wait<1>();   // piece i (and with it the slab) has landed
    __syncthreads();
    const bf16* rb = ring + (i & 1) * KP * RLD;
    if (i < na) {
      // ---- band GEMM of phase ph, piece p ------------------------------
      const int ph = i / npa, p = i % npa;
      const int pa = ph >> 1, pb = ph & 1;
      if (p == 0) {
#pragma unroll
        for (int mt = 0; mt < PH_MT; ++mt)
#pragma unroll
          for (int t = 0; t < NT8A; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_a[mt][t][e] = 0.0f;
      }
#pragma unroll 1
      for (int ks = 0; ks < KP / 16; ++ks) {
        const int k = p * KP + ks * 16;
        const int tap = k / Cin, c = k % Cin;
        const int u = tap >> 1, v = tap & 1;
        unsigned bfr[NT8A / 2][4];
#pragma unroll
        for (int j = 0; j < NT8A / 2; ++j)
          ldsm_x4_trans(bfr[j], rb + (ks * 16 + (lane & 15)) * RLD +
                                    warp * (CM / NWARPS) + j * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < PH_MT; ++mt) {
          unsigned af[4];
          ldsm_x4(af, slab + ((prow[mt] + u) * LC + pcol[mt] + v) * LDS + c +
                          (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NT8A / 2; ++j) {
            mma_bf16_16816(acc_a[mt][2 * j], af, bfr[j]);
            mma_bf16_16816(acc_a[mt][2 * j + 1], af, bfr[j] + 2);
          }
        }
      }
      if (p == npa - 1) {
        // phase epilogue: + up_bias, bf16, GN affine + SiLU, bf16, band
        // (mma's C layout: lane l holds rows l/4 and l/4 + 8, columns
        // 2 (l % 4) + {0, 1} of each n8 tile)
#pragma unroll
        for (int mt = 0; mt < PH_MT; ++mt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = mt * 16 + (lane >> 2) + 8 * hf;
            if (m >= PH_PIX) continue;
            const int br = 2 * (m / PH_C) + 1 - pa;
            const int bc = 2 * (m % PH_C) + 1 - pb;
            const int oh = oh0 - 1 + br, ow = ow0 - 1 + bc;
            const bool in = oh >= 0 && oh < H2 && ow >= 0 && ow < W2;
            bf16* dst = band + (br * BC + bc) * LDM;
#pragma unroll
            for (int t = 0; t < NT8A; ++t) {
              const int n = warp * (CM / NWARPS) + t * 8 + 2 * (lane & 3);
              float o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float z = round_bf16(acc_a[mt][t][2 * hf + e] +
                                           up_bias[n + e]);
                const float zn = z * gamma[static_cast<size_t>(b) * CM + n +
                                           e] +
                                 beta[static_cast<size_t>(b) * CM + n + e];
                o[e] = in ? silu(zn) : 0.0f;
              }
              *reinterpret_cast<__nv_bfloat162*>(dst + n) =
                  __floats2bfloat162_rn(o[0], o[1]);
            }
          }
        }
      }
    } else {
      // ---- conv1 from the band, piece j ---------------------------------
      const int j = i - na;
      if (j == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int t = 0; t < NT8B; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_b[r][t][e] = 0.0f;
      }
#pragma unroll 1
      for (int ks = 0; ks < KP / 16; ++ks) {
        const int k = j * KP + ks * 16;
        const int tap = k / CM, cm = k % CM;
        const int di = tap / 3, dj = tap % 3;
        unsigned bfr[NT8B / 2][4];
#pragma unroll
        for (int jj = 0; jj < NT8B / 2; ++jj)
          ldsm_x4_trans(bfr[jj], rb + (ks * 16 + (lane & 15)) * RLD +
                                     chalf * (COUT / 2) + jj * 16 +
                                     (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned af[4];
          ldsm_x4(af, band + ((2 * rp + r + di) * BC + (lane & 15) + dj) * LDM +
                          cm + (lane >> 4) * 8);
#pragma unroll
          for (int jj = 0; jj < NT8B / 2; ++jj) {
            mma_bf16_16816(acc_b[r][2 * jj], af, bfr[jj]);
            mma_bf16_16816(acc_b[r][2 * jj + 1], af, bfr[jj] + 2);
          }
        }
      }
    }
    __syncthreads();   // the next load refills this buffer
  }
  cp_async_wait<0>();

  // ---- epilogue: stage, + bias, bf16 store, statistics of y as stored --
  constexpr int SLD = L::SLD;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int t = 0; t < NT8B; ++t) {
      const int p = (2 * rp + r) * TW + (lane >> 2);
      const int co = chalf * (COUT / 2) + t * 8 + 2 * (lane & 3);
      stage[p * SLD + co] = acc_b[r][t][0];
      stage[p * SLD + co + 1] = acc_b[r][t][1];
      stage[(p + 8) * SLD + co] = acc_b[r][t][2];
      stage[(p + 8) * SLD + co + 1] = acc_b[r][t][3];
    }
  __syncthreads();
  for (int e = tid; e < TH * TW * COUT; e += NTHREADS) {
    const int p = e / COUT, co = e % COUT;
    const int oh = oh0 + p / TW, ow = ow0 + p % TW;
    float v = 0.0f;
    if (oh < H2 && ow < W2) {
      const bf16 yb = __float2bfloat16(stage[p * SLD + co] + bias[co]);
      y[((static_cast<size_t>(b) * H2 + oh) * W2 + ow) * COUT + co] = yb;
      v = __bfloat162float(yb);
    }
    stage[p * SLD + co] = v;
  }
  if (partial != nullptr) {
    __syncthreads();
    const int t = blockIdx.x, tiles = gridDim.x;
    for (int jn = tid; jn < 2 * COUT; jn += NTHREADS) {
      const int ch = jn % COUT, sq = jn / COUT;
      float s = 0.0f;
      for (int p = 0; p < TH * TW; ++p) {
        const float v = stage[p * SLD + ch];
        s += sq ? v * v : v;
      }
      partial[((static_cast<size_t>(b) * tiles + t) * 2 + sq) * COUT + ch] =
          s;
    }
  }
}

template <int CM, int COUT>
int launch(const void* x, const void* pw, const void* up_bias,
           const void* gamma, const void* beta, const void* w1,
           const void* bias, void* y, void* partial, int B, int H, int W,
           int Cin, cudaStream_t stream) {
  const int smem = Layout<CM, COUT>::bytes(Cin);
  cudaError_t err = cudaFuncSetAttribute(
      upconv_gn_conv_kernel<CM, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((2 * H + TH - 1) / TH) * ((2 * W + TW - 1) / TW);
  upconv_gn_conv_kernel<CM, COUT><<<dim3(tiles, 1, B), NTHREADS, smem,
                                     stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(pw),
      static_cast<const float*>(up_bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(partial), H, W, Cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16 (Cin % 16 == 0, <= 512); pw [2,2,2,2,Cin,Cm] bf16
// phase weights (a,b,u,v) of the upsample conv; up_bias [Cm] f32; gamma /
// beta [B,Cm] f32; w1 [3,3,Cm,Cout] bf16 (HWIO); bias [Cout] f32; y
// [B,2H,2W,Cout] bf16; partial [B,T,2,Cout] f32 or null, T = ceil(2H/8) *
// ceil(2W/16).  Cm in {128, 256}, Cout in {64, 128}; returns
// cudaErrorInvalidValue for any other pair.
int hdrvae_upconv_gn_conv3x3(const void* x, const void* pw,
                             const void* up_bias, const void* gamma,
                             const void* beta, const void* w1,
                             const void* bias, void* y, void* partial, int B,
                             int H, int W, int Cin, int Cm, int Cout,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HDRVAE_UPCONV(CM, CO)                                              \
  if (Cm == CM && Cout == CO)                                              \
    return launch<CM, CO>(x, pw, up_bias, gamma, beta, w1, bias, y, partial, \
                          B, H, W, Cin, s);
  HDRVAE_UPCONV(256, 128)
  HDRVAE_UPCONV(256, 64)
  HDRVAE_UPCONV(128, 128)
  HDRVAE_UPCONV(128, 64)
#undef HDRVAE_UPCONV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
