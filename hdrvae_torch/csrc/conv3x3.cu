// The decoder's 3x3 convolutions as implicit GEMMs on Hopper's tensor cores
// (bf16 operands, float32 accumulation), with the decoder's fusions.
//
// Replaces two TPU kernels of the JAX package:
//   K1  hdrvae/kernels/conv3x3.py::fused_conv3x3
//       y = conv3x3_SAME(silu(x * gamma + beta)) + bias [+ r | + r @ Wr]
//       and the per-group (sum, sumsq) of y as stored, for the next
//       GroupNorm.
//   K2  hdrvae/kernels/conv3x3.py::upsample_conv3x3
//       y = conv3x3_SAME(nearest2x(x)) + bias through the 2x2 phase
//       decomposition: each output phase (a, b) is a 2x2 conv of the
//       low-resolution map with pre-summed weights, so the upsampled map is
//       never written to memory and the MACs drop 2.25x.
//
// What bounds it on the H100: at the decoder's shapes (Cin, Cout of
// 128..512) a conv does 2*9*Cin flops per output value against a few bytes
// moved, far above the card's ~295 flops/byte ridge, so the bound is the
// tensor-core rate.  This version feeds the tensor cores with WMMA
// (16x16x16 mma.sync fragments) from shared memory through a two-stage
// cp.async pipeline (the next K chunk loads while this one multiplies);
// wgmma, TMA and a deeper ring are later work.
//
// Design:
//  * A block computes an 8 x 16 pixel tile (8 output rows of 16 pixels,
//    one WMMA M dimension per row) for 64 output channels; 4 warps each own
//    2 rows x 64 channels (8 accumulator fragments).
//  * K loops over input channels in chunks of 16.  Per chunk the block
//    copies the halo'd input slab [10 x 18 pixels x 16 channels] and the
//    chunk's weights of every tap into one of two shared-memory stages;
//    once a thread's copies land it applies the GroupNorm affine + SiLU
//    prologue to them in place, rounded to bf16.  The 9 taps (4 per phase
//    for K2) are shifted 16-pixel windows of that slab, so each input
//    value is normalized once per chunk, not once per tap.
//  * The SAME zeros are written AFTER the prologue: an out-of-image pixel is
//    a zero of the normalized activation, never silu(beta).  Halo loads are
//    bounds-masked on the plain [B, H, W, C] tensor; no padded layout.
//  * The residual add happens in float32 before the bf16 store; the
//    nin_shortcut projection r @ Wr runs as extra K steps into the same
//    accumulators (its bias is folded into `bias` by the caller).
//  * Statistics are of y as stored (after bf16 rounding).  Blocks run in
//    no order, so each block writes per-channel partial sums of its tile
//    and a second kernel (hdrvae_group_stats) reduces them per (batch,
//    group) in a fixed order: the sums are deterministic, no atomics.
//  * K2's stats_only mode (y null) computes and rounds y exactly as with y
//    written but stores only the partials: the GroupNorm moments of an
//    upsampled map that is never allocated (the streaming top level,
//    upconv.cu).  Same tiles, same order: the sums are bit for bit those
//    of the launch that writes y.
//  * An identity residual may be y's own storage (the chain writes a
//    block's output over a residual it no longer needs): each element of
//    res is read by the thread that then writes that element of y, and by
//    no other, so res and y carry no __restrict__.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;              // output rows per tile
constexpr int TW = 16;             // output pixels per row (WMMA M)
constexpr int BN = 64;             // output channels per block
constexpr int BK = 16;             // input channels per K step
constexpr int SH = TH + 2;         // slab rows (1-pixel halo)
constexpr int SW = TW + 2;         // slab columns
constexpr int WLD = BN + 8;        // weight tile row stride (bf16)
constexpr int OLD = BN + 4;        // float32 staging row stride
constexpr int NTHREADS = 128;

constexpr int SLAB_BYTES = SH * SW * BK * 2;           // 5,760
constexpr int W_BYTES = 9 * BK * WLD * 2;              // 20,736
constexpr int PIPE_BYTES = SLAB_BYTES + W_BYTES;       // one stage
constexpr int OUT_BYTES = TH * TW * OLD * 4;           // 34,816
constexpr int SMEM_BYTES =
    OUT_BYTES > 2 * PIPE_BYTES ? OUT_BYTES : 2 * PIPE_BYTES;   // 52,992

enum { MODE_CONV = 0, MODE_UP = 1 };
enum { RES_NONE = 0, RES_ADD = 1, RES_PROJ = 2 };

__device__ __forceinline__ float silu(float z) {
  return z * (1.0f / (1.0f + expf(-z)));
}

// 16-byte global -> shared copy; zero-fills when !valid (no bytes read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// One 8-channel vector of x at pixel (hh, ww), zero outside the image.
__device__ __forceinline__ uint4 load_vec(const bf16* __restrict__ x, int b,
                                          int hh, int ww, int H, int W,
                                          int C, int c) {
  if (hh < 0 || hh >= H || ww < 0 || ww >= W)
    return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(
      x + ((static_cast<size_t>(b) * H + hh) * W + ww) * C + c);
}

// Issue the copies of K chunk c0 into one pipeline stage: the halo'd slab
// (out-of-image pixels zero-filled) and the chunk's weights of every tap.
template <int MODE>
__device__ __forceinline__ void issue_chunk(
    bf16* slab, bf16* wsm, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int b, int h0, int w0, int H, int W,
    int Cin, int Cout, int c0, int n0, int phase) {
  constexpr int NTAPS = (MODE == MODE_UP) ? 4 : 9;
  for (int i = threadIdx.x; i < SH * SW * 2; i += NTHREADS) {
    const int s = i >> 1, half = i & 1;
    const int hh = h0 - 1 + s / SW, ww = w0 - 1 + s % SW;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const bf16* src =
        in ? x + ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin + c0 +
                 half * 8
           : x;
    cp_async16(slab + s * BK + half * 8, src, in);
  }
  for (int i = threadIdx.x; i < NTAPS * BK * (BN / 8); i += NTHREADS) {
    const int vc = i % (BN / 8), row = i / (BN / 8);
    const int tap = row / BK, k = row % BK;
    const int wtap = (MODE == MODE_UP) ? phase * 4 + tap : tap;
    cp_async16(wsm + row * WLD + vc * 8,
               w + (static_cast<size_t>(wtap) * Cin + c0 + k) * Cout + n0 +
                   vc * 8,
               true);
  }
}

// GroupNorm affine + SiLU, rounded to bf16, in place on the slab vectors
// this thread copied (the same index walk as issue_chunk, so a thread only
// reads copies it has waited for); out-of-image pixels stay zero.
__device__ __forceinline__ void prologue_chunk(
    bf16* slab, const float* __restrict__ gamma,
    const float* __restrict__ beta, int b, int h0, int w0, int H, int W,
    int Cin, int c0) {
  for (int i = threadIdx.x; i < SH * SW * 2; i += NTHREADS) {
    const int s = i >> 1, half = i & 1;
    const int hh = h0 - 1 + s / SW, ww = w0 - 1 + s % SW;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    uint4* p = reinterpret_cast<uint4*>(slab + s * BK + half * 8);
    uint4 v = *p;
    bf16* e = reinterpret_cast<bf16*>(&v);
    const int c = c0 + half * 8;
    const float* g = gamma + static_cast<size_t>(b) * Cin + c;
    const float* bt = beta + static_cast<size_t>(b) * Cin + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float z = __bfloat162float(e[j]) * g[j] + bt[j];
      e[j] = __float2bfloat16(silu(z));
    }
    *p = v;
  }
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS) conv_tile_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* res,
    const bf16* __restrict__ res_w, bf16* y,
    float* __restrict__ partial, int H, int W, int Cin, int Cout, int Cr,
    int res_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_w = (W + TW - 1) / TW;
  const int tile = blockIdx.x;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = (MODE == MODE_UP) ? blockIdx.z / 4 : blockIdx.z;
  const int phase = (MODE == MODE_UP) ? blockIdx.z % 4 : 0;
  const int pa = phase / 2, pb = phase % 2;
  constexpr int NTAPS = (MODE == MODE_UP) ? 4 : 9;
  const int r0 = warp * 2;   // this warp's first tile row
  const bool prologue = MODE == MODE_CONV && gamma != nullptr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) wmma::fill_fragment(acc[r][nf], 0.0f);

  const int nchunks = Cin / BK;
  issue_chunk<MODE>(reinterpret_cast<bf16*>(smem),
                    reinterpret_cast<bf16*>(smem + SLAB_BYTES), x, w, b, h0,
                    w0, H, W, Cin, Cout, 0, n0, phase);
  cp_async_commit();
  for (int ci = 0; ci < nchunks; ++ci) {
    unsigned char* cur = smem + (ci & 1) * PIPE_BYTES;
    bf16* slab = reinterpret_cast<bf16*>(cur);
    bf16* wsm = reinterpret_cast<bf16*>(cur + SLAB_BYTES);
    if (ci + 1 < nchunks) {
      unsigned char* nxt = smem + ((ci + 1) & 1) * PIPE_BYTES;
      issue_chunk<MODE>(reinterpret_cast<bf16*>(nxt),
                        reinterpret_cast<bf16*>(nxt + SLAB_BYTES), x, w, b,
                        h0, w0, H, W, Cin, Cout, (ci + 1) * BK, n0, phase);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this chunk's copies (not the next one's) landed
    if (prologue)
      prologue_chunk(slab, gamma, beta, b, h0, w0, H, W, Cin, ci * BK);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < NTAPS; ++tap) {
      const int di = (MODE == MODE_UP) ? pa + tap / 2 : tap / 3;
      const int dj = (MODE == MODE_UP) ? pb + tap % 2 : tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        wmma::load_matrix_sync(bfr[nf], wsm + tap * BK * WLD + nf * 16, WLD);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, slab + ((r0 + r + di) * SW + dj) * BK, BK);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          wmma::mma_sync(acc[r][nf], af, bfr[nf], acc[r][nf]);
      }
    }
    __syncthreads();   // the next iteration refills the other stage
  }
  cp_async_wait<0>();
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* wsm = reinterpret_cast<bf16*>(smem + SLAB_BYTES);

  if (MODE == MODE_CONV && res_mode == RES_PROJ) {
    // nin_shortcut: acc += r[tile pixels] @ Wr, 16 residual channels a step
    for (int c0 = 0; c0 < Cr; c0 += BK) {
      for (int i = tid; i < TH * TW * 2; i += NTHREADS) {
        const int p = i >> 1, half = i & 1;
        const uint4 v = load_vec(res, b, h0 + p / TW, w0 + p % TW, H, W, Cr,
                                 c0 + half * 8);
        *reinterpret_cast<uint4*>(slab + p * BK + half * 8) = v;
      }
      for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
        const int vc = i % (BN / 8), k = i / (BN / 8);
        *reinterpret_cast<uint4*>(wsm + k * WLD + vc * 8) =
            *reinterpret_cast<const uint4*>(
                res_w + static_cast<size_t>(c0 + k) * Cout + n0 + vc * 8);
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
        wmma::load_matrix_sync(bfr[nf], wsm + nf * 16, WLD);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, slab + (r0 + r) * TW * BK, BK);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          wmma::mma_sync(acc[r][nf], af, bfr[nf], acc[r][nf]);
      }
      __syncthreads();
    }
  }

  // epilogue: stage the accumulators (the main-loop buffers are dead)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
      wmma::store_matrix_sync(stage + (r0 + r) * TW * OLD + nf * 16,
                              acc[r][nf], OLD, wmma::mem_row_major);
  __syncthreads();

  const int Ho = (MODE == MODE_UP) ? 2 * H : H;
  const int Wo = (MODE == MODE_UP) ? 2 * W : W;
  for (int i = tid; i < TH * TW * BN; i += NTHREADS) {
    const int p = i / BN, co = i % BN;
    const int hh = h0 + p / TW, ww = w0 + p % TW;
    float v = 0.0f;
    if (hh < H && ww < W) {
      const int oh = (MODE == MODE_UP) ? 2 * hh + pa : hh;
      const int ow = (MODE == MODE_UP) ? 2 * ww + pb : ww;
      const size_t o =
          ((static_cast<size_t>(b) * Ho + oh) * Wo + ow) * Cout + n0 + co;
      v = stage[p * OLD + co] + bias[n0 + co];
      if (MODE == MODE_CONV && res_mode == RES_ADD)
        v += __bfloat162float(res[o]);
      const bf16 yb = __float2bfloat16(v);
      if (y != nullptr) y[o] = yb;   // K2 stats_only: no y at all
      v = __bfloat162float(yb);   // statistics of y as stored
    }
    stage[p * OLD + co] = v;
  }

  if (partial != nullptr) {
    __syncthreads();
    // per-channel partial (sum, sumsq) of this tile; thread -> (channel, which)
    const int tiles = gridDim.x * ((MODE == MODE_UP) ? 4 : 1);
    const int t = (MODE == MODE_UP) ? blockIdx.x * 4 + phase : blockIdx.x;
    for (int j = tid; j < 2 * BN; j += NTHREADS) {
      const int ch = j % BN, sq = j / BN;
      float s = 0.0f;
      for (int p = 0; p < TH * TW; ++p) {
        const float v = stage[p * OLD + ch];
        s += sq ? v * v : v;
      }
      partial[((static_cast<size_t>(b) * tiles + t) * 2 + sq) * Cout + n0 +
              ch] = s;
    }
  }
}

// partial [B, T, 2, C] -> out [B, 2, G]: sum over tiles and each group's
// channels, in a fixed order (deterministic).
__global__ void __launch_bounds__(256) group_stats_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int T, int C,
    int G) {
  __shared__ float red[2][256];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int gs = C / G;
  float s = 0.0f, q = 0.0f;
  for (int i = tid; i < T * gs; i += 256) {
    const int t = i / gs, j = i % gs;
    const size_t base = (static_cast<size_t>(b) * T + t) * 2 * C + g * gs + j;
    s += partial[base];
    q += partial[base + C];
  }
  red[0][tid] = s;
  red[1][tid] = q;
  __syncthreads();
  for (int stride = 128; stride > 0; stride >>= 1) {
    if (tid < stride) {
      red[0][tid] += red[0][tid + stride];
      red[1][tid] += red[1][tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[(static_cast<size_t>(b) * 2) * G + g] = red[0][0];
    out[(static_cast<size_t>(b) * 2 + 1) * G + g] = red[1][0];
  }
}

inline int tiles_of(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16; w [3,3,Cin,Cout] bf16 (HWIO); bias [Cout] f32;
// gamma/beta [B,Cin] f32 or null; res [B,H,W,Cr] bf16 or null; res_w
// [Cr,Cout] bf16 or null; y [B,H,W,Cout] bf16; partial [B,T,2,Cout] f32 or
// null, T = ceil(H/8) * ceil(W/16).  Cin, Cr % 16 == 0, Cout % 64 == 0.
int hdrvae_fused_conv3x3(const void* x, const void* w, const void* bias,
                         const void* gamma, const void* beta, const void* res,
                         const void* res_w, void* y, void* partial, int B,
                         int H, int W, int Cin, int Cout, int Cr,
                         int res_mode, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_tile_kernel<MODE_CONV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles_of(H, W), Cout / BN, B);
  conv_tile_kernel<MODE_CONV><<<grid, NTHREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(res),
      static_cast<const bf16*>(res_w), static_cast<bf16*>(y),
      static_cast<float*>(partial), H, W, Cin, Cout, Cr, res_mode);
  return static_cast<int>(cudaGetLastError());
}

// x [B,H,W,Cin] bf16; pw [2,2,2,2,Cin,Cout] bf16 phase weights (a,b,u,v);
// bias [Cout] f32; y [B,2H,2W,Cout] bf16, or null (stats_only: partial
// must then be given); partial [B,4T,2,Cout] f32 or null.
int hdrvae_upsample_conv3x3(const void* x, const void* pw, const void* bias,
                            void* y, void* partial, int B, int H, int W,
                            int Cin, int Cout, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_tile_kernel<MODE_UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles_of(H, W), Cout / BN, B * 4);
  conv_tile_kernel<MODE_UP><<<grid, NTHREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(pw),
      static_cast<const float*>(bias), nullptr, nullptr, nullptr, nullptr,
      static_cast<bf16*>(y), static_cast<float*>(partial), H, W, Cin, Cout, 0,
      RES_NONE);
  return static_cast<int>(cudaGetLastError());
}

// partial [B,T,2,C] f32 -> out [B,2,G] f32 (per-group sum and sum of squares)
int hdrvae_group_stats(const void* partial, void* out, int B, int T, int C,
                       int G, void* stream) {
  group_stats_kernel<<<dim3(G, B), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), T, C, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
