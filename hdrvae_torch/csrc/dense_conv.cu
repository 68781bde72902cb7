// ESRGAN's dense 3x3 convolution as one implicit GEMM on Hopper's tensor
// cores (bf16 operands, float32 accumulation), the concat never formed.
//
// Replaces the TPU kernel K6 of the JAX package:
//   hdrvae/kernels/conv3x3.py::dense_conv3x3
//   y = [r + res_scale *] act(conv3x3_SAME(concat(x_1 .. x_n)) + bias)
//   with 1 <= n <= 5 inputs, act none or LeakyReLU(0.2), Cout <= 128.
// It carries every conv of RRDBNet (models/rrdbnet_fused.py): the dense
// blocks' 64 / 96 / 128 / 160 / 192-channel concats, conv_first (3, 12 or
// 48 channels), the upsample convs and conv_last (3 channels, float32 out).
//
// What bounds it on the H100: 2 * 9 * Cin flops per output value with Cin
// 64..192 against ~(Cin + 2 * Cout) * 2 bytes per pixel moved is far above
// the card's ~295 flops/byte ridge, so the bound is the tensor-core rate;
// but the narrow Cout (32 or 64) gives each A fragment little reuse.  This
// first version uses WMMA (16x16x16 mma.sync fragments) from shared memory
// through a two-stage cp.async pipeline; wgmma, TMA and a deeper ring are
// later work.
//
// Design:
//  * A block computes a TH x 16 pixel tile (TH = 4 * RPW rows, one WMMA M
//    dimension per row) for all Cout channels, padded to NF * 16 columns.
//    4 warps each own RPW rows x NF fragments; RPW shrinks as NF grows so
//    every instantiation holds ~8 accumulator fragments (cout 32: 16 rows,
//    cout 64: 8 rows, cout 128: 4 rows).
//  * K walks input by input and, within an input, in 16-channel steps.
//    Each step copies that input's halo'd slab [TH+2 x 18 pixels x 16
//    channels] and the step's weight rows of all nine taps (rows
//    koff_i + c0 .. koff_i + c0 + 15 of the [9, Cin, NP] weights) into one
//    of two shared-memory stages, so the concat exists only as the order
//    of the K loop.  Channels past an input's end are zero in both the slab
//    and the weight tile (smem garbage could be NaN, and NaN * 0 is NaN):
//    that pads conv_first's 3 channels, and any width that is not a
//    multiple of 16, to a whole K step.
//  * Inputs whose width is a multiple of 8 (and 16-byte aligned) copy with
//    16-byte cp.async; others (3, 12 channels) load element by element.
//  * Every row and column is bounds-masked: out-of-image halo pixels are
//    the SAME zeros of the input, and stores past H or W are skipped, so no
//    shape needs W % 8 == 0 or a multiple of the tile.
//  * The epilogue runs in float32 before the one storage cast: + bias,
//    LeakyReLU, then r + res_scale * v, each rounded as the plain version
//    rounds (no fused multiply-add).  The output is bf16 or float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_IN = 5;
constexpr int TW = 16;         // output pixels per tile row (WMMA M)
constexpr int BK = 16;         // channels per K step
constexpr int SW = TW + 2;     // slab columns (1-pixel halo)
constexpr int NTHREADS = 128;  // 4 warps

struct DenseArgs {
  const bf16* x[MAX_IN];
  int c[MAX_IN];      // channels of input i
  int koff[MAX_IN];   // first weight row of input i
  int vec[MAX_IN];    // 1 when input i takes 16-byte copies
  int n_in;
  int nsteps;         // sum over inputs of ceil(c_i / 16)
  const bf16* w;      // [9, Cin, NP] bf16, columns past Cout zero
  const float* bias;  // [Cout]
  const bf16* res;    // [B, H, W, Cout] or null
  void* y;            // [B, H, W, Cout] bf16 or float32
  int H, W, Cin, Cout;
  int act;            // 0 none, 1 LeakyReLU(0.2)
  float res_scale;
  int out_f32;
};

template <int NF>
struct Tile {
  static constexpr int RPW = NF <= 2 ? 4 : (NF <= 4 ? 2 : 1);
  static constexpr int TH = 4 * RPW;
  static constexpr int SH = TH + 2;
  static constexpr int NP = NF * 16;
  static constexpr int WLD = NP + 8;   // weight tile row stride (bf16)
  static constexpr int OLD = NP + 4;   // float32 staging row stride
  static constexpr int SLAB_BYTES = SH * SW * BK * 2;
  static constexpr int W_BYTES = 9 * BK * WLD * 2;
  static constexpr int PIPE_BYTES = SLAB_BYTES + W_BYTES;
  static constexpr int OUT_BYTES = TH * TW * OLD * 4;
  static constexpr int SMEM_BYTES =
      OUT_BYTES > 2 * PIPE_BYTES ? OUT_BYTES : 2 * PIPE_BYTES;
};

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

// Start the copies of K step s into one pipeline stage: input i's slab for
// channels [c0, c0 + 16) and the matching weight rows of every tap.
template <int NF>
__device__ __forceinline__ void issue_step(bf16* slab, bf16* wsm,
                                           const DenseArgs& a, int s, int b,
                                           int h0, int w0) {
  using T = Tile<NF>;
  int i = 0;
  while (s >= (a.c[i] + BK - 1) / BK) {
    s -= (a.c[i] + BK - 1) / BK;
    ++i;
  }
  const int c0 = s * BK;
  const int ci = a.c[i];
  const bf16* __restrict__ xi = a.x[i];
  for (int j = threadIdx.x; j < T::SH * SW * 2; j += NTHREADS) {
    const int p = j >> 1, half = j & 1;
    const int hh = h0 - 1 + p / SW, ww = w0 - 1 + p % SW;
    const int ch = c0 + half * 8;
    const bool in = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
    const size_t pix = (static_cast<size_t>(b) * a.H + hh) * a.W + ww;
    bf16* dst = slab + p * BK + half * 8;
    if (a.vec[i]) {
      const bool valid = in && ch < ci;
      cp_async16(dst, valid ? xi + pix * ci + ch : xi, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (in && ch + e < ci) ? xi[pix * ci + ch + e]
                                     : __float2bfloat16(0.0f);
    }
  }
  for (int j = threadIdx.x; j < 9 * BK * (T::NP / 8); j += NTHREADS) {
    const int vc = j % (T::NP / 8), row = j / (T::NP / 8);
    const int tap = row / BK, k = row % BK;
    const bool valid = c0 + k < ci;
    const bf16* src =
        a.w + (static_cast<size_t>(tap) * a.Cin + a.koff[i] + c0 + k) * T::NP +
        vc * 8;
    cp_async16(wsm + row * T::WLD + vc * 8, valid ? src : a.w, valid);
  }
}

template <int NF>
__global__ void __launch_bounds__(NTHREADS) dense_conv_kernel(DenseArgs a) {
  using T = Tile<NF>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * T::TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int r0 = warp * T::RPW;   // this warp's first tile row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::RPW][NF];
#pragma unroll
  for (int r = 0; r < T::RPW; ++r)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[r][nf], 0.0f);

  issue_step<NF>(reinterpret_cast<bf16*>(smem),
                 reinterpret_cast<bf16*>(smem + T::SLAB_BYTES), a, 0, b, h0,
                 w0);
  cp_async_commit();
  for (int s = 0; s < a.nsteps; ++s) {
    unsigned char* cur = smem + (s & 1) * T::PIPE_BYTES;
    const bf16* slab = reinterpret_cast<const bf16*>(cur);
    const bf16* wsm = reinterpret_cast<const bf16*>(cur + T::SLAB_BYTES);
    if (s + 1 < a.nsteps) {
      unsigned char* nxt = smem + ((s + 1) & 1) * T::PIPE_BYTES;
      issue_step<NF>(reinterpret_cast<bf16*>(nxt),
                     reinterpret_cast<bf16*>(nxt + T::SLAB_BYTES), a, s + 1,
                     b, h0, w0);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this step's copies (not the next one's) landed
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          bfr[NF];
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        wmma::load_matrix_sync(bfr[nf], wsm + tap * BK * T::WLD + nf * 16,
                               T::WLD);
#pragma unroll
      for (int r = 0; r < T::RPW; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, slab + ((r0 + r + di) * SW + dj) * BK,
                               BK);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          wmma::mma_sync(acc[r][nf], af, bfr[nf], acc[r][nf]);
      }
    }
    __syncthreads();   // the next iteration refills the other stage
  }
  cp_async_wait<0>();

  // epilogue: stage the accumulators (the pipeline buffers are dead)
#pragma unroll
  for (int r = 0; r < T::RPW; ++r)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
      wmma::store_matrix_sync(stage + (r0 + r) * TW * T::OLD + nf * 16,
                              acc[r][nf], T::OLD, wmma::mem_row_major);
  __syncthreads();

  for (int j = tid; j < T::TH * TW * a.Cout; j += NTHREADS) {
    const int p = j / a.Cout, co = j % a.Cout;
    const int hh = h0 + p / TW, ww = w0 + p % TW;
    if (hh >= a.H || ww >= a.W) continue;
    const size_t o =
        ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * a.Cout + co;
    float v = __fadd_rn(stage[p * T::OLD + co], a.bias[co]);
    if (a.act) v = v >= 0.0f ? v : __fmul_rn(0.2f, v);
    if (a.res != nullptr)
      v = __fadd_rn(__bfloat162float(a.res[o]), __fmul_rn(a.res_scale, v));
    if (a.out_f32)
      static_cast<float*>(a.y)[o] = v;
    else
      static_cast<bf16*>(a.y)[o] = __float2bfloat16(v);
  }
}

template <int NF>
int launch(const DenseArgs& a, int B, cudaStream_t stream) {
  using T = Tile<NF>;
  cudaError_t err = cudaFuncSetAttribute(
      dense_conv_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + T::TH - 1) / T::TH) * ((a.W + TW - 1) / TW);
  dense_conv_kernel<NF><<<dim3(tiles, 1, B), NTHREADS, T::SMEM_BYTES,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x0..x4 [B,H,W,c_i] bf16 (the first n_in used); w [9,Cin,NP] bf16 with
// NP = 16 * ceil(Cout / 16) and Cin = sum c_i; bias [Cout] f32; res
// [B,H,W,Cout] bf16 or null; y [B,H,W,Cout] bf16 (out_f32 = 0) or f32.
// Returns cudaErrorInvalidValue for n_in outside 1..5, Cout outside 1..128
// or a zero-channel input.
int hdrvae_dense_conv3x3(const void* x0, const void* x1, const void* x2,
                         const void* x3, const void* x4, int c0, int c1,
                         int c2, int c3, int c4, int n_in, const void* w,
                         const void* bias, const void* res, void* y, int B,
                         int H, int W, int Cout, int act, float res_scale,
                         int out_f32, void* stream) {
  const void* xs[MAX_IN] = {x0, x1, x2, x3, x4};
  const int cs[MAX_IN] = {c0, c1, c2, c3, c4};
  if (n_in < 1 || n_in > MAX_IN || Cout < 1 || Cout > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs a = {};
  int koff = 0;
  for (int i = 0; i < n_in; ++i) {
    if (cs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.x[i] = static_cast<const bf16*>(xs[i]);
    a.c[i] = cs[i];
    a.koff[i] = koff;
    a.vec[i] = cs[i] % 8 == 0 &&
               reinterpret_cast<uintptr_t>(xs[i]) % 16 == 0;
    a.nsteps += (cs[i] + BK - 1) / BK;
    koff += cs[i];
  }
  a.n_in = n_in;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.y = y;
  a.H = H;
  a.W = W;
  a.Cin = koff;
  a.Cout = Cout;
  a.act = act;
  a.res_scale = res_scale;
  a.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Cout + 15) / 16) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 3: return launch<3>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 5: return launch<5>(a, B, s);
    case 6: return launch<6>(a, B, s);
    case 7: return launch<7>(a, B, s);
    default: return launch<8>(a, B, s);
  }
}

}  // extern "C"
