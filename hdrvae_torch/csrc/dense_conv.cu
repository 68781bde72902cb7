// ESRGAN's dense 3x3 convolution as one implicit GEMM on Hopper's tensor
// cores (wgmma, bf16 operands, float32 accumulation), the concat never
// formed.
//
// Replaces the TPU kernel K6 of the JAX package:
//   hdrvae/kernels/conv3x3.py::dense_conv3x3
//   y = [r + res_scale *] act(conv3x3_SAME(concat(x_1 .. x_n)) + bias)
//   with 1 <= n <= 5 inputs of any width, act none or LeakyReLU(0.2),
//   Cout <= 128, bf16 or float32 out, any B, H and W.
// It carries every conv of RRDBNet (models/rrdbnet_fused.py): the dense
// blocks' 64 / 96 / 128 / 160 / 192-channel concats, conv_first (3, 12 or
// 48 channels), conv_body, the upsample convs, conv_hr and conv_last (3
// channels, float32 out).
//
// What bounds it on the H100: a body conv does 2 * 9 * Cin * Cout flops a
// pixel against (Cin + Cout [+ Cout of residual]) * 2 bytes: conv1 (64 ->
// 32) 192 flop/B, conv4 (160 -> 32) 240, conv5 (192 -> 64, residual) 346,
// the 64 -> 64 tail convs 576 (with the upsample's input) - around the
// card's ~295 flop/B ridge.  So the activations must stream near the HBM
// rate and the tensor cores stay fed at once.  At n32 a wgmma reads 2 KB of
// A and 1 KB of B from shared memory per 64 x 32 x 16 product, which
// bounds the body's conv1-4 below the tensor-core peak; conv_last (n8) is
// bound by its bytes.
//
// Design (the mainloop of conv3x3.cu's conv_wgmma_kernel, K1 / K2,
// reshaped for narrow N and many narrow inputs):
//  * GEMM view: M = output pixels, N = Cout padded to NP in {8, 16, 32, 64,
//    128} (wgmma m64nNPk16), K = 9 taps x the inputs' channels, walked input
//    by input in chunks of KC = 16 channels (one k16 step), each input's
//    last chunk zero-padded.  A work item is a tile of TR rows x 64 pixels
//    and all NP channels, one m64 block a row: TR = 16 at NP <= 32, 8 at
//    64, 4 at 128, so each thread holds 128 accumulators.  The grid is
//    persistent: one block an SM walks the work items and the copy ring
//    runs on across them, so the next item's loads overlap this one's
//    epilogue.
//  * 384 threads: two consumer warpgroups, each owning half the tile rows,
//    and a producer warpgroup behind "full" / "empty" mbarriers on a ring
//    of NSTAGE stages (4 at NP <= 16 and 64, 3 at 32 and 128, for the
//    output tile's room).  A stage is one chunk: its halo'd slab [(TR+2) x
//    66 pixels x 16 channels] and its weights for all nine taps.  One
//    producer thread issues the copies; the producer's four warps gather
//    what TMA cannot load (with one warp, conv_first was gather-bound).
//  * The slab is stored as two 8-channel planes, pixel-major with 16 bytes a
//    pixel (no swizzle): each 8 x 8 wgmma core matrix of an A window is 8
//    consecutive pixels, 128 contiguous bytes, so a tap's window may start
//    at any pixel.  A descriptor: leading (K) offset = the plane stride,
//    stride (M) offset = 128 B.  This layout holds any channel count: the
//    body's 32-channel inputs (64-byte rows) need no 64-byte swizzle.
//  * Feeds: an input whose width is a multiple of 8 (and whose pointer is
//    16-byte aligned) loads by TMA, one 4-D box a plane at (c0, w0-1, h0-1,
//    b) with zero fill outside the image; a plane wholly past the input's
//    channels is zeroed by the producer.  Other widths (with_small's 4 and
//    12, conv_first's 3 and 12) are gathered by the producer into the same
//    layout.  conv_first (one input narrower than 16 channels) packs K
//    across taps: the gathered planes hold the im2col'd row (tap-major, 9 c
//    values, zero-padded to a multiple of 16) and the chunk runs as one tap,
//    so 3 channels take 2 k16 steps, not 9.
//  * Weights: prepared once per model on the host (kernels/dense_conv.py
//    `prepare_weights`) in the order the kernel reads them, [chunk][tap]
//    [NP/8][2][8 n][8 k]: each (chunk, tap) slice is K-major core matrices
//    (leading offset 128 B, stride 256 B), one contiguous bulk copy a chunk.
//    They stream through the ring from L2; bias comes zero-padded to NP.
//    Kept resident in shared memory instead, conv4's (10 chunks x 9 taps
//    x 16 x 32, 90 KB) would not fit beside the 64 KB output tile and even
//    two stages of the slab ring (228.5 KB of the 227 KB a block may hold):
//    the tile would have to shrink or the output tile go.  What the stream
//    costs is timed by `tools/mutate_kernels.py --time-k6 no-weight-loads`.
//  * One commit group a chunk (9 taps x the warpgroup's m64 blocks), one
//    group left in flight while the next chunk issues; a stage is handed
//    back once its group has retired.
//  * Epilogue from the accumulators, in float32 before the one storage
//    cast, rounded as the plain version rounds (no fused multiply-add):
//    + bias and LeakyReLU in straight-line code (a read of the wgmma
//    results on a path ptxas sees as divergent serializes the wgmmas), then
//    r + res_scale * v.  Where Cout = NP >= 32 (every RRDBNet conv but
//    conv_last) and bf16 out, y leaves through a 64 KB tile in shared
//    memory [TR][64][NP], swizzled as TMA reads it, by one TMA store that
//    clips rows past H or W and runs on while the next item multiplies;
//    the residual comes into the same tile by a TMA load issued as the
//    item starts, once the previous store has read the tile.  Stored from
//    the fragments instead (4 bytes a lane; still the path for conv_last
//    and odd widths, rows and columns masked by coordinate), the epilogue
//    ran with the tensor cores idle and took half of K6's time
//    (mutate_kernels.py --time-k6 no-stores); 16-byte stores after a
//    transpose within each quad were no faster.
//  * Tried and not kept: a ping-pong of the two warpgroups over alternate
//    items of half the rows (faster on the 64 -> 64 tail convs, slower on
//    the body's n32 convs, and 168 registers a thread spilled), and a
//    coalesced epilogue through shared memory by plain stores (slower; its
//    __syncwarp made ptxas serialize the wgmmas).
//    `tools/mutate_kernels.py --time-k6` times what each part costs.

#include <cuda_bf16.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int MAX_IN = 5;
constexpr int TWP = 64;                  // tile pixels a row (one m64 block)
constexpr int SWID = TWP + 2;            // slab pixels a row (1-pixel halo)
constexpr int KC = 16;                   // channels a K chunk
constexpr int NCONSUMER = 256;           // two warpgroups
constexpr int NTHREADS = NCONSUMER + 128; // + the producer warpgroup
constexpr int NCWARPS = NCONSUMER / 32;

template <int NP>
struct Cfg {
  static constexpr int MB = NP <= 32 ? 8 : (NP == 64 ? 4 : 2);
  static constexpr int TR = 2 * MB;                // tile rows
  static constexpr int SPIX = (TR + 2) * SWID;     // slab pixels
  static constexpr int PLANE_TX = SPIX * 16;       // one plane's bytes
  static constexpr int PLANE = (PLANE_TX + 127) / 128 * 128;
  static constexpr int W_TAP = NP * KC * 2;        // one tap's [16 x NP]
  static constexpr int STAGE = 2 * PLANE + 9 * W_TAP;
  // the output tile [TR][64][NP] bf16 that a TMA store writes out (NP >=
  // 32; NP 128 as two 64-channel halves), 64 KB, which leaves room for 3
  // ring stages at NP 32 and 128, 4 at 64
  static constexpr bool TILE_OUT = NP >= 32;
  static constexpr int OUT_BYTES = TILE_OUT ? TR * TWP * NP * 2 : 0;
  static constexpr int NSTAGE = (NP == 32 || NP == 128) ? 3 : 4;
  static constexpr int OFF_OUT = (NSTAGE * STAGE + 1023) / 1024 * 1024;
  static constexpr int OFF_BAR = OFF_OUT + OUT_BYTES;
  static constexpr int SMEM = OFF_BAR + (2 * NSTAGE + 1) * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

struct DenseArgs {
  const bf16* x[MAX_IN];   // [B, H, W, c_i]
  int c[MAX_IN];           // channels of input i
  int tma[MAX_IN];         // 1: TMA boxes; 0: gathered by the producer
  int n_in;
  int nchunks;             // sum of ceil(c_i / 16); packed: ceil(9 c / 16)
  int packed;              // conv_first: K packed across taps, one "tap"
  const bf16* w;           // prepared [nchunks][taps][NP/8][2][8][8]
  const float* bias;       // [NP], zero past Cout
  const bf16* res;         // [B, H, W, Cout] or null
  void* y;                 // [B, H, W, Cout] bf16 or float32
  int B, H, W, Cout;
  int act;                 // 0 none, 1 LeakyReLU(0.2)
  float res_scale;
  int out_f32;
  int tile_out;            // y leaves through the staged tile and TMA
  int res_tile;            // and the residual comes into it by TMA
};

struct Maps {
  CUtensorMap m[MAX_IN];
};

// K-major A window of 64 pixels: core matrices 8 pixels x 16 B, the next 8
// channels one plane further.
template <int NP>
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return make_desc(addr, Cfg<NP>::PLANE, 128, LAYOUT_INTERLEAVE);
}

// K-major [16 k x NP] weight slice: core matrices [8 n][8 k], the second k
// group 128 B on, the next 8 n 256 B on.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return make_desc(addr, 128, 256, LAYOUT_INTERLEAVE);
}

// Input and first channel (packed: first K index) of chunk ci.
__device__ __forceinline__ void chunk_src(const DenseArgs& a, int ci, int& i,
                                          int& c0) {
  i = 0;
  if (!a.packed) {
    while (ci >= (a.c[i] + KC - 1) / KC) {
      ci -= (a.c[i] + KC - 1) / KC;
      ++i;
    }
  }
  c0 = ci * KC;
}

// The producer warpgroup's gathers, written through the generic proxy.
// Each thread loads GB (pixel, plane) vectors before it stores any, so
// their loads are in flight together (a store between them would order
// them).
constexpr int GB = 4;

union Vec8 {
  uint4 u;
  bf16 h[8];
};

// Channels [c0, c0 + 16) of input i into both planes of a slab.
template <int NP>
__device__ __forceinline__ void gather_slab(unsigned char* st,
                                            const DenseArgs& a, int i, int c0,
                                            int b, int h0, int w0, int ptid) {
  using C = Cfg<NP>;
  const int ci = a.c[i];
  const bf16* __restrict__ x = a.x[i];
  for (int base = ptid; base < C::SPIX * 2; base += 128 * GB) {
    Vec8 v[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + 128 * u;
      const int p = idx >> 1, pl = idx & 1;
      const int hh = h0 - 1 + p / SWID, ww = w0 - 1 + p % SWID;
      const bool in = idx < C::SPIX * 2 && hh >= 0 && hh < a.H && ww >= 0 &&
                      ww < a.W;
      const size_t pix = (static_cast<size_t>(b) * a.H + hh) * a.W + ww;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ch = c0 + 8 * pl + e;
        v[u].h[e] = (in && ch < ci) ? __ldg(x + pix * ci + ch)
                                    : __float2bfloat16(0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + 128 * u;
      if (idx < C::SPIX * 2)
        *reinterpret_cast<uint4*>(st + (idx & 1) * C::PLANE +
                                  (idx >> 1) * 16) = v[u].u;
    }
  }
}

// conv_first: K indices [q0, q0 + 16) of the tile's im2col rows (q = tap *
// c + channel, zero from 9 c), at the slab's centre window; one lane a
// (pixel, plane), the tap and channel stepped without a division a value.
template <int NP>
__device__ __forceinline__ void gather_packed(unsigned char* st,
                                              const DenseArgs& a, int q0,
                                              int b, int h0, int w0,
                                              int ptid) {
  using C = Cfg<NP>;
  constexpr int N = C::TR * TWP * 2;
  const int ci = a.c[0];
  const bf16* __restrict__ x = a.x[0];
  for (int base = ptid; base < N; base += 128 * GB) {
    Vec8 v[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + 128 * u;
      const int p = idx >> 1, pl = idx & 1;
      const int r = p / TWP, col = p % TWP;
      const int q = q0 + 8 * pl;
      int tap = q / ci, ch = q - tap * ci;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int hh = h0 + r + tap / 3 - 1, ww = w0 + col + tap % 3 - 1;
        const bool in = idx < N && tap < 9 && hh >= 0 && hh < a.H &&
                        ww >= 0 && ww < a.W;
        v[u].h[e] = in ? __ldg(x + ((static_cast<size_t>(b) * a.H + hh) *
                                        a.W + ww) * ci + ch)
                       : __float2bfloat16(0.0f);
        if (++ch == ci) {
          ch = 0;
          ++tap;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      const int idx = base + 128 * u;
      const int p = idx >> 1;
      if (idx < N)
        *reinterpret_cast<uint4*>(
            st + (idx & 1) * C::PLANE +
            ((p / TWP + 1) * SWID + p % TWP + 1) * 16) = v[u].u;
    }
  }
}

// The producer warpgroup's 128 threads meet (named barrier 1).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The two consumer warpgroups' 256 threads meet (named barrier 2).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// Byte offset of channel n of pixel px of tile row `row` in the output tile
// as the TMA store reads it: lines of 64 channels (128 B, the 128-byte
// swizzle; NP 128 as two halves of 64) or, at NP 32, of 32 (64 B, the
// 64-byte swizzle), each 16-byte chunk index XORed with the line's address
// bits 7.. as TMA's swizzle does (the tile is 1024-byte aligned).
template <int NP>
__device__ __forceinline__ uint32_t tile_offset(int row, int px, int n) {
  constexpr int LINE = NP == 32 ? 64 : 128;
  constexpr uint32_t M = NP == 32 ? 3 : 7;
  const int half = n >> 6;
  const uint32_t off = half * (Cfg<NP>::TR * TWP * 128) +
                       (row * TWP + px) * LINE + (n & 63) * 2;
  return off ^ (((off >> 7) & M) << 4);
}

__device__ __forceinline__ float residual_add(const DenseArgs& a, float v,
                                              float r) {
  return __fadd_rn(r, __fmul_rn(a.res_scale, v));
}

// One block an SM, walking work items of TR x 64 pixels x NP channels.  See
// the head of this file.
template <int NP>
__global__ void __launch_bounds__(NTHREADS, 1)
    dense_wgmma_kernel(const DenseArgs a, const __grid_constant__ Maps maps,
                       const __grid_constant__ CUtensorMap ymap,
                       const __grid_constant__ CUtensorMap rmap) {
  using C = Cfg<NP>;
  constexpr int MB = C::MB;
  constexpr int NSTAGE = C::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base_s = smem_u32(smem);
  const uint32_t bar_s = base_s + C::OFF_BAR;
  auto full = [&](int s) { return bar_s + 8 * s; };
  auto empty = [&](int s) { return bar_s + 8 * (NSTAGE + s); };
  const uint32_t res_full = bar_s + 8 * (2 * NSTAGE);   // the residual tile

  const int tid = threadIdx.x;
  const int tiles_w = (a.W + TWP - 1) / TWP;
  const int tiles = ((a.H + C::TR - 1) / C::TR) * tiles_w;
  const int nwork = tiles * a.B;
  const int ntaps = a.packed ? 1 : 9;
  const int nchunks = a.nchunks;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NCWARPS);
    }
    mbar_init(res_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as far as the compiler can see (a divergent-looking role
  // branch makes ptxas serialize the wgmmas)
  if (__shfl_sync(0xffffffffu, tid / 32, 0) >= NCWARPS) {
    // ---- producer: thread 0 of the warpgroup issues the copies, all 128
    // gather
    const int ptid = tid - NCONSUMER;
    int nw = 0;
    for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
      const int b = wi / tiles, tile = wi % tiles;
      const int h0 = (tile / tiles_w) * C::TR, w0 = (tile % tiles_w) * TWP;
      for (int ci = 0; ci < nchunks; ++ci) {
        const int s = nw % NSTAGE;
        mbar_wait(empty(s), ((nw / NSTAGE) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE;
        const uint32_t st_s = base_s + s * C::STAGE;
        int i, c0;
        chunk_src(a, ci, i, c0);
        const bool tma = !a.packed && a.tma[i];
        const bool two = c0 + 8 < a.c[i];   // plane 1 holds channels
        if (ptid == 0) {
          const int wbytes = ntaps * C::W_TAP;
          mbar_add_tx(full(s), wbytes + (tma ? (two ? 2 : 1) * C::PLANE_TX
                                             : 0));
          bulk_load(st_s + 2 * C::PLANE,
                    a.w + static_cast<size_t>(ci) * (wbytes / 2), wbytes,
                    full(s));
          if (tma) {
            tma_load_4d(st_s, &maps.m[i], full(s), c0, w0 - 1, h0 - 1, b);
            if (two)
              tma_load_4d(st_s + C::PLANE, &maps.m[i], full(s), c0 + 8,
                          w0 - 1, h0 - 1, b);
          }
        }
        if (a.packed) {
          gather_packed<NP>(st, a, c0, b, h0, w0, ptid);
        } else if (!tma) {
          gather_slab<NP>(st, a, i, c0, b, h0, w0, ptid);
        } else if (!two) {   // the padded half of a width 8 (mod 16)
          for (int j = ptid; j < C::PLANE_TX / 16; j += 128)
            reinterpret_cast<uint4*>(st + C::PLANE)[j] = make_uint4(0, 0, 0,
                                                                    0);
        }
        fence_proxy_async();   // the gathers, before wgmma reads them
        producer_sync();
        if (ptid == 0) mbar_arrive(full(s));
        ++nw;
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, each MB tile rows x NP
  const int ctid = tid, wg = ctid >> 7, wl = (ctid >> 5) & 3;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  float acc[MB][NP / 2];
  int nw = 0, nres = 0;
  for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
    const int b = wi / tiles, tile = wi % tiles;
    const int h0 = (tile / tiles_w) * C::TR, w0 = (tile % tiles_w) * TWP;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) acc[mb][q] = 0.0f;
    fence_operands<MB * NP / 2>(&acc[0][0]);

    int prev = 0;
#pragma unroll 1
    for (int ci = 0; ci < nchunks; ++ci) {
      const int s = nw % NSTAGE;
      mbar_wait(full(s), (nw / NSTAGE) & 1);
      const uint32_t st = base_s + s * C::STAGE;
      wgmma_fence();
#pragma unroll 1
      for (int tap = 0; tap < ntaps; ++tap) {
        // packed: the one "tap" is the centre window
        const int di = a.packed ? 1 : tap / 3, dj = a.packed ? 1 : tap % 3;
        const uint64_t db = b_desc(st + 2 * C::PLANE + tap * C::W_TAP);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          wgmma_ss<NP, 0>(acc[mb],
                          a_desc<NP>(st + ((wg * MB + mb + di) * SWID + dj) *
                                              16),
                          db);
      }
      wgmma_commit();
      if (C::TILE_OUT && a.res_tile && ci == 0 && ctid == 0) {
        // this item's residual into the output tile, landing while the
        // item multiplies, once the previous item's store has read it
        bulk_wait_read();
        mbar_expect_tx(res_full, C::OUT_BYTES);
#pragma unroll
        for (int half = 0; half < (NP > 64 ? 2 : 1); ++half)
          tma_load_4d(base_s + C::OFF_OUT + half * (C::OUT_BYTES / 2), &rmap,
                      res_full, 64 * half, w0, h0, b);
      }
      // keep this chunk's group in flight; the previous chunk's is done
      wgmma_wait<1>();
      if (ci > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      ++nw;
    }
    wgmma_wait<0>();
    fence_operands<MB * NP / 2>(&acc[0][0]);
    if (lane == 0) mbar_arrive(empty(prev));

    // ---- epilogue: + bias and LeakyReLU in place, in straight-line code
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) {
        float v = __fadd_rn(acc[mb][q], a.bias[8 * (q / 4) + 2 * t + q % 2]);
        if (a.act) v = v >= 0.0f ? v : __fmul_rn(0.2f, v);
        acc[mb][q] = v;
      }
    fence_operands<MB * NP / 2>(&acc[0][0]);
    if constexpr (C::TILE_OUT) {
      if (a.tile_out) {
        // the residual added into the staged tile, then one TMA store that
        // runs on while the next item multiplies (it clips rows past H or
        // W); its previous store must have read the tile first
        unsigned char* tile = smem + C::OFF_OUT;
        if (a.res_tile) {
          mbar_wait(res_full, nres & 1);
          ++nres;
        } else {
          if (ctid == 0) bulk_wait_read();
          consumer_sync();
        }
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = wg * MB + mb, px = 16 * wl + g + 8 * i;
            const int hh = h0 + row, ww = w0 + px;
            const bool in = hh < a.H && ww < a.W;
            const size_t o =
                ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * a.Cout;
#pragma unroll
            for (int j = 0; j < NP / 8; ++j) {
              const int n = 8 * j + 2 * t;
              float v0 = acc[mb][4 * j + 2 * i];
              float v1 = acc[mb][4 * j + 2 * i + 1];
              __nv_bfloat162* yt = reinterpret_cast<__nv_bfloat162*>(
                  tile + tile_offset<NP>(row, px, n));
              if (a.res_tile || (a.res != nullptr && in)) {
                const float2 r = __bfloat1622float2(
                    a.res_tile ? *yt
                               : *reinterpret_cast<const __nv_bfloat162*>(
                                     a.res + o + n));
                v0 = residual_add(a, v0, r.x);
                v1 = residual_add(a, v1, r.y);
              }
              *yt = __floats2bfloat162_rn(v0, v1);
            }
          }
        fence_proxy_async();   // the tile, before the TMA store reads it
        consumer_sync();
        if (ctid == 0) {
          const uint32_t tile_s = base_s + C::OFF_OUT;
#pragma unroll
          for (int half = 0; half < (NP > 64 ? 2 : 1); ++half)
            tma_store_4d(&ymap, tile_s + half * (C::OUT_BYTES / 2),
                         64 * half, w0, h0, b);
          bulk_commit();
        }
        continue;
      }
    }
    // else from the fragments: thread rows (mb, i), columns 8 j + 2 t (+ 1)
    const bool pairs = (a.Cout & 1) == 0;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = h0 + wg * MB + mb, ww = w0 + 16 * wl + g + 8 * i;
        if (hh >= a.H || ww >= a.W) continue;
        const size_t o =
            ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * a.Cout;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int n = 8 * j + 2 * t;
          float v0 = acc[mb][4 * j + 2 * i], v1 = acc[mb][4 * j + 2 * i + 1];
          if (pairs) {
            if (n < a.Cout) {
              if (a.res != nullptr) {
                const float2 r = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(a.res + o + n));
                v0 = residual_add(a, v0, r.x);
                v1 = residual_add(a, v1, r.y);
              }
              if (a.out_f32)
                *reinterpret_cast<float2*>(static_cast<float*>(a.y) + o + n) =
                    make_float2(v0, v1);
              else
                *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.y) +
                                                   o + n) =
                    __floats2bfloat162_rn(v0, v1);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e < a.Cout) {
                float v = e ? v1 : v0;
                if (a.res != nullptr)
                  v = residual_add(a, v, __bfloat162float(a.res[o + n + e]));
                if (a.out_f32)
                  static_cast<float*>(a.y)[o + n + e] = v;
                else
                  static_cast<bf16*>(a.y)[o + n + e] = __float2bfloat16(v);
              }
            }
          }
        }
      }
  }
  // the last TMA store is done before the block's shared memory goes
  if (C::TILE_OUT && a.tile_out && ctid == 0) bulk_wait();
}

constexpr int MAX_DEV = 64;

// The SM count of `dev`, read once (the launch path is host-bound at the
// chain's small shapes).
int sm_count(int dev) {
  static int sms[MAX_DEV] = {};
  if (dev >= MAX_DEV) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int NP>
int launch(const DenseArgs& a, const Maps& maps, const CUtensorMap& ymap,
           const CUtensorMap& rmap, cudaStream_t stream) {
  using C = Cfg<NP>;
  int dev = 0;
  cudaGetDevice(&dev);
  static bool attr[MAX_DEV] = {};   // the shared-memory opt-in, per device
  if (dev >= MAX_DEV || !attr[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_wgmma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < MAX_DEV) attr[dev] = true;
  }
  // persistent: one block an SM walks the work items
  const int sms = sm_count(dev);
  const int nwork = ((a.H + C::TR - 1) / C::TR) * ((a.W + TWP - 1) / TWP) *
                    a.B;
  dense_wgmma_kernel<NP><<<nwork < sms ? nwork : sms, NTHREADS, C::SMEM,
                           stream>>>(a, maps, ymap, rmap);
  return static_cast<int>(cudaGetLastError());
}

// Each TMA input's map: x [B, H, W, c] with a box of one 8-channel plane of
// the slab [TR + 2 rows x 66 pixels].
template <int NP>
int make_maps(DenseArgs& a, Maps& maps) {
  for (int i = 0; i < a.n_in; ++i) {
    if (!a.tma[i]) continue;
    const uint64_t dims[4] = {uint64_t(a.c[i]), uint64_t(a.W), uint64_t(a.H),
                              uint64_t(a.B)};
    const uint32_t box[4] = {8, SWID, Cfg<NP>::TR + 2, 1};
    if (make_map(&maps.m[i], a.x[i], 4, dims, box,
                 CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
      a.tma[i] = 0;   // the producer gathers it instead
  }
  return 0;
}

// The maps of y (the TMA store of the output tile) and of the residual
// (its TMA load into the tile), where they apply: bf16 out, Cout = NP >= 32,
// 16-byte aligned; a box of one 64-channel half (32 at NP 32) of [TR rows x
// 64 pixels], swizzled as tile_offset writes it.
template <int NP>
void make_tile_maps(DenseArgs& a, CUtensorMap& ymap, CUtensorMap& rmap) {
  a.tile_out = Cfg<NP>::TILE_OUT && !a.out_f32 && a.Cout == NP &&
               reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  a.res_tile = 0;
  if (!a.tile_out) return;
  const uint64_t dims[4] = {uint64_t(a.Cout), uint64_t(a.W), uint64_t(a.H),
                            uint64_t(a.B)};
  const uint32_t box[4] = {NP == 32 ? 32u : 64u, TWP, Cfg<NP>::TR, 1};
  const CUtensorMapSwizzle sw = NP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_128B;
  if (make_map(&ymap, a.y, 4, dims, box, sw) != 0) {
    a.tile_out = 0;   // the consumers store from the fragments instead
    return;
  }
  a.res_tile = a.res != nullptr &&
               reinterpret_cast<uintptr_t>(a.res) % 16 == 0 &&
               make_map(&rmap, a.res, 4, dims, box, sw) == 0;
}

template <int NP>
int run(DenseArgs& a, cudaStream_t stream) {
  Maps maps = {};
  CUtensorMap ymap = {}, rmap = {};
  make_maps<NP>(a, maps);
  make_tile_maps<NP>(a, ymap, rmap);
  return launch<NP>(a, maps, ymap, rmap, stream);
}

}  // namespace

extern "C" {

// x0..x4 [B,H,W,c_i] bf16 (the first n_in used); w the prepared weights
// [nchunks][taps][NP/8][2][8][8] bf16 (kernels/dense_conv.py
// `prepare_weights`: NP the smallest of 8, 16, 32, 64, 128 >= Cout; packed
// = 1 for one input narrower than 16 channels, its K packed across taps,
// one tap); bias [NP] f32, zero past Cout; res [B,H,W,Cout] bf16 or null;
// y [B,H,W,Cout] bf16 (out_f32 = 0) or f32.  Returns cudaErrorInvalidValue
// for n_in outside 1..5, Cout outside 1..NP, an NP not in that set, a
// zero-channel input or a packing the inputs do not allow.
int hdrvae_dense_conv3x3(const void* x0, const void* x1, const void* x2,
                         const void* x3, const void* x4, int c0, int c1,
                         int c2, int c3, int c4, int n_in, const void* w,
                         const void* bias, const void* res, void* y, int B,
                         int H, int W, int Cout, int np, int packed, int act,
                         float res_scale, int out_f32, void* stream) {
  const void* xs[MAX_IN] = {x0, x1, x2, x3, x4};
  const int cs[MAX_IN] = {c0, c1, c2, c3, c4};
  const bool np_ok = np == 8 || np == 16 || np == 32 || np == 64 || np == 128;
  if (n_in < 1 || n_in > MAX_IN || Cout < 1 || !np_ok || Cout > np ||
      (packed && (n_in != 1 || c0 >= KC)))
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs a = {};
  for (int i = 0; i < n_in; ++i) {
    if (cs[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.x[i] = static_cast<const bf16*>(xs[i]);
    a.c[i] = cs[i];
    a.tma[i] = !packed && cs[i] % 8 == 0 &&
               reinterpret_cast<uintptr_t>(xs[i]) % 16 == 0;
    a.nchunks += (cs[i] + KC - 1) / KC;
  }
  if (packed) a.nchunks = (9 * c0 + KC - 1) / KC;
  a.n_in = n_in;
  a.packed = packed;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.y = y;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.act = act;
  a.res_scale = res_scale;
  a.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 8: return run<8>(a, s);
    case 16: return run<16>(a, s);
    case 32: return run<32>(a, s);
    case 64: return run<64>(a, s);
    default: return run<128>(a, s);
  }
}

}  // extern "C"
