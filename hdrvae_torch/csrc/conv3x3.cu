// The decoder's 3x3 convolutions as implicit GEMMs on Hopper's tensor cores
// (bf16 operands, float32 accumulation), with the decoder's fusions.
//
// Replaces two TPU kernels of the JAX package:
//   K1  hdrvae/kernels/conv3x3.py::fused_conv3x3
//       y = conv3x3_SAME(silu(x * gamma + beta)) + bias [+ r | + r @ Wr]
//       and the per-group (sum, sumsq) of y as stored, for the next
//       GroupNorm.
//   K2  hdrvae/kernels/conv3x3.py::upsample_conv3x3
//       y = act(conv3x3_SAME(nearest2x(x)) + bias) through the 2x2 phase
//       decomposition: each output phase (a, b) is a 2x2 conv of the
//       low-resolution map with pre-summed weights, so the upsampled map is
//       never written to memory and the MACs drop 2.25x.
//
// What bounds it on the H100: at the decoder's shapes (Cin, Cout of
// 128..512) a conv does 2*9*Cin flops per output value against a few bytes
// moved, far above the card's ~295 flops/byte ridge, so the bound is the
// tensor-core rate, which only wgmma reaches.
//
// Design: one warp-specialized implicit-GEMM mainloop for both kernels.
//  * GEMM view: M = output pixels, N = Cout, K = taps x Cin (+ Cr for the
//    nin_shortcut).  A work item is a tile of TR = 4 image rows x TWP = 64
//    pixels (K2: of the low-resolution map, for one output phase) and BN =
//    128 output channels (64 when Cout % 128 != 0).  The grid is
//    persistent: one block an SM walks the work items, so the next item's
//    copies overlap this one's epilogue.
//  * 288 threads: two consumer warpgroups, each owning two tile rows (two
//    m64 blocks, each one contiguous run of 64 pixels), and a producer warp
//    of which one thread issues every copy by TMA, each completing on an
//    mbarrier; the consumers hand slots back through "empty" mbarriers.
//  * K runs in chunks of BK = 64 input channels.  Per chunk TMA brings the
//    halo'd slab [(TR+2) x (TWP+2) pixels x 64 channels] into one of two
//    slab buffers (4-D box at (c0, w0-1, h0-1, b): pixels outside the image
//    and channels past Cin arrive as zeros), then each tap's 64 x BN weight
//    slice, read from the HWIO tensor as it is (no repack), into a ring of
//    NSTAGE stages.  Both use the 128-byte swizzle.  The next chunk's slab
//    is issued after this chunk's first weight slices, so it lands while
//    this one multiplies.
//  * The GroupNorm affine + SiLU prologue runs once per chunk, in place on
//    the slab, rounded to bf16 and only on in-image pixels (masked by
//    coordinate: a TMA zero is a zero before the prologue, and the SAME
//    zeros must stay zeros of the normalized activation).  For every chunk
//    but a work item's first it runs in slices while taps PRO_TAP.. of the
//    previous chunk multiply.
//  * Both operands from shared memory: the taps (9; 4 per phase for K2) are
//    shifted 64-pixel windows of the slab, each an A descriptor (K-major,
//    128-byte swizzle, any pixel start); B is the weight slice, MN-major.
//    wgmma m64n128k16 (m64n64k16 at BN 64), one commit group a tap, one
//    group left in flight while the next tap issues.  A from registers
//    (ldmatrix) was the first design: it held 160 accumulator and fragment
//    registers, ptxas serialized its wgmmas for want of registers, and every
//    tap had to wait for its own group: K1 took 14.1 ms over the decode's
//    six convs against 9.5 on an H100 80GB HBM3 at 700 W.
//  * The nin_shortcut projection r @ Wr runs as extra one-tap chunks through
//    the same ring (r loaded with the slab's halo'd geometry, so its tile
//    pixels sit at the centre window); its bias is folded into `bias` by
//    the caller.
//  * Epilogue from the accumulators: bias and the residual (K1) or K2's
//    LeakyReLU applied in float32, rounded to bf16, stored.  An identity
//    residual is read by the thread that then writes that element, so y may
//    be the residual's own storage (res and y carry no __restrict__).
//    Statistics of y as stored (after the rounding): a shuffle reduction
//    per column over the warp's rows, per-warp partials in shared memory,
//    a fixed-order sum over the eight warps into
//    per-tile partials [B, T, 2, Cout] that hdrvae_group_stats reduces in a
//    fixed order.  No atomics, so K2's stats_only mode (y null, the same
//    code with the store predicated off) gives sums bit-equal to the launch
//    that writes y.
//  * owned_rows (both kernels, K2 in both modes; JAX conv3x3.py:368-372,
//    :692): the statistics count only output rows [own_lo, own_hi), the
//    rows a slab shard owns, so a sum over the shards is the whole image's;
//    y is stored as without it.  The bounds are launch arguments and the
//    test is one compare per accumulator row, so a tile that straddles a
//    bound counts exactly its owned rows.  K2's phase a carries
//    low-resolution row i to output row 2 i + a.
//  * K2's phases are separate work items, neighbours in the walk: a slab of
//    all Cin channels, which would let one block run the four phases
//    against one load, does not fit in shared memory (405 KB at Cin 512),
//    so each phase reads its slab chunks, from L2 after the first, and the
//    128^2 decode level gets four times the work items (64 -> 256).

#include <cuda_bf16.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int TR = 4;                    // tile rows
constexpr int TWP = 64;                  // tile pixels a row (one m64 block)
constexpr int SROWS = TR + 2;            // slab rows (1-pixel halo)
constexpr int SWID = TWP + 2;            // slab pixels a row
constexpr int SPIX = SROWS * SWID;       // 396 slab pixels
constexpr int BK = 64;                   // input channels a chunk (128 B)
constexpr int NSTAGE = 6;                // weight ring stages
constexpr int NCONSUMER = 256;           // two warpgroups
constexpr int NTHREADS = NCONSUMER + 32; // + the producer warp
constexpr int NCWARPS = NCONSUMER / 32;
constexpr int PRO_TAP = 3;               // K1: the first tap that hides a
                                         // slice of the next prologue

constexpr int SLAB_BYTES = 51200;        // SPIX * 128 = 50,688, 1 KB aligned
constexpr int STAGE_BYTES = 16384;       // 64 x 128 bf16
constexpr int HALF_BYTES = 8192;         // one 64-channel half of a stage
constexpr int RED_BYTES = NCWARPS * 2 * 128 * 4;
constexpr int OFF_RING = 2 * SLAB_BYTES;
constexpr int OFF_RED = OFF_RING + NSTAGE * STAGE_BYTES;
constexpr int OFF_BAR = OFF_RED + RED_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + (4 + 2 * NSTAGE) * 8 + 1024;
static_assert(SPIX * 128 <= SLAB_BYTES, "slab");
static_assert(SMEM_BYTES <= 232448, "shared memory");

enum { MODE_CONV = 0, MODE_UP = 1 };
enum { RES_NONE = 0, RES_ADD = 1, RES_PROJ = 2 };

__device__ __forceinline__ float silu(float z) {
  return z * (1.0f / (1.0f + expf(-z)));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONSUMER) : "memory");
}

// wgmma descriptor of a K-major 64-row A window of the slab: rows are
// pixels of 128 B (64 channels) with the 128-byte swizzle, which the
// hardware applies to the address bits (as TMA wrote them), so a window may
// start at any pixel with a base offset of 0.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return make_desc(addr, 16, 1024, LAYOUT_B128);
}

// wgmma descriptor of a weight slice [64 k][64 or 128 n], stored N-major
// with the 128-byte swizzle as TMA writes it: the leading offset is the
// 8 KB between the two 64-channel MN atoms, the stride the 1 KB between
// groups of 8 k rows.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return make_desc(addr, HALF_BYTES, 1024, LAYOUT_B128);
}

struct ConvArgs {
  const bf16* x;        // [B, H, W, Cin]
  const bf16* w;        // [3,3,Cin,Cout] (K1) or [2,2,2,2,Cin,Cout] (K2)
  const float* bias;    // [Cout]
  const float* gamma;   // [B, Cin] or null (K1's prologue)
  const float* beta;
  const bf16* res;      // [B, H, W, Cr] or null
  const bf16* res_w;    // [Cr, Cout] or null
  bf16* y;              // [B, Ho, Wo, Cout], or null (K2 stats_only)
  float* partial;       // [B, T, 2, Cout] or null
  int B, H, W, Cin, Cout, Cr, res_mode;
  int act;              // K2: 0 none, 1 LeakyReLU(0.2) before the rounding
  int own_lo, own_hi;   // statistics over output rows [own_lo, own_hi) only
};

// GroupNorm affine + SiLU, rounded to bf16, in place on the slab's
// in-image pixels and real channels (zero-filled ones stay zero); slice
// `part` of `parts` of the slab's 16-byte vectors.
__device__ __forceinline__ void prologue_chunk(unsigned char* slab,
                                               const ConvArgs& a, int b,
                                               int h0, int w0, int c0,
                                               int ctid, int part,
                                               int parts) {
  for (int idx = ctid + part * NCONSUMER; idx < SPIX * 8;
       idx += NCONSUMER * parts) {
    const int p = idx >> 3, j = idx & 7, c = c0 + 8 * j;
    const int hh = h0 - 1 + p / SWID, ww = w0 - 1 + p % SWID;
    if (c >= a.Cin || hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) continue;
    uint4* ptr = reinterpret_cast<uint4*>(slab + p * 128 +
                                          ((j ^ (p & 7)) << 4));
    uint4 v = *ptr;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
    const float4* g = reinterpret_cast<const float4*>(
        a.gamma + static_cast<size_t>(b) * a.Cin + c);
    const float4* bt = reinterpret_cast<const float4*>(
        a.beta + static_cast<size_t>(b) * a.Cin + c);
    const float4 g0 = g[0], g1 = g[1], b0 = bt[0], b1 = bt[1];
    const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(e[k]);
      e[k] = __floats2bfloat162_rn(silu(f.x * gs[2 * k] + bs[2 * k]),
                                   silu(f.y * gs[2 * k + 1] + bs[2 * k + 1]));
    }
    *ptr = v;
  }
}

// One block an SM, walking work items of a TR x TWP pixel tile and BN = 64 *
// NH output channels; K1 one pass, K2 one pass per output phase.  See the
// head of this file.
template <int MODE, int NH>
__global__ void __launch_bounds__(NTHREADS, 1) conv_wgmma_kernel(
    const ConvArgs a, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap rmap,
    const __grid_constant__ CUtensorMap rwmap) {
  constexpr int BN = 64 * NH;
  constexpr int NPH = (MODE == MODE_UP) ? 4 : 1;   // output phases
  constexpr int NTAPS = (MODE == MODE_UP) ? 4 : 9;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base_s = smem_u32(smem);
  const uint32_t ring_s = base_s + OFF_RING;
  float* red = reinterpret_cast<float*>(smem + OFF_RED);
  const uint32_t bar_s = base_s + OFF_BAR;
  // barriers: slab full [0,2), slab empty [2,4), ring full, ring empty
  auto slab_full = [&](int i) { return bar_s + 8 * i; };
  auto slab_empty = [&](int i) { return bar_s + 8 * (2 + i); };
  auto w_full = [&](int s) { return bar_s + 8 * (4 + s); };
  auto w_empty = [&](int s) { return bar_s + 8 * (4 + NSTAGE + s); };

  const int tid = threadIdx.x;
  const int tiles_w = (a.W + TWP - 1) / TWP;
  const int tiles = ((a.H + TR - 1) / TR) * tiles_w;
  const int nblk = a.Cout / BN;
  const int nwork = tiles * NPH * nblk * a.B;
  // work item -> (output-channel block, K2's phase, tile, sample); the items
  // of one tile are neighbours, so its slabs are read from L2 after the
  // first
  struct Work { int tile, ph, h0, w0, n0, b; };
  auto work = [&](int wi) {
    Work r;
    r.n0 = (wi % nblk) * BN;
    r.ph = (wi / nblk) % NPH;
    r.tile = (wi / nblk / NPH) % tiles;
    r.b = wi / nblk / NPH / tiles;
    r.h0 = (r.tile / tiles_w) * TR;
    r.w0 = (r.tile % tiles_w) * TWP;
    return r;
  };
  const int nmain = (a.Cin + BK - 1) / BK;
  const int nproj = (MODE == MODE_CONV && a.res_mode == RES_PROJ)
                        ? (a.Cr + BK - 1) / BK : 0;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(slab_full(i), 1);
      mbar_init(slab_empty(i), NCWARPS);
    }
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), NCWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as far as the compiler can see (a divergent-looking role
  // branch makes ptxas serialize the wgmmas)
  if (__shfl_sync(0xffffffffu, tid / 32, 0) >= NCWARPS) {
    // ---- producer: one thread issues every TMA copy, in the consumers'
    // order.  The slab of chunk i + 1 is issued after chunk i's first three
    // weight slices, so it lands while chunk i multiplies (K1 runs its
    // prologue then).
    if (tid != NCONSUMER) return;
    const int nchunks = nmain + nproj;
    int nslab = 0, nw = 0;
    auto issue_slab = [&](const Work& wk, int ci) {   // into buffer nslab % 2
      const bool proj = ci >= nmain;
      const int buf = nslab & 1;
      mbar_wait(slab_empty(buf), ((nslab >> 1) & 1) ^ 1);
      mbar_expect_tx(slab_full(buf), SPIX * 128);
      // the residual of a projection chunk comes with the same halo'd
      // geometry, so its tile pixels sit at the slab's centre window
      tma_load_4d(base_s + buf * SLAB_BYTES, proj ? &rmap : &xmap,
                  slab_full(buf), (proj ? ci - nmain : ci) * BK, wk.w0 - 1,
                  wk.h0 - 1, wk.b);
      ++nslab;
    };
    if (blockIdx.x < nwork) issue_slab(work(blockIdx.x), 0);
    for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
      const Work wk = work(wi);
      for (int ci = 0; ci < nchunks; ++ci) {
        const bool proj = ci >= nmain;
        const int c0 = (proj ? ci - nmain : ci) * BK;
        const int ntaps = proj ? 1 : NTAPS;
        for (int tap = 0; tap < ntaps; ++tap) {
          const int s = nw % NSTAGE;
          mbar_wait(w_empty(s), ((nw / NSTAGE) & 1) ^ 1);
          mbar_expect_tx(w_full(s), NH * HALF_BYTES);
          const int wtap = proj ? 0 : (MODE == MODE_UP) ? wk.ph * 4 + tap : tap;
#pragma unroll
          for (int nh = 0; nh < NH; ++nh)
            tma_load_3d(ring_s + s * STAGE_BYTES + nh * HALF_BYTES,
                        proj ? &rwmap : &wmap, w_full(s), wk.n0 + 64 * nh,
                        c0, wtap);
          ++nw;
          if (tap == (ntaps < 3 ? ntaps - 1 : 2)) {   // the next slab
            if (ci + 1 < nchunks)
              issue_slab(wk, ci + 1);
            else if (wi + gridDim.x < nwork)
              issue_slab(work(wi + gridDim.x), 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, each two tile rows x BN ----
  const int ctid = tid, cw = ctid >> 5, wg = ctid >> 7, wl = cw & 3;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const bool prologue = MODE == MODE_CONV && a.gamma != nullptr;
  float acc[2][NH * 32];
  int ns = 0, nw = 0;
  for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
    const Work wk = work(wi);
    const int tile = wk.tile, h0 = wk.h0, w0 = wk.w0, n0 = wk.n0, b = wk.b;
    const int ph = wk.ph, pa = ph >> 1, pb = ph & 1;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int q = 0; q < NH * 32; ++q) acc[mb][q] = 0.0f;

#pragma unroll 1
    for (int ci = 0; ci < nmain + nproj; ++ci) {
      const bool proj = ci >= nmain;
      const int c0 = (proj ? ci - nmain : ci) * BK;
      const int buf = ns & 1;
      mbar_wait(slab_full(buf), (ns >> 1) & 1);
      if (prologue && ci == 0)   // later chunks' ran during their previous
        prologue_chunk(smem + buf * SLAB_BYTES, a, b, h0, w0, c0, ctid, 0, 1);
      const bool early = prologue && ci + 1 < nmain;
      // the prologue's generic writes, before wgmma reads the slab
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync();   // the slab (and its prologue) is complete
      int prev_s = 0;
      const uint32_t slab_s = base_s + buf * SLAB_BYTES;
      const int ntaps = proj ? 1 : NTAPS;
#pragma unroll 1
      for (int tap = 0; tap < ntaps; ++tap) {
        int di, dj;
        if (proj) {
          di = 1; dj = 1;
        } else if (MODE == MODE_UP) {
          di = pa + (tap >> 1); dj = pb + (tap & 1);
        } else {
          di = tap / 3; dj = tap % 3;
        }
        const int s = nw % NSTAGE;
        mbar_wait(w_full(s), (nw / NSTAGE) & 1);
        const uint32_t st = ring_s + s * STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            const uint64_t da = a_desc(
                slab_s + ((2 * wg + mb + di) * SWID + dj) * 128 +
                ks * 32);
            wgmma_ss<BN, 1>(acc[mb], da, b_desc(st + ks * 2048));
          }
        wgmma_commit();
        if (early && tap >= PRO_TAP) {
          // a slice of the next chunk's prologue, on the other slab buffer,
          // while this tap multiplies
          if (tap == PRO_TAP)
            mbar_wait(slab_full(buf ^ 1), ((ns + 1) >> 1) & 1);
          prologue_chunk(smem + (buf ^ 1) * SLAB_BYTES, a, b, h0, w0,
                         c0 + BK, ctid, tap - PRO_TAP, NTAPS - PRO_TAP);
        }
        // keep this tap's group in flight; the previous tap's is done
        wgmma_wait<1>();
        if (tap > 0 && lane == 0) mbar_arrive(w_empty(prev_s));
        prev_s = s;
        ++nw;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(w_empty(prev_s));
      // the prologue wrote the slab through the generic proxy; order that
      // before the next TMA write into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(slab_empty(buf));
      ++ns;
    }

    // ---- epilogue: bias (+ residual) in float32, bf16 store, statistics
    const int Ho = (MODE == MODE_UP) ? 2 * a.H : a.H;
    const int Wo = (MODE == MODE_UP) ? 2 * a.W : a.W;
    // this thread's pixels: rows (mb, i) of its m64 blocks
    size_t orow[2][2];
    bool ok[2][2], own[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int hh = h0 + 2 * wg + mb, ww = w0 + 16 * wl + g + 8 * i;
        const int oh = (MODE == MODE_UP) ? 2 * hh + pa : hh;
        const int ow = (MODE == MODE_UP) ? 2 * ww + pb : ww;
        ok[mb][i] = hh < a.H && ww < a.W;
        // counted in the statistics: the owned output rows (K2's phase a
        // puts low-resolution row hh at output row 2 hh + a)
        own[mb][i] = ok[mb][i] && oh >= a.own_lo && oh < a.own_hi;
        orow[mb][i] =
            ((static_cast<size_t>(b) * Ho + oh) * Wo + ow) * a.Cout + n0;
      }
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      // the residual of this channel half, all loads issued together
      __nv_bfloat162 rr[2][2][8];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            rr[mb][i][j] =
                (MODE == MODE_CONV && a.res_mode == RES_ADD && ok[mb][i])
                    ? *reinterpret_cast<const __nv_bfloat162*>(
                          a.res + orow[mb][i] + nh * 64 + 8 * j + 2 * t)
                    : __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nh * 64 + 8 * j + 2 * t;
        const float b0 = a.bias[n0 + n], b1 = a.bias[n0 + n + 1];
        float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (ok[mb][i]) {
              const size_t o = orow[mb][i] + n;
              float v0 = acc[mb][nh * 32 + 4 * j + 2 * i] + b0;
              float v1 = acc[mb][nh * 32 + 4 * j + 2 * i + 1] + b1;
              if (MODE == MODE_UP && a.act) {
                v0 = v0 >= 0.0f ? v0 : __fmul_rn(0.2f, v0);
                v1 = v1 >= 0.0f ? v1 : __fmul_rn(0.2f, v1);
              }
              if (MODE == MODE_CONV && a.res_mode == RES_ADD) {
                v0 += __low2float(rr[mb][i][j]);
                v1 += __high2float(rr[mb][i][j]);
              }
              const __nv_bfloat162 yb = __floats2bfloat162_rn(v0, v1);
              if (a.y != nullptr)   // K2 stats_only: no y at all
                *reinterpret_cast<__nv_bfloat162*>(a.y + o) = yb;
              v0 = __low2float(yb);   // statistics of y as stored
              v1 = __high2float(yb);
              if (own[mb][i]) {
                s0 += v0; s1 += v1; q0 += v0 * v0; q1 += v1 * v1;
              }
            }
          }
        if (a.partial != nullptr) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            q0 += __shfl_xor_sync(0xffffffffu, q0, off);
            q1 += __shfl_xor_sync(0xffffffffu, q1, off);
          }
          if (g == 0) {
            red[(cw * 2) * 128 + n] = s0;
            red[(cw * 2) * 128 + n + 1] = s1;
            red[(cw * 2 + 1) * 128 + n] = q0;
            red[(cw * 2 + 1) * 128 + n + 1] = q1;
          }
        }
      }
    }
    if (a.partial != nullptr) {
      consumer_sync();
      if (ctid < 2 * BN) {
        const int ch = ctid % BN, sq = ctid / BN;
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < NCWARPS; ++k) v += red[(k * 2 + sq) * 128 + ch];
        const int T = tiles * NPH;
        const int tt = (MODE == MODE_UP) ? tile * 4 + ph : tile;
        a.partial[((static_cast<size_t>(b) * T + tt) * 2 + sq) * a.Cout +
                  n0 + ch] = v;
      }
      consumer_sync();   // red is free for the next work item
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

// Maps of x [B,H,W,Cin] (the halo'd slab box), the weights [taps,Cin,Cout]
// (a 64 x 64 slice), and for a projection r [B,H,W,Cr] and Wr [Cr,Cout].
template <int MODE, int NH>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const int taps = (MODE == MODE_UP) ? 16 : 9;
  CUtensorMap xmap, wmap, rmap, rwmap;
  const uint32_t slab_box[4] = {BK, SWID, SROWS, 1};
  const uint32_t w_box[3] = {64, BK, 1};
  const uint64_t xd[4] = {uint64_t(a.Cin), uint64_t(a.W), uint64_t(a.H),
                          uint64_t(a.B)};
  const uint64_t wd[3] = {uint64_t(a.Cout), uint64_t(a.Cin),
                          uint64_t(taps)};
  int err = make_map(&xmap, a.x, 4, xd, slab_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&wmap, a.w, 3, wd, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  rmap = xmap;
  rwmap = wmap;
  if (err == 0 && a.res_mode == RES_PROJ) {
    const uint64_t rd[4] = {uint64_t(a.Cr), uint64_t(a.W), uint64_t(a.H),
                            uint64_t(a.B)};
    const uint64_t rwd[3] = {uint64_t(a.Cout), uint64_t(a.Cr), 1};
    err = make_map(&rmap, a.res, 4, rd, slab_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = make_map(&rwmap, a.res_w, 3, rwd, w_box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      conv_wgmma_kernel<MODE, NH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nwork = ((a.H + TR - 1) / TR) * ((a.W + TWP - 1) / TWP) *
                    (MODE == MODE_UP ? 4 : 1) * (a.Cout / (64 * NH)) * a.B;
  const dim3 grid(nwork < sms ? nwork : sms);
  conv_wgmma_kernel<MODE, NH><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      a, xmap, wmap, rmap, rwmap);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_n(const ConvArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.Cout % 128 == 0 ? launch<MODE, 2>(a, s) : launch<MODE, 1>(a, s);
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16; w [3,3,Cin,Cout] bf16 (HWIO); bias [Cout] f32;
// gamma/beta [B,Cin] f32 or null; res [B,H,W,Cr] bf16 or null; res_w
// [Cr,Cout] bf16 or null; y [B,H,W,Cout] bf16; partial [B,T,2,Cout] f32 or
// null, T = ceil(H/4) * ceil(W/64).  Cin, Cr % 16 == 0, Cout % 64 == 0.
// The partials count rows [own_lo, own_hi) of y only (0, INT_MAX: all).
int hdrvae_fused_conv3x3(const void* x, const void* w, const void* bias,
                         const void* gamma, const void* beta, const void* res,
                         const void* res_w, void* y, void* partial, int B,
                         int H, int W, int Cin, int Cout, int Cr,
                         int res_mode, int own_lo, int own_hi,
                         void* stream) {
  const ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<const float*>(bias),
                   static_cast<const float*>(gamma),
                   static_cast<const float*>(beta),
                   static_cast<const bf16*>(res),
                   static_cast<const bf16*>(res_w), static_cast<bf16*>(y),
                   static_cast<float*>(partial), B, H, W, Cin, Cout, Cr,
                   res_mode, 0, own_lo, own_hi};
  return launch_n<MODE_CONV>(a, stream);
}

// x [B,H,W,Cin] bf16; pw [2,2,2,2,Cin,Cout] bf16 phase weights (a,b,u,v);
// bias [Cout] f32; y [B,2H,2W,Cout] bf16, or null (stats_only: partial
// must then be given); partial [B,4T,2,Cout] f32 or null; act 0 none, 1
// LeakyReLU(0.2) after the bias (the statistics are of y after it, as
// stored); the partials count rows [own_lo, own_hi) of y only (0,
// INT_MAX: all).
int hdrvae_upsample_conv3x3(const void* x, const void* pw, const void* bias,
                            void* y, void* partial, int B, int H, int W,
                            int Cin, int Cout, int act, int own_lo,
                            int own_hi, void* stream) {
  const ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(pw),
                   static_cast<const float*>(bias), nullptr, nullptr,
                   nullptr, nullptr, static_cast<bf16*>(y),
                   static_cast<float*>(partial), B, H, W, Cin, Cout, 0,
                   RES_NONE, act, own_lo, own_hi};
  return launch_n<MODE_UP>(a, stream);
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
