// The decoder's streaming top-level junction as one kernel on Hopper's
// tensor cores (bf16 operands, float32 accumulation):
//
//   y = conv3x3_SAME(band) + bias,
//   band = bf16(silu(bf16(conv3x3_SAME(nearest2x(x)) + up_bias) * gamma
//                    + beta)), zero outside the image,
//
// and the per-channel (sum, sumsq) partials of y as stored, for the next
// GroupNorm.  x [B, H, W, Cin] -> y [B, 2H, 2W, Cout]; the upsampled map
// [B, 2H, 2W, Cm] exists only as one work item's band in shared memory,
// one 64-channel chunk at a time.
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
// = 4.7 ms, which only wgmma approaches.  The band's halo and the phases'
// padded rows (below) raise the products done to ~6.9 TFLOP.
//
// Design: conv3x3.cu's warp-specialized wgmma mainloop (K1), twice.
//  * A work item is an output tile of TR = 4 rows x TWP = 64 pixels and all
//    Cout channels, so no band is computed twice.  Its band is the tile
//    plus a 1-pixel halo, 6 x 66 pixels: the up-conv is recomputed x1.55
//    on halos.  The grid is persistent: one block an SM walks the items.
//  * 384 threads: two consumer warpgroups and a producer warpgroup of
//    which one thread issues every copy by TMA, each completing on an
//    mbarrier; the consumers hand slots back through "empty" mbarriers.
//    The producer warpgroup gives its registers to the consumers
//    (setmaxnreg 40 / 232): at 168 a thread (three warps on an SM
//    sub-partition) conv1's 128 accumulators, the up-conv's 32 and the
//    addressing spilled and ptxas serialized the wgmmas (C7512); and
//    consumers that refilled the ring themselves (no producer: an atomic
//    count per slot, the last releaser issuing the copy) put that round
//    trip in every stage's path, 21.4 ms at the 2048^2 junction.  The
//    band epilogue stays on the consumers: handed to the producer
//    warpgroup's three idle warps (z staged in shared memory) it could not
//    keep up with the products, 19.5 ms.
//  * The low-resolution slab, 4 x 34 pixels and all Cin (zero-filled
//    outside the image = the SAME padding of the upsampled map, and past
//    Cin), is loaded by TMA once an item, one 64-channel box of 17 KB a
//    chunk of Cin, with the 128-byte swizzle.
//  * For each 64-channel chunk of Cm:
//    1. the up-conv, per output phase (a, b): the phase's band pixels are
//       3 rows x 33 columns, laid on the slab's pitch of 34 as GEMM rows
//       r * 34 + c, two m64 blocks (128 rows for 99: x1.29), one a
//       warpgroup.  Tap (u, v) of the 2x2 phase kernel is then the slab
//       window starting at pixel 34 u + v: an A descriptor at any pixel
//       start, K-major and swizzled, as K1's taps are.  Rows past the 99
//       read past their sub-slab (into the next one, or the band) and are
//       dropped.  B is the phase kernel's [64 Cin x 64 Cm] slice, MN-major,
//       two taps a 16 KB ring stage.
//    2. its epilogue, from the accumulators: + up_bias, bf16 (the map as
//       the unfused pair would store it), the GroupNorm affine, SiLU, bf16,
//       zero outside the image (after the SiLU: silu(beta) must not leak
//       into conv1's taps), written into the band chunk, 396 pixels x
//       128 B in the 128-byte swizzle that conv1's A descriptors read.
//    3. conv1's 9 taps on that chunk, each a shifted 64-pixel window of the
//       band (K1's taps on its slab), B the HWIO slice [64 Cm x Cout]
//       through the same ring; each warpgroup holds two tile rows x Cout
//       of float32 accumulators across the chunks.
//  * Shared memory: the slab (17 KB a Cin chunk), the band chunk (50 KB)
//    and as many 16 KB ring stages as fit, up to 8: 6 at Cin 256, 2 at
//    Cin 512 (slower, but the decoder's junction has Cin = Cm <= 256).
//    The slab is loaded again only once an item's last up-conv products
//    are done, so it lands while the item's last conv1 taps multiply.
//  * Epilogue of y (K1's): bias in float32, rounded to bf16, stored;
//    statistics of y as stored by shuffles over each warp's rows, per-warp
//    partials in the band's space (free between chunks), a fixed-order sum
//    over the eight warps into per-item partials [B, T, 2, Cout] that
//    conv3x3.cu's hdrvae_group_stats reduces in a fixed order: no atomics.

#include <cuda_bf16.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int TR = 4;                    // output rows an item
constexpr int TWP = 64;                  // output pixels a row (an m64 block)
constexpr int BWID = TWP + 2;            // band pixels a row (1-pixel halo)
constexpr int BPIX = (TR + 2) * BWID;    // 396 band pixels
constexpr int LROWS = TR / 2 + 2;        // slab rows
constexpr int LWID = TWP / 2 + 2;        // slab pixels a row: the phase pitch
constexpr int PH_ROWS = (TR + 2) / 2;    // band rows of one phase
constexpr int PH_COLS = BWID / 2;        // band columns of one phase
constexpr int CK = 64;                   // channels a chunk (128 B)
constexpr int NCONSUMER = 256;           // two warpgroups
constexpr int NTHREADS = NCONSUMER + 128;   // + the producer warpgroup
constexpr int NCWARPS = NCONSUMER / 32;
constexpr int PRODUCER_REGS = 40;        // setmaxnreg: 4 x 40 + 8 x 232
constexpr int CONSUMER_REGS = 232;       // per thread <= 65,536 / 32

constexpr int SUB_BYTES = LROWS * LWID * 128;   // 17,408: a Cin chunk
constexpr int BAND_BYTES = 51200;               // BPIX * 128, 1 KB aligned
constexpr int STAGE_BYTES = 16384;              // a ring stage
constexpr int SLICE_BYTES = 8192;               // [64 k][64 n] bf16
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = (2 + 2 * MAX_STAGES) * 8;
constexpr int SMEM_MAX = 232448;
static_assert(SUB_BYTES % 1024 == 0, "sub-slabs keep the swizzle atoms");
static_assert(BPIX * 128 <= BAND_BYTES, "band");
static_assert(NCWARPS * 2 * 128 * 4 <= BAND_BYTES, "partials in the band");
// the second m64 block's last window row, past the 136 slab pixels of its
// chunk, stays within the next sub-slab or the band
static_assert(2 * 64 + LWID + 1 - LROWS * LWID <= BPIX, "over-read");
// what the producer warpgroup frees covers what the consumers take, with
// room to spare: at 4 x 48 + 8 x 232 = 2,048 exactly, setmaxnreg.inc
// never returned
static_assert(4 * PRODUCER_REGS + 8 * CONSUMER_REGS < 65536 / 32, "regs");

__device__ __forceinline__ float silu(float z) {
  return __fdividef(z, 1.0f + __expf(-z));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONSUMER) : "memory");
}

// A K-major window of 64 pixel rows (128 B, 64 channels, 128-byte swizzle
// as TMA wrote it or the band epilogue stored it), starting at any pixel.
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return make_desc(addr, 16, 1024, LAYOUT_B128);
}

// A weight slice [64 k][64 n] (or two, 8 KB apart, for 128 n), MN-major
// with the 128-byte swizzle as TMA writes it.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return make_desc(addr, SLICE_BYTES, 1024, LAYOUT_B128);
}

struct UpArgs {
  const float* up_bias;   // [Cm]
  const float* gamma;     // [B, Cm]
  const float* beta;      // [B, Cm]
  const float* bias;      // [Cout]
  bf16* y;                // [B, 2H, 2W, Cout]
  float* partial;         // [B, T, 2, Cout] or null
  int B, H, W, Cin, Cm, Cout;
  int nck, nst;           // Cin chunks of the slab, ring stages
};

// The ring's slot and phase parity, advanced in the same order by the
// producer and the consumers.
struct Slot {
  int s = 0, parity = 0;
  __device__ __forceinline__ void next(int nst) {
    if (++s == nst) {
      s = 0;
      parity ^= 1;
    }
  }
};

// The band's pair of channels at one pixel from z (bf16-rounded): the
// GroupNorm affine and SiLU, rounded to bf16; zero outside the image.
__device__ __forceinline__ __nv_bfloat162 band_pair(float z0, float z1,
                                                    float2 g, float2 bt,
                                                    bool in) {
  if (!in) return __floats2bfloat162_rn(0.0f, 0.0f);
  return __floats2bfloat162_rn(silu(z0 * g.x + bt.x), silu(z1 * g.y + bt.y));
}

// One block an SM, walking work items of a TR x TWP output tile and all
// Cout = 64 * NH channels.  See the head of this file.
template <int NH>
__global__ void __launch_bounds__(NTHREADS, 1) upconv_wgmma_kernel(
    const UpArgs a, const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap pmap,
    const __grid_constant__ CUtensorMap wmap) {
  constexpr int CO = 64 * NH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base_s = smem_u32(smem);
  unsigned char* band = smem + a.nck * SUB_BYTES;
  float* red = reinterpret_cast<float*>(band);   // between band chunks
  const uint32_t band_s = base_s + a.nck * SUB_BYTES;
  const uint32_t ring_s = band_s + BAND_BYTES;
  const uint32_t bar_s = ring_s + a.nst * STAGE_BYTES;
  const uint32_t slab_full = bar_s, slab_empty = bar_s + 8;
  auto w_full = [&](int s) { return bar_s + 8 * (2 + s); };
  auto w_empty = [&](int s) { return bar_s + 8 * (2 + MAX_STAGES + s); };

  const int tid = threadIdx.x;
  const int H2 = 2 * a.H, W2 = 2 * a.W;
  const int tiles_w = (W2 + TWP - 1) / TWP;
  const int tiles = ((H2 + TR - 1) / TR) * tiles_w;
  const int nwork = tiles * a.B;
  const int nchunks = a.Cm / CK;
  const int up_stages = 2 * a.nck;   // a phase: 2 tap pairs x Cin chunks

  if (tid == 0) {
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, NCWARPS);
    for (int s = 0; s < a.nst; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), NCWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup-uniform as far as the compiler can see, and the two roles
  // never reconverge (or ptxas ignores setmaxnreg)
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == NCONSUMER / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == NCONSUMER) {
      // ---- producer: one thread issues every TMA copy, in the
      // consumers' order ----
      Slot r;
      int nslab = 0;
      for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
        const int b = wi / tiles, tile = wi % tiles;
        const int h0 = (tile / tiles_w) * TR, w0 = (tile % tiles_w) * TWP;
        // the slab: low-resolution rows h0 / 2 - 1 .. + 3 and columns
        // w0 / 2 - 1 .. + 33, all Cin, once the last item's up-conv is done
        mbar_wait(slab_empty, (nslab & 1) ^ 1);
        mbar_expect_tx(slab_full, a.nck * SUB_BYTES);
        for (int kc = 0; kc < a.nck; ++kc)
          tma_load_4d(base_s + kc * SUB_BYTES, &xmap, slab_full, kc * CK,
                      w0 / 2 - 1, h0 / 2 - 1, b);
        ++nslab;
        for (int c = 0; c < nchunks; ++c) {
          // the up-conv: phase p, Cin chunk i / 2, taps (i % 2, 0) and
          // (i % 2, 1)
          for (int p = 0; p < 4; ++p)
            for (int i = 0; i < up_stages; ++i) {
              mbar_wait(w_empty(r.s), r.parity ^ 1);
              mbar_expect_tx(w_full(r.s), STAGE_BYTES);
              for (int v = 0; v < 2; ++v)
                tma_load_3d(ring_s + r.s * STAGE_BYTES + v * SLICE_BYTES,
                            &pmap, w_full(r.s), c * CK, (i >> 1) * CK,
                            4 * p + 2 * (i & 1) + v);
              r.next(a.nst);
            }
          // conv1: one tap a stage
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(w_empty(r.s), r.parity ^ 1);
            mbar_expect_tx(w_full(r.s), NH * SLICE_BYTES);
            for (int nh = 0; nh < NH; ++nh)
              tma_load_3d(ring_s + r.s * STAGE_BYTES + nh * SLICE_BYTES,
                          &wmap, w_full(r.s), 64 * nh, c * CK, tap);
            r.next(a.nst);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // ---- consumers: two warpgroups; in the up-conv each takes one m64
  // block of a phase's rows, in conv1 two tile rows x Cout ----
  const int cw = tid >> 5, wg = tid >> 7, wl = cw & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float acc[2][NH * 32];   // conv1: tile rows 2 wg + mb, all Cout
  float up[32];            // the up-conv of a phase
  Slot r;
  int nslab = 0;
  for (int wi = blockIdx.x; wi < nwork; wi += gridDim.x) {
    const int b = wi / tiles, tile = wi % tiles;
    const int h0 = (tile / tiles_w) * TR, w0 = (tile % tiles_w) * TWP;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int q = 0; q < NH * 32; ++q) acc[mb][q] = 0.0f;
    mbar_wait(slab_full, nslab & 1);
    ++nslab;

#pragma unroll 1
    for (int c = 0; c < nchunks; ++c) {
      const float* ub = a.up_bias + c * CK + 2 * t;
#pragma unroll 1
      for (int p = 0; p < 4; ++p) {
        // ---- the up-conv of phase p, this warpgroup's m64 block ----
#pragma unroll
        for (int q = 0; q < 32; ++q) up[q] = 0.0f;
        int prev = 0;
#pragma unroll 1
        for (int i = 0; i < up_stages; ++i) {
          mbar_wait(w_full(r.s), r.parity);
          const uint32_t st = ring_s + r.s * STAGE_BYTES;
          const uint32_t a0 = base_s + (i >> 1) * SUB_BYTES +
                              (64 * wg + (i & 1) * LWID) * 128;
          wgmma_fence();
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_ss<64, 1>(up, a_desc(a0 + v * 128 + ks * 32),
                              b_desc(st + v * SLICE_BYTES + ks * 2048));
          wgmma_commit();
          // keep this stage's group in flight; the previous one is done
          wgmma_wait<1>();
          if (i > 0 && lane == 0) mbar_arrive(w_empty(prev));
          prev = r.s;
          r.next(a.nst);
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(w_empty(prev));
          // the item's last up-conv products: the next slab may land
          if (c == nchunks - 1 && p == 3) mbar_arrive(slab_empty);
        }

        // ---- its epilogue into the band chunk: + up_bias, bf16, the
        // GroupNorm affine + SiLU, bf16, zero outside the image; both
        // warpgroups are done reading the band (the previous chunk's
        // conv1, or the previous item's partials) ----
        if (p == 0) consumer_sync();
        const int pa = p >> 1, pb = p & 1;
        const float* gm = a.gamma + static_cast<size_t>(b) * a.Cm +
                          c * CK + 2 * t;
        const float* bt = a.beta + static_cast<size_t>(b) * a.Cm +
                          c * CK + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 64 * wg + 16 * wl + g + 8 * i;   // the phase's row
          const int ri = m / LWID, ci = m - LWID * ri;
          if (ri >= PH_ROWS || ci >= PH_COLS) continue;
          const int br = 2 * ri + 1 - pa, bc = 2 * ci + 1 - pb;
          const int oh = h0 - 1 + br, ow = w0 - 1 + bc;
          const bool in = oh >= 0 && oh < H2 && ow >= 0 && ow < W2;
          const int bp = br * BWID + bc;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 u2 = __ldg(reinterpret_cast<const float2*>(ub +
                                                                    8 * j));
            const float2 z = __bfloat1622float2(__floats2bfloat162_rn(
                up[4 * j + 2 * i] + u2.x, up[4 * j + 2 * i + 1] + u2.y));
            *reinterpret_cast<__nv_bfloat162*>(
                band + bp * 128 + ((j ^ (bp & 7)) << 4) + 4 * t) =
                band_pair(z.x, z.y,
                          __ldg(reinterpret_cast<const float2*>(gm + 8 * j)),
                          __ldg(reinterpret_cast<const float2*>(bt + 8 * j)),
                          in);
          }
        }
      }
      // the band's generic writes, before wgmma reads them
      fence_proxy_async();
      consumer_sync();   // the band chunk is complete

      // ---- conv1's 9 taps on the band chunk ----
      int prev = 0;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int di = tap / 3, dj = tap % 3;
        mbar_wait(w_full(r.s), r.parity);
        const uint32_t st = ring_s + r.s * STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
            wgmma_ss<CO, 1>(
                acc[mb],
                a_desc(band_s + ((2 * wg + mb + di) * BWID + dj) * 128 +
                       ks * 32),
                b_desc(st + ks * 2048));
        wgmma_commit();
        wgmma_wait<1>();
        if (tap > 0 && lane == 0) mbar_arrive(w_empty(prev));
        prev = r.s;
        r.next(a.nst);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(w_empty(prev));
    }
    consumer_sync();   // both warpgroups' conv1 products have read the band

    // ---- epilogue: bias in float32, bf16 store, statistics of y as
    // stored ----
    size_t orow[2][2];
    bool ok[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oh = h0 + 2 * wg + mb, ow = w0 + 16 * wl + g + 8 * i;
        ok[mb][i] = oh < H2 && ow < W2;
        orow[mb][i] = ((static_cast<size_t>(b) * H2 + oh) * W2 + ow) * CO;
      }
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nh * 64 + 8 * j + 2 * t;
        const float b0 = a.bias[n], b1 = a.bias[n + 1];
        float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (ok[mb][i]) {
              const __nv_bfloat162 yb = __floats2bfloat162_rn(
                  acc[mb][nh * 32 + 4 * j + 2 * i] + b0,
                  acc[mb][nh * 32 + 4 * j + 2 * i + 1] + b1);
              *reinterpret_cast<__nv_bfloat162*>(a.y + orow[mb][i] + n) = yb;
              const float v0 = __low2float(yb), v1 = __high2float(yb);
              s0 += v0; s1 += v1; q0 += v0 * v0; q1 += v1 * v1;
            }
          }
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
    consumer_sync();
    if (a.partial != nullptr && tid < 2 * CO) {
      const int ch = tid % CO, sq = tid / CO;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NCWARPS; ++k) v += red[(k * 2 + sq) * 128 + ch];
      a.partial[((static_cast<size_t>(b) * tiles + tile) * 2 + sq) * CO +
                ch] = v;
    }
    // the next item's first band store waits at its phase-0 barrier, after
    // these reads of red
  }
}

// Maps of x [B,H,W,Cin] (the slab's box of one Cin chunk), the phase
// kernels [16,Cin,Cm] and conv1's HWIO kernel [9,Cm,Cout] (64 x 64
// slices); the ring holds as many stages as shared memory leaves.
template <int NH>
int launch(UpArgs a, const void* x, const void* pw, const void* w1,
           cudaStream_t stream) {
  a.nck = (a.Cin + CK - 1) / CK;
  const int off_ring = a.nck * SUB_BYTES + BAND_BYTES;
  a.nst = (SMEM_MAX - 1024 - BAR_BYTES - off_ring) / STAGE_BYTES;
  if (a.nst > MAX_STAGES) a.nst = MAX_STAGES;
  if (a.nst < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + off_ring + a.nst * STAGE_BYTES + BAR_BYTES;
  CUtensorMap xmap, pmap, wmap;
  const uint32_t slab_box[4] = {CK, LWID, LROWS, 1};
  const uint32_t w_box[3] = {64, CK, 1};
  const uint64_t xd[4] = {uint64_t(a.Cin), uint64_t(a.W), uint64_t(a.H),
                          uint64_t(a.B)};
  const uint64_t pd[3] = {uint64_t(a.Cm), uint64_t(a.Cin), 16};
  const uint64_t wd[3] = {uint64_t(a.Cout), uint64_t(a.Cm), 9};
  int err = make_map(&xmap, x, 4, xd, slab_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&pmap, pw, 3, pd, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = make_map(&wmap, w1, 3, wd, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto kernel = upconv_wgmma_kernel<NH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: one block an SM walks the work items
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nwork = ((2 * a.H + TR - 1) / TR) *
                    ((2 * a.W + TWP - 1) / TWP) * a.B;
  kernel<<<nwork < sms ? nwork : sms, NTHREADS, smem, stream>>>(a, xmap,
                                                                pmap, wmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [B,H,W,Cin] bf16 (Cin % 16 == 0, <= 512); pw [2,2,2,2,Cin,Cm] bf16
// phase weights (a,b,u,v) of the upsample conv; up_bias [Cm] f32; gamma /
// beta [B,Cm] f32; w1 [3,3,Cm,Cout] bf16 (HWIO); bias [Cout] f32; y
// [B,2H,2W,Cout] bf16; partial [B,T,2,Cout] f32 or null, T = ceil(2H/4) *
// ceil(2W/64).  Cm in {128, 256}, Cout in {64, 128}; returns
// cudaErrorInvalidValue for any other pair or Cin.
int hdrvae_upconv_gn_conv3x3(const void* x, const void* pw,
                             const void* up_bias, const void* gamma,
                             const void* beta, const void* w1,
                             const void* bias, void* y, void* partial, int B,
                             int H, int W, int Cin, int Cm, int Cout,
                             void* stream) {
  if ((Cm != 128 && Cm != 256) || (Cout != 64 && Cout != 128) ||
      Cin % 16 != 0 || Cin <= 0 || Cin > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const UpArgs a{static_cast<const float*>(up_bias),
                 static_cast<const float*>(gamma),
                 static_cast<const float*>(beta),
                 static_cast<const float*>(bias), static_cast<bf16*>(y),
                 static_cast<float*>(partial), B, H, W, Cin, Cm, Cout, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Cout == 128 ? launch<2>(a, x, pw, w1, s) : launch<1>(a, x, pw, w1, s);
}

}  // extern "C"
