// The whole Swin transformer block (K7) for Hopper: every product by
// wgmma (bf16 operands, float32 accumulation), the weights streamed by TMA
// through an mbarrier ring, the scores kept in registers, and two windows
// (64-row blocks) in flight on each SM.
//
// Replaces the TPU kernel K7 of the JAX package:
//   hdrvae/kernels/swin_attention.py::swin_block_fused, both bodies:
//   v1 (SwinIR, HAT's HAB with the optional `extra` residual)
//     y = x2 + MLP(LN2(x2)),  x2 = x + proj(WindowMHA(LN1(x))) + bp [+ extra]
//   v2 (Swin2SR's SwinV2 block: `post_norm` with cosine attention)
//     y = x2 + LN2(MLP(x2)),  x2 = x + LN1(proj(CosineMHA(x)) + bp) [+ extra]
// on an image [B, H, W, C] that is already rolled by -shift; the shifted
// grid's masks are computed from each window's place in the grid.
//
// What bounds it on the H100: ~0.61 MFLOP per token at C = 180 (qkv 221k,
// scores and values 49k at n = 64, proj 74k, MLP 283k, padded widths)
// against ~4 bytes of feature map in and out: the tensor cores (0.150 ms
// for SwinIR-M's 512^2 tile at 989 TFLOP/s).  The weights (577 KB in bf16
// at C = 180) do not fit shared memory beside a window's activations, so
// every row block streams them from L2.  The design:
//
//  * Persistent blocks, one an SM, each with two warpgroups.  Each
//    warpgroup owns a 64-row block (a window of up to 64 tokens: ws 8, or
//    ws 7's 49 padded to 64) and the two walk the same weight tiles in the
//    same order, so each tile read from L2 serves two row blocks.  The
//    tiles come by TMA, in the order the warps take them, into a ring of
//    NS slots (6 at C = 180), each with a full mbarrier and a count of the
//    warps done with it: the last of the eight to release a slot refills
//    it with the tile NS on.  No block-wide barrier on the way, and no
//    producer warp: a ninth warp would cap every thread at 168 registers
//    (three warps on one SM sub-partition), and this kernel spilled there.
//  * A tile is one 32-column slice of an operand of every product: [CK x
//    32] of Wqkv (q, k or v of one head) or W1 (32 hidden units), MN-major
//    with the 64-byte swizzle; [32 x CK] of Wp (one head's rows) or W2 (32
//    hidden rows), MN-major with the 128-byte swizzle in 64-column boxes.
//    CK is 64, 192 or 256, the least of them that holds C (192 at C =
//    180); TMA zero-fills past the weights' padded extents, and the zero
//    pads change no sum.
//  * LN1 a quad a row, eight rows of a warp at a time (a row's loads in
//    flight together; the next window's rows are prefetched into L2).
//    The bias and LayerNorm vectors sit in shared memory: read from
//    global memory behind each wgmma wait's memory clobber, they paid L2
//    latency every time.
//  * Per head, q, k and v of the row block by wgmma m64n32k16 (A: the LN1
//    rows, K-major with the 64-byte swizzle, in shared memory) -> + bias
//    (v2: the cosine rows and the q scale) in float32 -> bf16.  q stays in
//    registers as S's A operand; k and v go to shared memory in the
//    layouts S and P V read.  S = q K^T by wgmma m64n64k16, q from
//    registers; the bias, the band masks and the softmax work on S's
//    accumulator fragment (exact two-pass: max, exp, sum, then p = exp /
//    sum, correctly rounded by a reciprocal and one FMA correction, in bf16
//    in registers in wgmma's A layout); O = P V
//    by wgmma m64n32k16 with A from registers and V MN-major; O rounded to
//    bf16 into the row block's attention output (K-major, one 32-column
//    atom a head).  No float32 score and no q / k / v touches device
//    memory.
//  * Windows of more than 64 tokens (ws 16: four row blocks) run a window
//    a block: first q, k and v of every row block into a device-memory
//    scratch [nwin, heads, 3, n64, 32] (k and v as the bytes of their
//    shared-memory tiles), then, head by head, the window's K and V copied
//    once into shared memory for both warpgroups' row blocks, S twice over
//    the key tiles (the online row max and sum, then the normalized P and
//    P V).
//  * proj by wgmma m64n64k16 over the heads' atoms (the next tiles loading
//    as each is released), the residuals in float32 on the fragments, LN2
//    (v2: LN1 and the residuals) with the row statistics by quad shuffles
//    (a row's columns lie on one quad), bf16 rows as the MLP's A; x2 kept
//    in each thread's own slots of shared memory.  The MLP runs fused in
//    32-unit chunks: fc1's chunk by wgmma m64n32k16, + b1, exact GELU
//    (erff), bf16 in registers as fc2's A operand, fc2 += by wgmma
//    m64n64k16 into the row block's [64 x CK] accumulator: no hidden
//    activations in memory.  The epilogue adds x2 and b2 (v2: LN2 of fc2
//    + b2, then + x2) on the fragments; the bf16 rows leave through
//    shared memory by 16-byte stores of whole window rows (where window
//    rows are 16-byte multiples), else as bf16 pairs.
//  * Past C = 192 the two warpgroups' buffers and a ring of three slots do
//    not fit; there one warpgroup a block runs (C = 240, SwinIR-L).
// Rounding points are those of the JAX kernel: LN outputs (v2: the input),
// q/k/v, P and the attention output in bf16; scores, softmax (p = exp /
// sum, correctly rounded), q/k norms, residuals, LN and the MLP
// accumulation in float32.

#include "hopper.cuh"
#include "window_attention.cuh"

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

namespace {

using winattn::bf16;
using winattn::desc128;
using winattn::desc64;
using winattn::frag_to_atom;
using winattn::load_pair;
using winattn::MAXC;
using winattn::pack_bf16;
using winattn::prefetch_l2;
using winattn::store_pair;
using winattn::swz;

constexpr int HD = 32;              // padded head dim: 64-byte rows
constexpr int MAXWG = 2;            // warpgroups a block
constexpr int NT = 128 * MAXWG;     // threads a block
constexpr int ATOM = 64 * HD * 2;   // a [64 x 32] bf16 tile: 4 KB
constexpr int SMEM_MAX = 232448;
constexpr int MAX_SLOTS = 8;

struct Args {
  const bf16* x;       // [B, H, W, C] (rolled)
  const bf16* extra;   // [B, H, W, C] or null
  const float* bq;     // [heads * 96]
  const float* qs;     // [heads] v2's q scales, or null
  const float* bp;     // [C]
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  const float* b1;     // [HP]
  const float* b2;     // [C]
  const float* bias;   // [heads, n, n]
  bf16* qkv;           // windows past 64 tokens: [nwin, heads, 3, n64, 32]
  bf16* y;             // [B, H, W, C]
  int H, W, C, heads, hidden, ws, shift, n, n64, nwh, nww, nwin;
  int nchunk;          // the MLP's 32-unit chunks
  int nwg;             // consumer warpgroups a block: 1 or 2
  int vec_out;         // the output leaves by 16-byte stores of window rows
  int items;           // windows (or pairs of windows) to walk
  int nslot;           // weight ring slots
  int regA, regB;      // bytes of a warpgroup's row and scratch regions
  int offB, offPar, offRing, offBar;   // bytes from the aligned base
};

template <bool V2, int NCT>
__global__ void __launch_bounds__(NT, 1)
swin_block_kernel(const __grid_constant__ CUtensorMap wqmap,
                  const __grid_constant__ CUtensorMap wpmap,
                  const __grid_constant__ CUtensorMap w1map,
                  const __grid_constant__ CUtensorMap w2map, const Args a) {
  constexpr int CK = 64 * NCT;     // channels, padded for the tiles
  constexpr int TB = 64 * CK;      // bytes of a weight tile
  constexpr int KS = CK / 16;      // k16 steps over the channels
  // aligned by an offset from smem_raw, so every access stays in the
  // shared window
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NS = a.nslot, H = a.heads, n = a.n;
  const uint32_t ring_s = base_s + a.offRing;
  const uint32_t bar_s = base_s + a.offBar;
  auto full = [&](int s) { return bar_s + 8 * s; };
  // a slot's count of releases (warps done with its tile)
  int* released = reinterpret_cast<int*>(smem + a.offBar + 8 * NS);
  const bool wmode = a.n64 > 64;   // windows of more than one row block
  const int nrb = a.n64 / 64;
  const int npair = (nrb + a.nwg - 1) / a.nwg;
  const int ntile = 4 * H + 2 * a.nchunk;   // a row block's weight tiles
  // the tiles this block walks: a row block's ntile in the order below, a
  // window of several row blocks every block's qkv tiles first
  const int per_item = wmode ? npair * ntile : ntile;
  const int total = blockIdx.x < a.items
                        ? ((a.items - 1 - blockIdx.x) / gridDim.x + 1) *
                              per_item
                        : 0;

  // the bias and LayerNorm vectors in shared memory, zero past C / hidden
  float* bq_s = reinterpret_cast<float*>(smem + a.offPar);
  float* bp_s = bq_s + H * 96;
  float* g1_s = bp_s + CK;
  float* be1_s = g1_s + CK;
  float* g2_s = be1_s + CK;
  float* be2_s = g2_s + CK;
  float* b2_s = be2_s + CK;
  float* b1_s = b2_s + CK;
  for (int i = tid; i < H * 96; i += NT) bq_s[i] = a.bq[i];
  for (int c = tid; c < CK; c += NT) {
    const bool in = c < a.C;
    bp_s[c] = in ? a.bp[c] : 0.0f;
    g1_s[c] = in ? a.g1[c] : 0.0f;
    be1_s[c] = in ? a.be1[c] : 0.0f;
    g2_s[c] = in ? a.g2[c] : 0.0f;
    be2_s[c] = in ? a.be2[c] : 0.0f;
    b2_s[c] = in ? a.b2[c] : 0.0f;
  }
  for (int c = tid; c < HD * a.nchunk; c += NT)
    b1_s[c] = c < a.hidden ? a.b1[c] : 0.0f;

  // Tile j of the walk by TMA into slot j % NS (one thread): tile i of a
  // row block is q, k, v of head i / 3 (i < 3 H), head i - 3 H's proj
  // rows (i < 4 H), then fc1's and fc2's slices of chunk (i - 4 H) / 2 in
  // turn.
  auto put = [&](int j) {
    int i = j % per_item;
    if (wmode)
      i = i < npair * 3 * H ? i % (3 * H)
                            : 3 * H + (i - npair * 3 * H) % (ntile - 3 * H);
    const uint32_t dst = ring_s + (j % NS) * TB, fb = full(j % NS);
    hopper::mbar_expect_tx(fb, TB);
    if (i < 3 * H) {
      hopper::tma_load_3d(dst, &wqmap, fb, (i / 3) * 96 + (i % 3) * HD, 0,
                          0);
    } else if (i < 4 * H) {
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
        hopper::tma_load_3d(dst + jn * 4096, &wpmap, fb, 64 * jn,
                            HD * (i - 3 * H), 0);
    } else if (((i - 4 * H) & 1) == 0) {
      hopper::tma_load_3d(dst, &w1map, fb, HD * ((i - 4 * H) >> 1), 0, 0);
    } else {
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
        hopper::tma_load_3d(dst + jn * 4096, &w2map, fb, 64 * jn,
                            HD * ((i - 4 * H) >> 1), 0);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(NS, total); ++j) put(j);

  const int w = warp >> 2;   // this warpgroup
  if (w >= a.nwg) return;
  const int wl = warp & 3, g = lane >> 2, t = lane & 3;

  // this warpgroup's regions: A the LN rows (the qkv / fc1 operand), B the
  // attention output (one atom a head) and the attention tiles, later x2
  unsigned char* regA = smem + w * a.regA;
  const uint32_t A_s = base_s + w * a.regA;
  unsigned char* regB = smem + a.offB + w * a.regB;
  const uint32_t B_s = base_s + a.offB + w * a.regB;
  // x2: NCT * 16 float2 slots a thread, slot k at x2p[k * 128 + thread]
  float2* x2p = reinterpret_cast<float2*>(regB);
  // K and V tiles: in this warpgroup's region (one row block a window),
  // or one window's, shared: K in warpgroup 0's region, V in warpgroup 1's
  // (one warpgroup: behind K)
  const int att = H * ATOM;
  unsigned char* k_p = wmode ? smem + a.offB + att : regB + att;
  unsigned char* v_p = wmode ? (a.nwg == 2 ? k_p + a.regB : k_p + a.n64 * 64)
                             : regB + att + ATOM;
  const uint32_t k_s = base_s + static_cast<uint32_t>(k_p - smem);
  const uint32_t v_s = base_s + static_cast<uint32_t>(v_p - smem);

  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  };
  auto all_sync = [&]() {
    asm volatile("bar.sync 3, %0;\n" ::"r"(128 * a.nwg) : "memory");
  };

  // Every warp takes every tile of the walk in order, and releases it
  // once its wgmmas on it are done; the last of the block's warps to
  // release a slot refills it with the tile NS on.
  int next = 0;   // the next tile to take
  auto take = [&]() {
    const int j = next++;
    hopper::mbar_wait(full(j % NS), (j / NS) & 1);
    return j;
  };
  auto release = [&](int j) {
    if (lane != 0) return;
    __threadfence_block();
    const int s = j % NS;
    if (atomicAdd(released + s, 1) == 4 * a.nwg - 1) {
      atomicExch(released + s, 0);
      if (j + NS < total) put(j + NS);
    }
  };
  auto tile_s = [&](int j) { return ring_s + (j % NS) * TB; };
  // the LN rows as wgmma's A at k16 step ks
  const uint64_t dA = desc64(A_s);
  auto a_step = [](int ks) {
    return static_cast<uint64_t>(((ks >> 1) * ATOM + (ks & 1) * 32) >> 4);
  };

  // window geometry: token tok of window win at element pix(win, tok)
  auto pix = [&](int win, int tok) -> size_t {
    const int per = a.nwh * a.nww;
    const int b = win / per, wr = (win % per) / a.nww, wc = win % a.nww;
    const int hh = wr * a.ws + tok / a.ws, ww = wc * a.ws + tok % a.ws;
    return ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * a.C;
  };

  // LN1 (v2: the input as it is) of tokens tok0 .. tok0 + 63 into region
  // A as bf16: a quad a row, eight rows of a warp at a time (lane 4 g + t
  // holds channels 8 k + 2 t, + 1 of row g), a row's loads all in flight
  // together; zero past the tokens and channels
  auto ln_rows = [&](int win, int tok0) {
#pragma unroll 1
    for (int r = 16 * wl + g; r < 16 * wl + 16; r += 8) {
      const int tok = tok0 + r;
      const bool live = tok < n;
      const bf16* src = a.x + (live ? pix(win, tok) : 0);
      float2 v[CK / 8];
#pragma unroll
      for (int k = 0; k < CK / 8; ++k)
        v[k] = live ? load_pair(src, 8 * k + 2 * t, a.C)
                    : make_float2(0.0f, 0.0f);
      if constexpr (!V2) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < CK / 8; ++k) {
          sum += v[k].x;
          sum += v[k].y;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float mean = sum / a.C;
        float q = 0.0f;
#pragma unroll
        for (int k = 0; k < CK / 8; ++k) {
          const int c = 8 * k + 2 * t;
          const float d0 = v[k].x - mean, d1 = v[k].y - mean;
          if (c < a.C) q += d0 * d0;
          if (c + 1 < a.C) q += d1 * d1;
        }
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        const float rstd = rsqrtf(q / a.C + 1e-5f);
#pragma unroll
        for (int k = 0; k < CK / 8; ++k) {
          const int c = 8 * k + 2 * t;
          v[k].x = live && c < a.C
                       ? (v[k].x - mean) * rstd * g1_s[c] + be1_s[c] : 0.0f;
          v[k].y = live && c + 1 < a.C
                       ? (v[k].y - mean) * rstd * g1_s[c + 1] + be1_s[c + 1]
                       : 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < CK / 8; ++k)
        *reinterpret_cast<uint32_t*>(regA + swz(r, 8 * k + 2 * t)) =
            pack_bf16(v[k].x, v[k].y);
    }
  };

  // q, k and v of head h for the row block in region A, + bias (v2: the
  // cosine rows, q times its scale), in float32 fragments f[0..2]
  auto qkv_head = [&](int h, float (&f)[3][16]) {
    int sl[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) sl[s] = take();
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 16; ++e) f[s][e] = 0.0f;
    hopper::fence_operands<16>(f[0]);
    hopper::fence_operands<16>(f[1]);
    hopper::fence_operands<16>(f[2]);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint64_t db = desc64(tile_s(sl[s]));
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hopper::wgmma_ss<32, 1>(f[s], dA + a_step(ks), db + ks * 64);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands<16>(f[0]);
    hopper::fence_operands<16>(f[1]);
    hopper::fence_operands<16>(f[2]);
#pragma unroll
    for (int s = 0; s < 3; ++s) release(sl[s]);
    const float* bqh = bq_s + h * 96;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float ss[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = f[s][4 * j + e] + bqh[s * HD + 8 * j + 2 * t +
                                                (e & 1)];
          f[s][4 * j + e] = v;
          ss[e >> 1] += v * v;
        }
      if constexpr (V2) {
        if (s < 2) {   // cosine: the q / k rows over their L2 norms
          float d[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
            ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
            d[i] = fmaxf(sqrtf(ss[i]), 1e-12f);
          }
          const float m = s == 0 ? a.qs[h] : 1.0f;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            f[s][e] = f[s][e] / d[(e >> 1) & 1] * m;
        }
      }
    }
  };

  // the scores of key tile kt of head h for query rows rows[0..1] of the
  // window (token indices, clamped for the pad rows) against the K tile at
  // kt_s, q from registers: s = q k + (bias + row mask) + column mask, -inf
  // for keys past n
  const float inv_ws = 1.0f / a.ws;
  const int band = a.ws - a.shift;
  // the position bias of key tile kt of head h for the rows, in S's
  // fragment order
  auto load_bias = [&](float (&bb)[32], int kt, int h, const int (&rows)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* brow =
          a.bias + (static_cast<size_t>(h) * n + rows[i]) * n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 64 * kt + 8 * j + 2 * t + e;
          bb[4 * j + 2 * i + e] = key < n ? __ldg(brow + key) : 0.0f;
        }
    }
  };
  auto scores = [&](float (&s)[32], const float (&bb)[32],
                    const uint32_t (&qa)[8], uint32_t kt_s, int kt,
                    const int (&rows)[2], bool lr, bool lc) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    hopper::fence_operands<32>(s);
    hopper::wgmma_fence();
    const uint64_t dk = desc64(kt_s);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      hopper::wgmma_rs_n64<0>(s, qa + 4 * kk, dk + 2 * kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands<32>(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = rows[i] / a.ws, qc = rows[i] - qr * a.ws;
      const bool qrb = qr >= band, qcb = qc >= band;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 64 * kt + 8 * j + 2 * t + e;
          const int kr = __float2int_rz((key + 0.5f) * inv_ws);
          const int kc = key - kr * a.ws;
          float& v = s[4 * j + 2 * i + e];
          float tb = bb[4 * j + 2 * i + e];
          if (lr && qrb != (kr >= band)) tb += -100.0f;
          v += tb;
          if (lc && qcb != (kc >= band)) v += -100.0f;
          if (key >= n) v = -INFINITY;
        }
    }
  };
  // O += P V over the V tile at vt_s, P in registers
  auto pv = [&](float (&o)[16], const uint32_t (&pa)[16], uint32_t vt_s) {
    hopper::fence_operands<16>(o);
    hopper::wgmma_fence();
    const uint64_t dv = desc64(vt_s);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_rs_n32<1>(o, pa + 4 * ks, dv + ks * 64);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands<16>(o);
  };
  auto to_p = [&](uint32_t (&pa)[16], const float (&s)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        pa[2 * j + i] = pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
  };
  // the next window's x (and extra) rows into L2 while this one computes
  // (where window rows are 16-byte multiples at 16-byte aligned pixels)
  auto prefetch_window = [&](int win) {
    if (!a.vec_out || (tid & 127) != 0 || win >= a.nwin) return;
    for (int row = 0; row < a.ws; ++row) {
      const size_t px = pix(win, row * a.ws);
      prefetch_l2(a.x + px, a.ws * a.C * 2);
      if (a.extra != nullptr) prefetch_l2(a.extra + px, a.ws * a.C * 2);
    }
  };
  auto grid_masks = [&](int win, bool& lr, bool& lc) {
    const int wr = (win / a.nww) % a.nwh, wc = win % a.nww;
    lr = a.shift > 0 && wr == a.nwh - 1;
    lc = a.shift > 0 && wc == a.nww - 1;
  };

  // proj, the residuals, LN2 (v2: LN1), the MLP and the store of the row
  // block of tokens tok0 .. of window win, its attention output in region
  // B; stores only when `real`
  auto tail = [&](int win, int tok0, bool real) {
    float acc[NCT][32];
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[jn][e] = 0.0f;
      hopper::fence_operands<32>(acc[jn]);
    }
    const uint64_t dO = desc64(B_s);
    int prev = 0;
    for (int h = 0; h < H; ++h) {
      const int s = take();
      hopper::wgmma_fence();
      const uint64_t db = desc128(tile_s(s));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
          hopper::wgmma_ss<64, 1>(acc[jn], dO + ((h * ATOM + kk * 32) >> 4),
                                  db + ((jn * 4096 + kk * 2048) >> 4));
      hopper::wgmma_commit();
      if (h > 0) {
        hopper::wgmma_wait<1>();
        release(prev);
      }
      prev = s;
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) hopper::fence_operands<32>(acc[jn]);
    release(prev);
    wg_sync();   // every warp's proj has read the attention output

    // x2 on the fragments (v1: x + proj + bp [+ extra]; v2: proj + bp,
    // then LN1 of it, x2 = x + that [+ extra]), its row statistics by quad
    // shuffles (a row's columns lie on one quad); the MLP's input rows (v1:
    // LN2 of x2; v2: x2) into region A as bf16, and x2 kept for the output
    // in this thread's own slots of region B
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * wl + g + 8 * i, tok = tok0 + r;
      const bool live = tok < n;
      const size_t px = live ? pix(win, tok) : 0;
      const bf16* xr = a.x + px;
      const bf16* er = a.extra != nullptr ? a.extra + px : nullptr;
      float sum = 0.0f;
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * jn + 8 * j + 2 * t;
          float xs[2] = {0.0f, 0.0f}, es[2] = {0.0f, 0.0f};
          if constexpr (!V2) {
            if (live) {
              const float2 xv = load_pair(xr, c, a.C);
              xs[0] = xv.x;
              xs[1] = xv.y;
              if (er != nullptr) {
                const float2 ev = load_pair(er, c, a.C);
                es[0] = ev.x;
                es[1] = ev.y;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[jn][4 * j + 2 * i + e];
            if (c + e < a.C) {
              if constexpr (V2) {
                v = v + bp_s[c + e];
              } else {
                v = xs[e] + v + bp_s[c + e];
                if (er != nullptr) v += es[e];
              }
            } else {
              v = 0.0f;
            }
            sum += v;
          }
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / a.C;
      float q = 0.0f;
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = acc[jn][4 * j + 2 * i + e] - mean;
            if (64 * jn + 8 * j + 2 * t + e < a.C) q += d * d;
          }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      const float rstd = rsqrtf(q / a.C + 1e-5f);
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * jn + 8 * j + 2 * t;
          float2 xv = make_float2(0.0f, 0.0f), ev = make_float2(0.0f, 0.0f);
          if constexpr (V2) {
            if (live) {
              xv = load_pair(xr, c, a.C);
              if (er != nullptr) ev = load_pair(er, c, a.C);
            }
          }
          const float xs[2] = {xv.x, xv.y}, es[2] = {ev.x, ev.y};
          float x2v[2], rowv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[jn][4 * j + 2 * i + e];
            const bool in = live && c + e < a.C;
            if constexpr (V2) {
              float z = 0.0f;
              if (in) {
                z = xs[e] + ((v - mean) * rstd * g1_s[c + e] + be1_s[c + e]);
                if (er != nullptr) z += es[e];
              }
              x2v[e] = z;
              rowv[e] = z;
            } else {
              x2v[e] = v;
              rowv[e] = in ? (v - mean) * rstd * g2_s[c + e] + be2_s[c + e]
                           : 0.0f;
            }
          }
          *reinterpret_cast<uint32_t*>(regA + swz(r, c)) =
              pack_bf16(rowv[0], rowv[1]);
          x2p[((jn * 8 + j) * 2 + i) * 128 + (tid & 127)] =
              make_float2(x2v[0], x2v[1]);
        }
    }
    hopper::fence_proxy_async();   // the rows, before wgmma reads them
    wg_sync();

    // the MLP in 32-unit chunks: fc1 -> GELU -> bf16 A -> fc2 +=
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[jn][e] = 0.0f;
      hopper::fence_operands<32>(acc[jn]);
    }
    for (int ch = 0; ch < a.nchunk; ++ch) {
      const int s1 = take();
      float h1[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) h1[e] = 0.0f;
      hopper::fence_operands<16>(h1);
      hopper::wgmma_fence();
      const uint64_t db1 = desc64(tile_s(s1));
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hopper::wgmma_ss<32, 1>(h1, dA + a_step(ks), db1 + ks * 64);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<16>(h1);
      release(s1);
      uint32_t ha[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float u[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = HD * ch + 8 * j + 2 * t + e;
            u[e] = c < a.hidden
                       ? winattn::gelu_erf(h1[4 * j + 2 * i + e] + b1_s[c])
                       : 0.0f;
          }
          ha[2 * j + i] = pack_bf16(u[0], u[1]);
        }
      const int s2 = take();
      hopper::fence_operands<8>(ha);
      hopper::wgmma_fence();
      const uint64_t db2 = desc128(tile_s(s2));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
          hopper::wgmma_rs_n64<1>(acc[jn], ha + 4 * kk,
                                  db2 + ((jn * 4096 + kk * 2048) >> 4));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn) hopper::fence_operands<32>(acc[jn]);
      hopper::fence_operands<8>(ha);
      release(s2);
    }

    // the output: v1 x2 + fc2 + b2; v2 x2 + LN2(fc2 + b2), its row
    // statistics by quad shuffles (a row's columns lie on one quad)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * wl + g + 8 * i, tok = tok0 + r;
      float mean = 0.0f, rstd = 1.0f;
      if constexpr (V2) {
        float sum = 0.0f;
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 64 * jn + 8 * j + 2 * t + e;
              float& f = acc[jn][4 * j + 2 * i + e];
              f = c < a.C ? f + b2_s[c] : 0.0f;
              sum += f;
            }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        mean = sum / a.C;
        float q = 0.0f;
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 64 * jn + 8 * j + 2 * t + e;
              const float d = acc[jn][4 * j + 2 * i + e] - mean;
              if (c < a.C) q += d * d;
            }
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        rstd = rsqrtf(q / a.C + 1e-5f);
      }
      if (!real || tok >= n) continue;
      bf16* dst = a.vec_out ? nullptr : a.y + pix(win, tok);
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * jn + 8 * j + 2 * t;
          if (c >= a.C) continue;
          const float2 xv = x2p[((jn * 8 + j) * 2 + i) * 128 + (tid & 127)];
          const float xs[2] = {xv.x, xv.y};
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float f = acc[jn][4 * j + 2 * i + e];
            if constexpr (V2)
              o[e] = xs[e] + ((f - mean) * rstd * g2_s[c + e] + be2_s[c + e]);
            else
              o[e] = xs[e] + f + b2_s[c + e];
          }
          if (a.vec_out)   // staged as [64 tokens][C] in region A
            *reinterpret_cast<uint32_t*>(regA + 2 * (r * a.C + c)) =
                pack_bf16(o[0], o[1]);
          else
            store_pair(dst, c, a.C, o[0], o[1]);
        }
    }
    if (a.vec_out) {
      // the staged rows out by 16-byte stores: a window row's pixels are
      // ws * C contiguous channels
      wg_sync();
      if (real) {
        const int rows_w = min(64, n - tok0) / a.ws;
        const int per = a.ws * a.C / 8;   // 16-byte chunks a window row
        for (int idx = tid & 127; idx < rows_w * per; idx += 128) {
          const int row = idx / per, ch = idx - row * per;
          *reinterpret_cast<uint4*>(a.y + pix(win, tok0 + row * a.ws) +
                                    8 * ch) =
              *reinterpret_cast<const uint4*>(regA + 2 * row * a.ws * a.C +
                                              16 * ch);
        }
      }
    }
  };

  if (!wmode) {
    // a window a warpgroup: windows 2 item + w (the last pair's second,
    // past the grid, repeats the first and stores nothing)
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      const int wi = a.nwg * item + w;
      const bool real = wi < a.nwin;
      const int win = real ? wi : a.nwin - 1;
      bool lr, lc;
      grid_masks(win, lr, lc);
      int rows[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) rows[i] = min(16 * wl + g + 8 * i, n - 1);
      prefetch_window(a.nwg * (item + gridDim.x) + w);
      wg_sync();   // the last window's readers of region A are done
      ln_rows(win, 0);
      hopper::fence_proxy_async();
      wg_sync();
      for (int h = 0; h < H; ++h) {
        float bb[32];   // in flight during the qkv products
        load_bias(bb, 0, h, rows);
        float f[3][16];
        qkv_head(h, f);
        uint32_t qa[8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            qa[2 * j + i] = pack_bf16(f[0][4 * j + 2 * i],
                                      f[0][4 * j + 2 * i + 1]);
        wg_sync();   // the last head's S and P V have read K and V
        frag_to_atom(k_p, f[1], wl, g, t);
        frag_to_atom(v_p, f[2], wl, g, t);
        hopper::fence_proxy_async();
        wg_sync();
        float s[32];
        scores(s, bb, qa, k_s, 0, rows, lr, lc);
        // the exact softmax of the single key tile
        uint32_t pa[16];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            m = fmaxf(m, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float l = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * i + e];
              x = expf(x - m);
              l += x;
            }
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          // p = e / l, correctly rounded (what __fdiv_rn gives, as the
          // JAX kernel's p / l): e times il = 1 / l rounded, then one FMA
          // correction (Markstein); padded rows take il = 0, so p = 0
          const float il = 16 * wl + g + 8 * i < n ? 1.0f / l : 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * i + e];
              const float q = x * il;
              x = fmaf(fmaf(-q, l, x), il, q);
            }
        }
        to_p(pa, s);
        float o[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) o[e] = 0.0f;
        pv(o, pa, v_s);
        frag_to_atom(regB + h * ATOM, o, wl, g, t);
      }
      hopper::fence_proxy_async();   // the attention output, for proj
      wg_sync();
      tail(win, 0, real);
    }
    return;
  }

  // windows of several row blocks: a window a block, row block rb = nwg p
  // + w of it on warpgroup w (a block past the window repeats the last
  // and stores nothing)
  const int n64 = a.n64;
  const int ntk = n64 / 64;
  for (int win = blockIdx.x; win < a.nwin; win += gridDim.x) {
    bool lr, lc;
    grid_masks(win, lr, lc);
    if (w == 0) prefetch_window(win + gridDim.x);
    bf16* scr = a.qkv + static_cast<size_t>(win) * H * 3 * n64 * HD;
    // q, k and v of every row block into the scratch: q as rows, k and v
    // as the bytes of their shared-memory tiles
    for (int p = 0; p < npair; ++p) {
      const int rb = a.nwg * p + w;
      const bool real = rb < nrb;
      const int tok0 = 64 * (real ? rb : nrb - 1);
      wg_sync();
      ln_rows(win, tok0);
      hopper::fence_proxy_async();
      wg_sync();
      for (int h = 0; h < H; ++h) {
        float f[3][16];
        qkv_head(h, f);
        if (!real) continue;
        bf16* sq = scr + static_cast<size_t>(h) * 3 * n64 * HD;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * wl + g + 8 * i, c = 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(sq + (tok0 + r) * HD + c) =
                pack_bf16(f[0][4 * j + 2 * i], f[0][4 * j + 2 * i + 1]);
          }
        frag_to_atom(reinterpret_cast<unsigned char*>(sq + n64 * HD) +
                         tok0 * 64, f[1], wl, g, t);
        frag_to_atom(reinterpret_cast<unsigned char*>(sq + 2 * n64 * HD) +
                         tok0 * 64, f[2], wl, g, t);
      }
    }
    all_sync();   // the scratch is whole
    for (int p = 0; p < npair; ++p) {
      const int rb = a.nwg * p + w;
      const bool real = rb < nrb;
      const int tok0 = 64 * (real ? rb : nrb - 1);
      int rows[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        rows[i] = min(tok0 + 16 * wl + g + 8 * i, n - 1);
      for (int h = 0; h < H; ++h) {
        const bf16* sq = scr + static_cast<size_t>(h) * 3 * n64 * HD;
        all_sync();   // the last head's readers of K and V are done
        // the window's K and V tiles, once for both row blocks
        const unsigned char* kimg =
            reinterpret_cast<const unsigned char*>(sq + n64 * HD);
        for (int off = 16 * tid; off < n64 * 64;
             off += 16 * 128 * a.nwg) {
          winattn::cp_async16(k_p + off, kimg + off);
          winattn::cp_async16(v_p + off, kimg + n64 * 64 + off);
        }
        winattn::cp_async_commit();
        uint32_t qa[8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            qa[2 * j + i] = __ldcg(reinterpret_cast<const unsigned*>(
                sq + (tok0 + 16 * wl + g + 8 * i) * HD + 8 * j + 2 * t));
        winattn::cp_async_wait<0>();
        hopper::fence_proxy_async();
        all_sync();
        // pass 1: the rows' max and sum online over the key tiles; pass
        // 2: P = exp(s - max) / sum in bf16 and O += P V
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
        float s[32];
        for (int kt = 0; kt < ntk; ++kt) {   // pass 1
          float bb[32];
          load_bias(bb, kt, h, rows);
          scores(s, bb, qa, k_s + kt * ATOM, kt, rows, lr, lc);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float mt = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mt = fmaxf(mt, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
            const float mn = fmaxf(m[i], mt);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) rs += expf(s[4 * j + 2 * i + e] - mn);
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            l[i] = l[i] * expf(m[i] - mn) + rs;
            m[i] = mn;
          }
        }
        float il[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          il[i] = tok0 + 16 * wl + g + 8 * i < n ? 1.0f / l[i] : 0.0f;
        float o[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) o[e] = 0.0f;
        for (int kt = 0; kt < ntk; ++kt) {   // pass 2
          float bb[32];
          load_bias(bb, kt, h, rows);
          scores(s, bb, qa, k_s + kt * ATOM, kt, rows, lr, lc);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& x = s[4 * j + 2 * i + e];
                const float ex = expf(x - m[i]), q = ex * il[i];
                x = fmaf(fmaf(-q, l[i], ex), il[i], q);   // ex / l, as above
              }
          uint32_t pa[16];
          to_p(pa, s);
          pv(o, pa, v_s + kt * ATOM);
        }
        frag_to_atom(regB + h * ATOM, o, wl, g, t);
      }
      hopper::fence_proxy_async();
      all_sync();   // K and V are read: the tails may write x2 over them
      tail(win, tok0, real);
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The block's shared-memory plan for nwg warpgroups; false if it does not
// fit with at least three ring slots.
bool plan(Args& a, int CK, int nwg, int& smem) {
  const int att = a.n64 > 64 ? (nwg == 2 ? 1 : 2) * a.n64 * 64 : 2 * ATOM;
  a.nwg = nwg;
  a.regA = 128 * CK;
  a.regB = round_up(std::max(256 * CK, a.heads * ATOM + att), 1024);
  a.offB = nwg * a.regA;
  a.offPar = a.offB + nwg * a.regB;
  const int par = 4 * (a.heads * 96 + 7 * CK + HD * a.nchunk);
  a.offRing = a.offPar + round_up(par, 1024);
  const int tb = 64 * CK;
  a.nslot = std::min(MAX_SLOTS, (SMEM_MAX - 1024 - a.offRing) / (tb + 16));
  a.offBar = a.offRing + a.nslot * tb;
  smem = a.offBar + 16 * a.nslot + 1024;   // + the alignment
  return a.nslot >= 3;
}

template <bool V2, int NCT>
int launch(const CUtensorMap* maps, const Args& a, int smem, int grid,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel<V2, NCT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_kernel<V2, NCT><<<grid, NT, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <bool V2>
int launch_width(int nct, const CUtensorMap* maps, const Args& a, int smem,
                 int grid, cudaStream_t s) {
  switch (nct) {
    case 1: return launch<V2, 1>(maps, a, smem, grid, s);
    case 3: return launch<V2, 3>(maps, a, smem, grid, s);
    default: return launch<V2, 4>(maps, a, smem, grid, s);
  }
}

}  // namespace

extern "C" {

// x, extra (or null), y: [B, H, W, C] bf16, H and W multiples of ws;
// wq [CP, heads*96], wp [heads*32, CP], w1 [CP, HP], w2 [HP, CP] bf16
// (CP, HP: C and hidden rounded up to 16, pads zero); bq [heads*96], b1
// [HP], bp, b2, g1, be1, g2, be2 [C], bias [heads, n, n] float32.  Windows
// of more than 64 tokens need the scratch [B * (H/ws) * (W/ws), heads, 3,
// n64, 32] bf16 (n64: n rounded up to 64); others take none (null).
// post_norm selects the v2 body, whose q scales qs [heads] float32 are
// given exactly then (null for v1).  Returns cudaErrorInvalidValue for
// shapes it does not take (n > 256, C > 256, C > 32 * heads, or more than
// the block's shared memory).
int hdrvae_swin_block(const void* x, const void* extra, const void* wq,
                      const void* bq, const void* qs, const void* wp,
                      const void* bp, const void* g1, const void* be1,
                      const void* g2, const void* be2, const void* w1,
                      const void* b1, const void* w2, const void* b2,
                      const void* bias, void* scratch, void* y, int B, int H,
                      int W, int C, int heads, int hidden, int ws, int shift,
                      int post_norm, void* stream) {
  Args a = {};
  a.n = ws * ws;
  a.n64 = round_up(a.n, 64);
  if (ws < 1 || H % ws || W % ws || a.n > 256 || C < 1 || C > HD * heads ||
      C > MAXC * 32 || shift < 0 || shift >= ws || hidden < 1 ||
      (post_norm != 0) != (qs != nullptr) ||
      (a.n64 > 64 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.bq = static_cast<const float*>(bq);
  a.qs = static_cast<const float*>(qs);
  a.bp = static_cast<const float*>(bp);
  a.g1 = static_cast<const float*>(g1);
  a.be1 = static_cast<const float*>(be1);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.bias = static_cast<const float*>(bias);
  a.qkv = static_cast<bf16*>(scratch);
  a.y = static_cast<bf16*>(y);
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.hidden = hidden;
  a.ws = ws;
  a.shift = shift;
  a.nwh = H / ws;
  a.nww = W / ws;
  a.nwin = B * a.nwh * a.nww;
  a.nchunk = (hidden + HD - 1) / HD;
  // window rows of 16-byte multiples at 16-byte aligned pixels, whole in
  // each row block
  a.vec_out = C % 2 == 0 && (ws * C) % 8 == 0 && (W * C) % 8 == 0 &&
              (a.n <= 64 || 64 % ws == 0) &&
              reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // channels padded to CK = 64, 192 or 256 (the pads are zeros, exact)
  const int nct = C <= 64 ? 1 : C <= 192 ? 3 : 4, CK = 64 * nct;
  const int CP = round_up(C, 16), HP = round_up(hidden, 16);
  int smem = 0;
  if (!plan(a, CK, 2, smem) && !plan(a, CK, 1, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  a.items = a.n64 > 64 ? a.nwin : (a.nwin + a.nwg - 1) / a.nwg;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::max(1, std::min(sms, a.items));

  // the weights' maps: wq and w1 in [CK x 32] tiles (64-byte swizzle),
  // wp and w2 in [32 x 64] boxes (128-byte swizzle); past the padded
  // extents TMA fills zeros
  CUtensorMap maps[4];
  const void* ptrs[4] = {wq, wp, w1, w2};
  const uint64_t dims[4][3] = {{uint64_t(heads) * 96, uint64_t(CP), 1},
                               {uint64_t(CP), uint64_t(heads) * HD, 1},
                               {uint64_t(HP), uint64_t(CP), 1},
                               {uint64_t(CP), uint64_t(HP), 1}};
  const uint32_t box_a[3] = {HD, uint32_t(CK), 1}, box_b[3] = {64, HD, 1};
  for (int i = 0; i < 4; ++i) {
    const bool kn = i == 0 || i == 2;
    const int e = hopper::make_map(&maps[i], ptrs[i], 3, dims[i],
                                   kn ? box_a : box_b,
                                   kn ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return post_norm ? launch_width<true>(nct, maps, a, smem, grid, st)
                   : launch_width<false>(nct, maps, a, smem, grid, st);
}

}  // extern "C"
