// The whole Swin transformer block, one 512-thread block per window, on
// Hopper's tensor cores (bf16 mma.sync and WMMA, float32 accumulation).
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
// against ~4 bytes of feature map in and out, so the tensor cores bound it;
// the weights (qkv 221 KB, proj 74 KB, fc1 / fc2 141 KB each in bf16) do
// not fit shared memory beside a window's activations, so each weight GEMM
// streams B through a two-buffer cp.async ring in shared memory (96 x 128
// pieces, read from L2 by every window) into ldmatrix + mma.sync, each B
// fragment serving the warp's row tiles; the attention products are WMMA.
// One window per block; wgmma and TMA are later work.
//
// Design (per window of n = ws * ws tokens, padded to n16 = 16 * ceil(n /
// 16) rows; C padded to CP = 16 * ceil(C / 16), the MLP width to HP):
//  * Phase 1, per 64-token row block: LN1 in float32 (v2: the raw input)
//    -> bf16 rows in shared memory (pad rows and columns zero) -> qkv = y @
//    Wqkv + bqkv in the head-major [head][q|k|v] 32-wide slot layout (head
//    dim zero-padded to 32, the softmax scale folded into q) -> bf16 into
//    the window's slice of a global scratch [nwin, n16, heads * 96], which
//    stays in L2.  v2: each warp owns whole 32-wide slots, so a q or k row
//    lies on the four lanes of a quad of its accumulator fragments; two
//    quad shuffles give the row's float32 norm, the row is divided by
//    max(norm, 1e-12) and q times its head's clamped logit scale before
//    the bf16 store, as the JAX kernel rounds (the zero pad lanes keep the
//    norm exact; the normalization cancels the folded softmax scale).
//  * Phase 2, per row block and head: the head's q rows, K and V copied to
//    shared memory (V arriving while the softmax runs; at n16 <= 64 the
//    next head's while this one computes) -> S = q k^T
//    (float32, shared) -> + the position bias [heads, n, n] (v1's table,
//    v2's continuous position bias; read from global) + -100 band masks
//    in the last window row / column of a shifted grid (a corner window
//    takes both, as the JAX kernel does; identical after softmax) ->
//    float32 softmax, 8 threads a row -> P in bf16 over S's own bytes ->
//    O_h = P v -> bf16 into the row block's [64, heads * 32] attention
//    output.
//  * Phase 3, per row block: x and extra read into shared memory a token
//    row a warp -> proj (the padded head-major rows of Wp) -> v1: x2 = x +
//    proj + bp [+ extra] in float32 (shared) -> LN2 -> bf16 -> fc1 + b1 ->
//    exact GELU (erff) -> bf16 hidden -> fc2 -> x2 + out + b2 -> bf16 rows
//    in shared memory -> stored at the window's pixels a token row a warp.
//    v2: proj + bp as whole float32 rows in x2's space, then a warp a row:
//    x2 = x + LN1(row) [+ extra] and its bf16 copy as fc1's input (no
//    LN2); fc2 + b2 as whole float32 rows over the attention output's and
//    LN rows' space (both free by then), then a warp a row: x2 + LN2(row)
//    -> bf16 -> the window's pixels.
// Rounding points are those of the JAX kernel: LN outputs (v2: the input),
// q/k/v, P and the attention output in bf16; scores, softmax (p as the exp
// times the sum's reciprocal, within a float32 ulp of the JAX division),
// q/k norms, residuals, LN and the MLP accumulation in float32.

#include <algorithm>

#include "window_attention.cuh"

namespace {

using namespace winattn;

struct SwinArgs {
  const bf16* x;       // [B, H, W, C] (rolled)
  const bf16* extra;   // [B, H, W, C] or null
  const bf16* wq;      // [CP, heads * 96]
  const float* bq;     // [heads * 96]
  const float* qs;     // [heads] v2's q scales, or null
  const bf16* wp;      // [heads * 32, CP]
  const float* bp;     // [C]
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  const bf16* w1;      // [CP, HP]
  const float* b1;     // [HP]
  const bf16* w2;      // [HP, CP]
  const float* b2;     // [C]
  const float* bias;   // [heads, n, n]
  bf16* qkv;           // scratch [nwin, n16, heads * 96]
  bf16* y;             // [B, H, W, C]
  int H, W, C, CP, heads, hidden, HP, ws, shift, n, n16, nwh, nww;
  int ldy, ldo, lds, ldh;              // shared-memory row strides
  // byte offsets of the regions: attention output, LN / scores, hidden,
  // weight ring or the head's q / K / V, per-warp fragment stages
  int off_o, off_a, off_hid, off_ring, off_stage;
};

constexpr int LDQ = HDP + 8;   // row stride of the staged q / K / V

// v2's qkv epilogue on a warp's finished 16 x 32 fragment, one head slot
// (columns c0 .. c0 + 31): + the bias, and for a q or k slot each row
// divided by max(its L2 norm, 1e-12), q then times its head's scale, all
// in float32 (the JAX kernel's order).  Lane l holds rows l / 4 (e = 0, 1)
// and l / 4 + 8 (e = 2, 3); a row's 32 values lie on one quad.
__device__ __forceinline__ void cosine_slot(float (&acc)[4][4], int c0,
                                            const float* bq,
                                            const float* qs) {
  const int lane = threadIdx.x & 31;
  const int slot = c0 / HDP, j = slot % 3;
  float ss[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[t][e] += bq[c0 + 8 * t + 2 * (lane & 3) + (e & 1)];
      ss[e >> 1] += acc[t][e] * acc[t][e];
    }
  if (j == 2) return;   // v: the bias only (the same j for the whole warp)
  float d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    d[h] = fmaxf(sqrtf(ss[h]), 1e-12f);
  }
  const float m = j == 0 ? qs[slot / 3] : 1.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = acc[t][e] / d[e >> 1] * m;
}

constexpr int TPR = 8;   // threads a softmax row (the fastest of 8, 16, 32)

template <bool V2>
__global__ void __launch_bounds__(NT)
swin_block_kernel(const SwinArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* x2 = reinterpret_cast<float*>(smem);                   // [64, CP]
  bf16* ob = reinterpret_cast<bf16*>(smem + a.off_o);           // [64, ldo]
  bf16* ys = reinterpret_cast<bf16*>(smem + a.off_a);           // [64, ldy]
  float* S = reinterpret_cast<float*>(smem + a.off_a);          // [64, lds]
  bf16* hid = reinterpret_cast<bf16*>(smem + a.off_hid);        // [64, ldh]
  // v2: fc2 + b2 as float32 rows [64, CP] over ob and ys (free once proj
  // and fc1 have read them)
  float* f2 = reinterpret_cast<float*>(smem + a.off_o);
  bf16* ring = reinterpret_cast<bf16*>(smem + a.off_ring);
  // a head's q [64, LDQ], K and V [n16, LDQ] in the ring's space: two
  // heads' worth where they fit, so the next head loads during this one
  const int head_elems = (RB + 2 * a.n16) * LDQ;
  const int nbuf = 2 * head_elems <= RING_ELEMS ? 2 : 1;
  float* stage = reinterpret_cast<float*>(smem + a.off_stage) +
                 (threadIdx.x >> 5) * 256;

  const int win = blockIdx.x;
  const int wc = win % a.nww;
  const int wr = (win / a.nww) % a.nwh;
  const int b = win / (a.nww * a.nwh);
  const int QW = a.heads * 96;
  const int n = a.n, ws = a.ws, C = a.C;
  const int lane = threadIdx.x & 31;
  bf16* qkv = a.qkv + static_cast<size_t>(win) * a.n16 * QW;
  // element offset of token t's first channel in the image
  auto pix = [&](int t) -> size_t {
    const int hh = wr * ws + t / ws, ww = wc * ws + t % ws;
    return ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * C;
  };
  const BandMasks<TPR> masks(ws, a.shift, wr == a.nwh - 1, wc == a.nww - 1);

  // phase 1: LN1 (v2: the raw input) + qkv of every row block into the
  // scratch
  for (int r0 = 0; r0 < a.n16; r0 += RB) {
    const int nrt = min(4, (a.n16 - r0) / 16);
    layer_norm_rows<!V2>([&](int t) { return a.x + pix(t); }, r0, nrt * 16,
                         n, C, a.CP, a.g1, a.be1, ys, a.ldy);
    __syncthreads();
    bf16* dst = qkv + static_cast<size_t>(r0) * QW;
    if constexpr (V2) {
      gemm_weights<32>(ys, a.ldy, nrt, a.wq, QW, a.CP, QW, ring, stage,
                       [&](int r, int c, const float* v) {
        store_bf16x8(dst + static_cast<size_t>(r) * QW + c, v);
      }, [&](int, int c0, float (&acc)[4][4]) {
        cosine_slot(acc, c0, a.bq, a.qs);
      });
    } else {
      gemm_weights(ys, a.ldy, nrt, a.wq, QW, a.CP, QW, ring, stage,
                   [&](int r, int c, const float* v) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = v[i] + a.bq[c + i];
        store_bf16x8(dst + static_cast<size_t>(r) * QW + c, o);
      });
    }
  }

  for (int r0 = 0; r0 < a.n16; r0 += RB) {
    const int nrt = min(4, (a.n16 - r0) / 16);
    // phase 2: windowed attention, one head at a time.  Each head's copy
    // is two cp.async groups, q + K then V.
    auto fetch = [&](int h) {
      bf16* qs = ring + (h % nbuf) * head_elems;
      const bf16* qkv_h = qkv + h * 96;
      copy_rows_async(qs, LDQ, qkv_h + static_cast<size_t>(r0) * QW, QW,
                      nrt * 16, HDP);
      copy_rows_async(qs + RB * LDQ, LDQ, qkv_h + HDP, QW, a.n16, HDP);
      cp_async_commit();
      copy_rows_async(qs + (RB + a.n16) * LDQ, LDQ, qkv_h + 2 * HDP, QW,
                      a.n16, HDP);
      cp_async_commit();
    };
    if (nbuf == 2) fetch(0);
    for (int h = 0; h < a.heads; ++h) {
      const bf16* qs = ring + (h % nbuf) * head_elems;
      const bf16* ks = qs + RB * LDQ;
      const bf16* vs = ks + a.n16 * LDQ;
      // the next head's groups, if any, are behind this head's two
      const bool ahead = nbuf == 2 && h + 1 < a.heads;
      if (nbuf == 1) fetch(h);
      if (ahead) fetch(h + 1);
      if (ahead) cp_async_wait<3>(); else cp_async_wait<1>();
      __syncthreads();
      gemm_rows<true>(qs, LDQ, nrt, ks, LDQ, 2, a.n16 / 16,
                      [&](int rt, int ct, const Acc& acc) {
        wmma::store_matrix_sync(S + static_cast<size_t>(rt) * 16 * a.lds +
                                    ct * 16, acc, a.lds, wmma::mem_row_major);
      });
      __syncthreads();
      const float* bias_h = a.bias + static_cast<size_t>(h) * n * n;
      softmax_rows<TPR>(S, a.lds, nrt * 16, n - r0, n, a.n16, [&](int r) {
        const int q = min(r0 + r, n - 1);   // padded queries: any row
        return masks.row(q, bias_h + static_cast<size_t>(q) * n);
      });
      if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();
      __syncthreads();
      gemm_rows<false>(reinterpret_cast<const bf16*>(S), 2 * a.lds, nrt,
                       vs, LDQ, a.n16 / 16, 2,
                       [&](int rt, int ct, const Acc& acc) {
        each_run8(stage, rt, ct, acc, [&](int r, int c, const float* v) {
          store_bf16x8(ob + static_cast<size_t>(r) * a.ldo + h * HDP + c, v);
        });
      });
      __syncthreads();
    }

    // phase 3: proj + residuals, LN, MLP, residual.  The row block's x
    // (v1: float32, into x2) and extra (bf16, into the hidden rows' space)
    // are read first, a token row a warp; zero past the tokens and
    // channels.
    bf16* es = hid;
    for (int r = threadIdx.x >> 5; r < nrt * 16; r += NWARPS) {
      const int t = r0 + r;
      const size_t p = t < n ? pix(t) : 0;
      for (int c = lane; c < a.CP; c += 32) {
        const bool in = t < n && c < C;
        if constexpr (!V2)
          x2[static_cast<size_t>(r) * a.CP + c] =
              in ? __bfloat162float(a.x[p + c]) : 0.0f;
        if (a.extra != nullptr)
          es[static_cast<size_t>(r) * a.CP + c] =
              in ? a.extra[p + c] : __float2bfloat16(0.0f);
      }
    }
    gemm_weights(ob, a.ldo, nrt, a.wp, a.CP, a.heads * HDP, a.CP, ring,
                 stage, [&](int r, int c, const float* v) {
      float* xr = x2 + static_cast<size_t>(r) * a.CP + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (V2) {
          // LN1's input; the residuals follow
          xr[i] = c + i < C ? v[i] + a.bp[c + i] : 0.0f;
        } else {
          float o = xr[i] + v[i] + a.bp[c + i];
          if (a.extra != nullptr)
            o += __bfloat162float(es[static_cast<size_t>(r) * a.CP + c + i]);
          xr[i] = c + i < C ? o : 0.0f;
        }
      }
    });
    if constexpr (V2) {
      // x2 = x + LN1(proj + bp) [+ extra], and x2 in bf16 as fc1's input
      for (int r = threadIdx.x >> 5; r < nrt * 16; r += NWARPS) {
        const int t = r0 + r;
        float* xr = x2 + static_cast<size_t>(r) * a.CP;
        bf16* o = ys + static_cast<size_t>(r) * a.ldy;
        if (t >= n) {
          for (int c = lane; c < a.CP; c += 32) o[c] = __float2bfloat16(0.0f);
          continue;
        }
        float v[MAXC];
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int c = lane + 32 * i;
          v[i] = c < C ? xr[c] : 0.0f;
        }
        float mean, rstd;
        row_stats(v, C, mean, rstd);
        const bf16* xin = a.x + pix(t);
        const bf16* er = es + static_cast<size_t>(r) * a.CP;
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int c = lane + 32 * i;
          if (c >= a.CP) continue;
          float z = 0.0f;
          if (c < C) {
            z = __bfloat162float(xin[c]) +
                ((v[i] - mean) * rstd * a.g1[c] + a.be1[c]);
            if (a.extra != nullptr) z += __bfloat162float(er[c]);
          }
          xr[c] = z;
          o[c] = __float2bfloat16(z);
        }
      }
    } else {
      layer_norm_rows<true>(
          [&](int t) { return x2 + static_cast<size_t>(t - r0) * a.CP; },
          r0, nrt * 16, n, C, a.CP, a.g2, a.be2, ys, a.ldy);
    }
    __syncthreads();
    gemm_weights(ys, a.ldy, nrt, a.w1, a.HP, a.CP, a.HP, ring, stage,
                 [&](int r, int c, const float* v) {
      float g[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float u = v[i] + a.b1[c + i];
        g[i] = c + i < a.hidden ? gelu_erf(u) : 0.0f;
      }
      store_bf16x8(hid + static_cast<size_t>(r) * a.ldh + c, g);
    });
    // v1: the block's output rows into ys (free once fc1 has read it),
    // then out to the window's pixels, a token row a warp.  v2: fc2 + b2
    // into f2, then x2 + LN2 of each row out to the pixels.
    gemm_weights(hid, a.ldh, nrt, a.w2, a.CP, a.HP, a.CP, ring, stage,
                 [&](int r, int c, const float* v) {
      if constexpr (V2) {
        float* fr = f2 + static_cast<size_t>(r) * a.CP + c;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          fr[i] = c + i < C ? v[i] + a.b2[c + i] : 0.0f;
      } else {
        const float* xr = x2 + static_cast<size_t>(r) * a.CP + c;
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = xr[i] + v[i] + a.b2[c + i];
        store_bf16x8(ys + static_cast<size_t>(r) * a.ldy + c, o);
      }
    });
    for (int r = threadIdx.x >> 5; r < nrt * 16; r += NWARPS) {
      const int t = r0 + r;
      if (t >= n) continue;
      bf16* dst = a.y + pix(t);
      if constexpr (V2) {
        const float* fr = f2 + static_cast<size_t>(r) * a.CP;
        const float* xr = x2 + static_cast<size_t>(r) * a.CP;
        float v[MAXC];
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int c = lane + 32 * i;
          v[i] = c < C ? fr[c] : 0.0f;
        }
        float mean, rstd;
        row_stats(v, C, mean, rstd);
#pragma unroll
        for (int i = 0; i < MAXC; ++i) {
          const int c = lane + 32 * i;
          if (c < C)
            dst[c] = __float2bfloat16(
                xr[c] + ((v[i] - mean) * rstd * a.g2[c] + a.be2[c]));
        }
      } else {
        for (int c = lane; c < C; c += 32)
          dst[c] = ys[static_cast<size_t>(r) * a.ldy + c];
      }
    }
    __syncthreads();   // ys, x2 (and v2's f2) are the next row block's
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <bool V2>
int launch(const SwinArgs& a, int nwin, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel<V2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_kernel<V2><<<nwin, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, extra (or null), y: [B, H, W, C] bf16, H and W multiples of ws;
// wq [CP, heads*96], wp [heads*32, CP], w1 [CP, HP], w2 [HP, CP] bf16
// (CP, HP: C and hidden rounded up to 16, pads zero); bq [heads*96], b1
// [HP], bp, b2, g1, be1, g2, be2 [C], bias [heads, n, n] float32; scratch
// [B * (H/ws) * (W/ws), n16, heads*96] bf16.  post_norm selects the v2
// body, whose q scales qs [heads] float32 are given exactly then (null for
// v1).  Returns cudaErrorInvalidValue for shapes it does not take (n16 >
// 256, C > 256, C > 32 * heads, or more than the block's shared memory).
int hdrvae_swin_block(const void* x, const void* extra, const void* wq,
                      const void* bq, const void* qs, const void* wp,
                      const void* bp, const void* g1, const void* be1,
                      const void* g2, const void* be2, const void* w1,
                      const void* b1, const void* w2, const void* b2,
                      const void* bias, void* scratch, void* y, int B, int H,
                      int W, int C, int heads, int hidden, int ws, int shift,
                      int post_norm, void* stream) {
  SwinArgs a = {};
  a.n = ws * ws;
  a.n16 = round_up(a.n, 16);
  if (ws < 1 || H % ws || W % ws || a.n16 > 256 || C > HDP * heads ||
      C > MAXC * 32 || shift < 0 || shift >= ws || hidden < 1 ||
      (post_norm != 0) != (qs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.wq = static_cast<const bf16*>(wq);
  a.bq = static_cast<const float*>(bq);
  a.qs = static_cast<const float*>(qs);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.g1 = static_cast<const float*>(g1);
  a.be1 = static_cast<const float*>(be1);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.bias = static_cast<const float*>(bias);
  a.qkv = static_cast<bf16*>(scratch);
  a.y = static_cast<bf16*>(y);
  a.H = H;
  a.W = W;
  a.C = C;
  a.CP = round_up(C, 16);
  a.heads = heads;
  a.hidden = hidden;
  a.HP = round_up(hidden, 16);
  a.ws = ws;
  a.shift = shift;
  a.nwh = H / ws;
  a.nww = W / ws;
  a.ldy = a.CP + 8;
  a.ldo = heads * HDP + 8;
  a.lds = a.n16 + 4;
  a.ldh = a.HP + 8;
  const int x2_bytes = RB * a.CP * 4;
  const int o_bytes = RB * a.ldo * 2;
  const int y_bytes = RB * a.ldy * 2;
  const int s_bytes = RB * a.lds * 4;
  // the hidden rows, which first hold the row block's extra [64, CP]
  const int mlp_bytes = round_up(y_bytes, 128) + RB * std::max(a.ldh, a.CP) * 2;
  const int a_bytes = std::max(s_bytes, mlp_bytes);
  // the weight ring, or one head's q rows, K and V
  const int ring_bytes = std::max(RING_ELEMS, (RB + 2 * a.n16) * LDQ) * 2;
  a.off_o = round_up(x2_bytes, 128);
  a.off_a = a.off_o + round_up(o_bytes, 128);
  a.off_hid = a.off_a + round_up(y_bytes, 128);
  a.off_ring = a.off_a + round_up(a_bytes, 128);
  a.off_stage = a.off_ring + round_up(ring_bytes, 128);
  const int smem = a.off_stage + NWARPS * 256 * 4;
  // v2's float32 fc2 rows span the attention output and the LN rows
  if (smem > 232448 || (post_norm && a.off_o + x2_bytes > a.off_hid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwin = B * a.nwh * a.nww;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return post_norm ? launch<true>(a, nwin, smem, s)
                   : launch<false>(a, nwin, smem, s);
}

}  // extern "C"
