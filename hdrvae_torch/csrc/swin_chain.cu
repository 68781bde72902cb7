// The staged Swin chain: a v1 Swin block (SwinIR, HAT's HAB with the
// optional `extra` residual) as three kernels on Hopper's tensor cores
// (bf16 mma.sync and WMMA, float32 accumulation), 512 threads a block.
//
// Replaces the TPU kernels K10, K9 and K11 of the JAX package, the staged
// debugging tier of its fused block:
//   hdrvae/kernels/swin_attention.py::ln_qkv      (K10)  LN1 -> qkv
//   hdrvae/kernels/swin_attention.py::_attn_core  (K9)   softmax(q k^T +
//                                                         bias + masks) v
//   hdrvae/kernels/swin_attention.py::proj_mlp    (K11)  proj + residual
//                                                         [+ extra] -> LN2
//                                                         -> MLP + residual
// on an image [B, H, W, C] already rolled by -shift.  Each stage computes
// and rounds what K7 (swin_block.cu) computes and rounds at that point,
// with the same code, so the chain's output equals K7's.
//
// Between the kernels (nwin = B * (H / ws) * (W / ws) windows of n = ws *
// ws tokens, padded to n16 = 16 * ceil(n / 16) rows, rows >= n zero):
//   qkv [nwin, n16, heads * 96] bf16: column h * 96 + j * 32 + d is slot j
//       (q, k, v) of head h, dim d (head dim zero-padded to 32, the softmax
//       scale folded into q): K7's scratch layout;
//   o   [nwin, n16, heads * 32] bf16: head h's output at columns h * 32 ..
//       h * 32 + 31, the padded head-major rows the proj weights take.
// The window partition and merge happen in K10's and K11's addressing, so
// no [nwin, n, C] windows tensor exists in device memory.
//
// What bounds it on the H100: the chain writes and reads qkv (3 x the
// feature map at C = 180, padded head dims) and o through device memory,
// about 1.1 GB a SwinIR-M 512^2 block against K7's 0.2 GB, for the same
// ~0.16 TFLOP: bytes bound it (~0.33 ms at 3.35 TB/s).  What the split
// buys: K9 holds no weight ring, so at n = 64 four blocks share an SM
// (K7: one ~212 KB block), and K10 two; K11 keeps K7's MLP layout (one
// block an SM).  Every kernel takes 64 query rows of one window a block.
//  * K10, per (window, row block): LN1 rows in float32 -> bf16 in shared
//    memory -> qkv = y @ Wqkv + bqkv through K7's cp.async weight ring
//    (gemm_weights) -> bf16 rows of the window's qkv.
//  * K9, per (window, head, row block): q rows and K copied to shared
//    memory -> S = q k^T (float32, shared) -> + bias [heads, n, n] + -100
//    band masks in the last window row / column of a shifted grid (a
//    corner window takes both) -> float32 softmax, 8 threads a row, V
//    arriving over K's bytes meanwhile -> P in bf16 over S -> P v -> bf16.
//  * K11, per (window, row block): o rows, x (float32) and extra read ->
//    proj -> x2 = x + proj + bp [+ extra] -> LN2 -> fc1 + b1 -> exact GELU
//    (erff) -> fc2 -> x2 + out + b2 -> bf16 -> the window's pixels.

#include <algorithm>

#include "window_attention.cuh"

namespace {

using namespace winattn;

constexpr int LDQ = HDP + 8;   // row stride of the staged q / K / V
constexpr int TPR = 8;         // threads a softmax row, as in K7

// A window grid on an image [B, H, W, C] (C padded to CP).
struct Grid {
  int H, W, C, CP, ws, n, n16, nwh, nww;

  // element offset of token t of window win's first channel
  __device__ __forceinline__ size_t pix(int win, int t) const {
    const int wc = win % nww, wr = (win / nww) % nwh, b = win / (nww * nwh);
    const int hh = wr * ws + t / ws, ww = wc * ws + t % ws;
    return ((static_cast<size_t>(b) * H + hh) * W + ww) * C;
  }
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

constexpr int STAGE_BYTES = NWARPS * 256 * 4;   // per-warp fragment stages
constexpr int SMEM_MAX = 232448;

// ---------------------------------------------------------------------------
// K10: LN1 + qkv
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
              const float* __restrict__ bq, const float* __restrict__ g1,
              const float* __restrict__ be1, bf16* __restrict__ qkv,
              const Grid g, int QW, int ldy, int off_ring, int off_stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                   // [64, ldy]
  bf16* ring = reinterpret_cast<bf16*>(smem + off_ring);
  float* stage = reinterpret_cast<float*>(smem + off_stage) +
                 (threadIdx.x >> 5) * 256;
  const int win = blockIdx.x, r0 = blockIdx.y * RB;
  const int nrt = min(4, (g.n16 - r0) / 16);
  layer_norm_rows<true>([&](int t) { return x + g.pix(win, t); }, r0,
                        nrt * 16, g.n, g.C, g.CP, g1, be1, ys, ldy);
  __syncthreads();
  bf16* dst = qkv + (static_cast<size_t>(win) * g.n16 + r0) * QW;
  gemm_weights(ys, ldy, nrt, wq, QW, g.CP, QW, ring, stage,
               [&](int r, int c, const float* v) {
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = r0 + r < g.n ? v[i] + bq[c + i] : 0.0f;
    store_bf16x8(dst + static_cast<size_t>(r) * QW + c, o);
  });
}

// ---------------------------------------------------------------------------
// K9: the attention core
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT)
attn_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                 bf16* __restrict__ out, int heads, int ws, int shift, int n,
                 int n16, int nwh, int nww, int lds) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);                  // [64, lds]
  bf16* qs = reinterpret_cast<bf16*>(smem + RB * lds * 4);    // [64, LDQ]
  bf16* kv = qs + RB * LDQ;                                   // [n16, LDQ]
  float* stage = reinterpret_cast<float*>(kv + n16 * LDQ) +
                 (threadIdx.x >> 5) * 256;
  const int win = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * RB;
  const int nrt = min(4, (n16 - r0) / 16);
  const int QW = heads * 96;
  const bf16* src = qkv + static_cast<size_t>(win) * n16 * QW + h * 96;

  copy_rows_async(qs, LDQ, src + static_cast<size_t>(r0) * QW, QW, nrt * 16,
                  HDP);
  copy_rows_async(kv, LDQ, src + HDP, QW, n16, HDP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  gemm_rows<true>(qs, LDQ, nrt, kv, LDQ, 2, n16 / 16,
                  [&](int rt, int ct, const Acc& acc) {
    wmma::store_matrix_sync(S + static_cast<size_t>(rt) * 16 * lds + ct * 16,
                            acc, lds, wmma::mem_row_major);
  });
  __syncthreads();
  copy_rows_async(kv, LDQ, src + 2 * HDP, QW, n16, HDP);   // V over K
  cp_async_commit();

  const int wc = win % nww, wr = (win / nww) % nwh;
  const BandMasks<TPR> masks(ws, shift, wr == nwh - 1, wc == nww - 1);
  const float* bias_h = bias + static_cast<size_t>(h) * n * n;
  softmax_rows<TPR>(S, lds, nrt * 16, n - r0, n, n16, [&](int r) {
    const int q = min(r0 + r, n - 1);   // padded queries: any row
    return masks.row(q, bias_h + static_cast<size_t>(q) * n);
  });
  cp_async_wait<0>();
  __syncthreads();
  bf16* ob = out + (static_cast<size_t>(win) * n16 + r0) * heads * HDP +
             h * HDP;
  gemm_rows<false>(reinterpret_cast<const bf16*>(S), 2 * lds, nrt, kv, LDQ,
                   n16 / 16, 2, [&](int rt, int ct, const Acc& acc) {
    each_run8(stage, rt, ct, acc, [&](int r, int c, const float* v) {
      store_bf16x8(ob + static_cast<size_t>(r) * heads * HDP + c, v);
    });
  });
}

// ---------------------------------------------------------------------------
// K11: proj + residuals, LN2, MLP, residual
// ---------------------------------------------------------------------------

struct ProjArgs {
  const bf16* o;       // [nwin, n16, heads * 32]
  const bf16* x;       // [B, H, W, C] (rolled)
  const bf16* extra;   // [B, H, W, C] or null
  const bf16* wp;      // [heads * 32, CP]
  const float* bp;     // [C]
  const float* g2;
  const float* be2;
  const bf16* w1;      // [CP, HP]
  const float* b1;     // [HP]
  const bf16* w2;      // [HP, CP]
  const float* b2;     // [C]
  bf16* y;             // [B, H, W, C]
  Grid g;
  int OW, hidden, HP;
  int ldo, ldy, ldh;                   // shared-memory row strides
  // byte offsets of the regions: attention output, LN rows, hidden (first
  // the extra rows), weight ring, per-warp fragment stages
  int off_o, off_a, off_hid, off_ring, off_stage;
};

__global__ void __launch_bounds__(NT)
proj_mlp_kernel(const ProjArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* x2 = reinterpret_cast<float*>(smem);                 // [64, CP]
  bf16* ob = reinterpret_cast<bf16*>(smem + a.off_o);         // [64, ldo]
  bf16* ys = reinterpret_cast<bf16*>(smem + a.off_a);         // [64, ldy]
  bf16* hid = reinterpret_cast<bf16*>(smem + a.off_hid);      // [64, ldh]
  bf16* es = hid;                                             // [64, CP]
  bf16* ring = reinterpret_cast<bf16*>(smem + a.off_ring);
  float* stage = reinterpret_cast<float*>(smem + a.off_stage) +
                 (threadIdx.x >> 5) * 256;
  const Grid& g = a.g;
  const int win = blockIdx.x, r0 = blockIdx.y * RB;
  const int nrt = min(4, (g.n16 - r0) / 16);
  const int C = g.C, CP = g.CP, lane = threadIdx.x & 31;

  copy_rows_async(ob, a.ldo,
                  a.o + (static_cast<size_t>(win) * g.n16 + r0) * a.OW, a.OW,
                  nrt * 16, a.OW);
  cp_async_commit();
  // the row block's x (float32, into x2) and extra (bf16), a token row a
  // warp; zero past the tokens and channels
  for (int r = threadIdx.x >> 5; r < nrt * 16; r += NWARPS) {
    const int t = r0 + r;
    const size_t p = t < g.n ? g.pix(win, t) : 0;
    for (int c = lane; c < CP; c += 32) {
      const bool in = t < g.n && c < C;
      x2[static_cast<size_t>(r) * CP + c] =
          in ? __bfloat162float(a.x[p + c]) : 0.0f;
      if (a.extra != nullptr)
        es[static_cast<size_t>(r) * CP + c] =
            in ? a.extra[p + c] : __float2bfloat16(0.0f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  gemm_weights(ob, a.ldo, nrt, a.wp, CP, a.OW, CP, ring, stage,
               [&](int r, int c, const float* v) {
    float* xr = x2 + static_cast<size_t>(r) * CP + c;
    const bf16* er = es + static_cast<size_t>(r) * CP + c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float o = 0.0f;
      if (c + i < C) {
        o = xr[i] + v[i] + a.bp[c + i];
        if (a.extra != nullptr) o += __bfloat162float(er[i]);
      }
      xr[i] = o;
    }
  });
  layer_norm_rows<true>(
      [&](int t) { return x2 + static_cast<size_t>(t - r0) * CP; }, r0,
      nrt * 16, g.n, C, CP, a.g2, a.be2, ys, a.ldy);
  __syncthreads();
  gemm_weights(ys, a.ldy, nrt, a.w1, a.HP, CP, a.HP, ring, stage,
               [&](int r, int c, const float* v) {
    float h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = c + i < a.hidden ? gelu_erf(v[i] + a.b1[c + i]) : 0.0f;
    store_bf16x8(hid + static_cast<size_t>(r) * a.ldh + c, h);
  });
  // the block's output rows into ys (free once fc1 has read it), then out
  // to the window's pixels, a token row a warp
  gemm_weights(hid, a.ldh, nrt, a.w2, CP, a.HP, CP, ring, stage,
               [&](int r, int c, const float* v) {
    const float* xr = x2 + static_cast<size_t>(r) * CP + c;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = c + i < C ? xr[i] + v[i] + a.b2[c + i] : 0.0f;
    store_bf16x8(ys + static_cast<size_t>(r) * a.ldy + c, o);
  });
  for (int r = threadIdx.x >> 5; r < nrt * 16; r += NWARPS) {
    const int t = r0 + r;
    if (t >= g.n) continue;
    bf16* dst = a.y + g.pix(win, t);
    for (int c = lane; c < C; c += 32)
      dst[c] = ys[static_cast<size_t>(r) * a.ldy + c];
  }
}

// The grid of an image, or false for shapes the kernels do not take.
bool make_grid(Grid& g, int H, int W, int C, int heads, int ws) {
  g = {};
  g.n = ws * ws;
  g.n16 = round_up(g.n, 16);
  if (ws < 1 || H % ws || W % ws || g.n16 > 256 || heads < 1 ||
      C > HDP * heads || C > MAXC * 32)
    return false;
  g.H = H;
  g.W = W;
  g.C = C;
  g.CP = round_up(C, 16);
  g.ws = ws;
  g.nwh = H / ws;
  g.nww = W / ws;
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// K10.  x [B, H, W, C] bf16 (rolled), H and W multiples of ws; wq [CP,
// heads*96] bf16, bq [heads*96], g1 / be1 [C] float32; qkv [B * (H/ws) *
// (W/ws), n16, heads*96] bf16.  cudaErrorInvalidValue for shapes it does
// not take (n16 > 256, C > 256, C > 32 * heads).
int hdrvae_swin_ln_qkv(const void* x, const void* wq, const void* bq,
                       const void* g1, const void* be1, void* qkv, int B,
                       int H, int W, int C, int heads, int ws, void* stream) {
  Grid g;
  if (B < 1 || !make_grid(g, H, W, C, heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldy = g.CP + 8;
  const int off_ring = round_up(RB * ldy * 2, 128);
  const int off_stage = off_ring + round_up(RING_ELEMS * 2, 128);
  const int smem = off_stage + STAGE_BYTES;
  cudaError_t err = allow_smem(ln_qkv_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * g.nwh * g.nww, (g.n16 + RB - 1) / RB);
  ln_qkv_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const float*>(bq), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<bf16*>(qkv), g, heads * 96,
      ldy, off_ring, off_stage);
  return static_cast<int>(cudaGetLastError());
}

// K9.  qkv [nwin, n16, heads*96] bf16 (nwin a multiple of nwh * nww, the
// windows of each image in row-major order), bias [heads, n, n] float32,
// out [nwin, n16, heads*32] bf16; n = ws * ws, 0 <= shift < ws.
// cudaErrorInvalidValue for n16 > 256 or a bad grid.
int hdrvae_swin_attn_core(const void* qkv, const void* bias, void* out,
                          int nwin, int heads, int ws, int shift, int nwh,
                          int nww, void* stream) {
  const int n = ws * ws, n16 = round_up(n, 16);
  if (ws < 1 || n16 > 256 || heads < 1 || shift < 0 || shift >= ws ||
      nwh < 1 || nww < 1 || nwin < 1 || nwin % (nwh * nww))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lds = n16 + 4;
  const int smem = RB * lds * 4 + (RB + n16) * LDQ * 2 + STAGE_BYTES;
  cudaError_t err = allow_smem(attn_core_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nwin, heads, (n16 + RB - 1) / RB);
  attn_core_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<bf16*>(out), heads, ws, shift, n, n16, nwh, nww, lds);
  return static_cast<int>(cudaGetLastError());
}

// K11.  o [nwin, n16, heads*32] bf16; x, extra (or null), y [B, H, W, C]
// bf16 (rolled); wp [heads*32, CP], w1 [CP, HP], w2 [HP, CP] bf16 (CP, HP:
// C and hidden rounded up to 16, pads zero); b1 [HP], bp, b2, g2, be2 [C]
// float32.  cudaErrorInvalidValue for shapes it does not take (as K10, or
// more than the block's shared memory).
int hdrvae_swin_proj_mlp(const void* o, const void* x, const void* extra,
                         const void* wp, const void* bp, const void* g2,
                         const void* be2, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* y, int B, int H,
                         int W, int C, int heads, int hidden, int ws,
                         void* stream) {
  ProjArgs a = {};
  if (B < 1 || hidden < 1 || !make_grid(a.g, H, W, C, heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  a.o = static_cast<const bf16*>(o);
  a.x = static_cast<const bf16*>(x);
  a.extra = static_cast<const bf16*>(extra);
  a.wp = static_cast<const bf16*>(wp);
  a.bp = static_cast<const float*>(bp);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.y = static_cast<bf16*>(y);
  a.OW = heads * HDP;
  a.hidden = hidden;
  a.HP = round_up(hidden, 16);
  a.ldo = a.OW + 8;
  a.ldy = a.g.CP + 8;
  a.ldh = a.HP + 8;
  const int x2_bytes = RB * a.g.CP * 4;
  const int o_bytes = RB * a.ldo * 2;
  const int y_bytes = RB * a.ldy * 2;
  // the hidden rows, which first hold the row block's extra [64, CP]
  const int mlp_bytes =
      round_up(y_bytes, 128) + RB * std::max(a.ldh, a.g.CP) * 2;
  a.off_o = round_up(x2_bytes, 128);
  a.off_a = a.off_o + round_up(o_bytes, 128);
  a.off_hid = a.off_a + round_up(y_bytes, 128);
  a.off_ring = a.off_a + round_up(mlp_bytes, 128);
  a.off_stage = a.off_ring + round_up(RING_ELEMS * 2, 128);
  const int smem = a.off_stage + STAGE_BYTES;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(proj_mlp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.g.nwh * a.g.nww, (a.g.n16 + RB - 1) / RB);
  proj_mlp_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
