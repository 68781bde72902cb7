// The staged Swin chain: a v1 Swin block (SwinIR, HAT's HAB with the
// optional `extra` residual) as three kernels on Hopper's tensor cores
// (bf16 operands, float32 accumulation).
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
// and rounds what K7 (swin_block.cu) computes and rounds at that point
// (K9 normalizes P by a divide where K7 multiplies by the reciprocal: one
// rounding apart), so the chain's output stays within the fast tier's
// budget of K7's.
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
// ~0.16 TFLOP: bytes bound it (~0.33 ms at 3.35 TB/s).
//  * K10, per (window, row block), 512 threads: LN1 rows in float32 ->
//    bf16 in shared memory -> qkv = y @ Wqkv + bqkv through K7's cp.async
//    weight ring (gemm_weights, mma.sync) -> bf16 rows of the window's qkv.
//  * K9 (wgmma, TMA): bound by reading qkv and writing o once (0.12 ms at
//    SwinIR-M's 512^2 tile).  Persistent blocks of one warpgroup, each
//    with one head and a stream of windows: a window's q, k and v columns
//    of that head come by one TMA box each (n64 = 64 ceil(n16 / 64) rows
//    of 64 bytes, the 64-byte swizzle, zero past n16) into a ring of two
//    to four slots, so every byte of qkv is read once and K and V serve
//    every row block of the window.  Per 64-row block S = q K^T by wgmma
//    m64n64k16 over the n64 / 64 key tiles (q and K from shared memory),
//    the whole score row in registers (32 floats a key tile); + the
//    position bias (at n <= 64 the head's table resident in shared
//    memory, else read from L2) and the -100 band masks in the last
//    window row / column of a shifted grid (a corner window takes both;
//    each key's band bits computed once); the exact softmax by quad
//    shuffles, e = exp2(s log2 e - max log2 e), p = e / l correctly
//    rounded (the JAX kernel's divide: a reciprocal of l a row and one
//    FMA correction an element) and rounded to bf16 in wgmma's A layout; O = P V by m64n32k16 with A from registers and V
//    MN-major; O in bf16 through a staging atom and one TMA store (rows
//    past n16 are not written, padded rows get p = 0, so O = 0).
//  * K11, per (window, row block), 512 threads: o rows, x (float32) and
//    extra read -> proj -> x2 = x + proj + bp [+ extra] -> LN2 -> fc1 + b1
//    -> exact GELU (erff) -> fc2 -> x2 + out + b2 -> bf16 -> the window's
//    pixels.

#include <algorithm>

#include "hopper.cuh"
#include "window_attention.cuh"

namespace {

using namespace winattn;

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

namespace k9 {

constexpr int NT = 128;       // one warpgroup a block
constexpr int LDBIAS = 72;    // a resident bias row's floats (conflict-free)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const float* bias;   // [heads, n, n]
  int heads, ws, shift, n, nwh, nww, nwin;
  int nstream;         // window streams: gridDim.x / heads
  int ns;              // ring slots
  int offRing, offOut, offBar;   // bytes from the aligned base
};

// NTK = n64 / 64 key tiles (and row blocks) of a window: the whole score
// row of a query stays in registers (32 NTK floats a thread).
template <int NTK>
__global__ void __launch_bounds__(NT, NTK == 1 ? 3 : 2)
attn_core_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap omap, const Args a) {
  constexpr int SLOT = 3 * NTK * ATOM;   // q, k, v of one (window, head)
  constexpr bool RESIDENT = NTK == 1;    // the head's bias in shared memory
  // aligned by an offset from smem_raw, so every access stays in the
  // shared window
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  const uint32_t ring_s = base_s + a.offRing, bar_s = base_s + a.offBar;
  unsigned char* out_p = smem + a.offOut;
  const uint32_t out_s = base_s + a.offOut;
  auto full = [&](int s) { return bar_s + 8 * s; };

  const int tid = threadIdx.x, wl = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = a.n, h = blockIdx.x % a.heads;
  const int stream = blockIdx.x / a.heads;
  const int nitems =
      stream < a.nwin ? (a.nwin - 1 - stream) / a.nstream + 1 : 0;
  const float* bias_h = a.bias + static_cast<size_t>(h) * n * n;

  // the head's [n, n] bias as [64][LDBIAS] floats, zero past n
  float* bias_s = reinterpret_cast<float*>(smem);
  if (RESIDENT)
    for (int e = tid; e < 64 * 64; e += NT) {
      const int r = e >> 6, c = e & 63;
      bias_s[r * LDBIAS + c] = r < n && c < n ? bias_h[r * n + c] : 0.0f;
    }
  // item i (window stream + i * nstream, this block's head): its q, k and
  // v columns, n64 rows each (zero past n16), into slot i % ns
  auto put = [&](int i) {
    const int win = stream + i * a.nstream;
    const uint32_t dst = ring_s + (i % a.ns) * SLOT, fb = full(i % a.ns);
    hopper::mbar_expect_tx(fb, SLOT);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      hopper::tma_load_3d(dst + j * NTK * ATOM, &qmap, fb, h * 96 + j * HDP,
                          0, win);
  };
  if (tid == 0) {
    for (int s = 0; s < a.ns; ++s) hopper::mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(a.ns, nitems); ++i) put(i);
  auto wg_sync = [&]() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); };

  // this thread's 16 keys of each key tile (8 j + 2 t + e, bit 2 j + e):
  // in the band of the last window row (column) of a shifted grid, past n
  const int band = a.ws - a.shift;
  const float inv_ws = 1.0f / a.ws;
  uint32_t kband[NTK], kdead[NTK];
#pragma unroll
  for (int kt = 0; kt < NTK; ++kt) {
    kband[kt] = kdead[kt] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 64 * kt + 8 * j + 2 * t + e;
        const int kr = __float2int_rz((key + 0.5f) * inv_ws);
        const int kc = key - kr * a.ws;
        kband[kt] |= (static_cast<uint32_t>(kr >= band) |
                      static_cast<uint32_t>(kc >= band) << 16)
                     << (2 * j + e);
        kdead[kt] |= static_cast<uint32_t>(key >= n) << (2 * j + e);
      }
  }

  for (int i = 0; i < nitems; ++i) {
    const int win = stream + i * a.nstream;
    const uint32_t q_s = ring_s + (i % a.ns) * SLOT;
    const uint32_t k_s = q_s + NTK * ATOM, v_s = k_s + NTK * ATOM;
    const int wr = (win / a.nww) % a.nwh, wc = win % a.nww;
    const bool lr = a.shift > 0 && wr == a.nwh - 1;
    const bool lc = a.shift > 0 && wc == a.nww - 1;
    hopper::mbar_wait(full(i % a.ns), (i / a.ns) & 1);
#pragma unroll 1
    for (int rb = 0; rb < NTK; ++rb) {
      // S = q K^T of the row block over every key tile
      float s[NTK][32];
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
        for (int e = 0; e < 32; ++e) s[kt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt) hopper::fence_operands<32>(s[kt]);
      hopper::wgmma_fence();
      const uint64_t dq = desc64(q_s + rb * ATOM);
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          hopper::wgmma_ss<64, 0>(s[kt], dq + 2 * kk,
                                  desc64(k_s + kt * ATOM) + 2 * kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt) hopper::fence_operands<32>(s[kt]);

      // + bias and band masks, the exact softmax of each row (a quad's
      // four lanes hold it), p = e / l rounded to bf16 as P V's A operand.
      // A window of the last row or column of a shifted grid takes the
      // band masks, the others the bias alone (a branch uniform over the
      // warpgroup); keys past n only where n is no multiple of 64
      uint32_t pa[NTK][16];
      const bool masked = lr || lc, ragged = n < 64 * NTK;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * rb + 16 * wl + g + 8 * r;
        const int q = min(row, n - 1);   // padded queries: any row
        const float* brow = RESIDENT ? bias_s + q * LDBIAS : bias_h + q * n;
        // the row's bias (key 64 kt + 8 (b / 2) + 2 t + b % 2 at [kt][b]),
        // every load issued before any is used
        float bb[NTK][16];
#pragma unroll
        for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int key = 64 * kt + 8 * (b >> 1) + 2 * t + (b & 1);
            bb[kt][b] = RESIDENT ? brow[key]
                                 : (key < n ? __ldg(brow + key) : 0.0f);
          }
        if (masked) {
          // keys masked against this query: on the other side of the band
          const int qr = q / a.ws, qc = q - qr * a.ws;
          const uint32_t mrow = lr ? (qr >= band ? 0xffffu : 0u) : 0u;
          const uint32_t mcol = lc ? (qc >= band ? 0xffffu : 0u) : 0u;
#pragma unroll
          for (int kt = 0; kt < NTK; ++kt) {
            const uint32_t xr = lr ? (kband[kt] & 0xffffu) ^ mrow : 0u;
            const uint32_t xc = lc ? (kband[kt] >> 16) ^ mcol : 0u;
#pragma unroll
            for (int b = 0; b < 16; ++b) {
              float& v = s[kt][4 * (b >> 1) + 2 * r + (b & 1)];
              if ((xr >> b) & 1u) bb[kt][b] += -100.0f;
              v += bb[kt][b];
              if ((xc >> b) & 1u) v += -100.0f;
            }
          }
        } else {
#pragma unroll
          for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
            for (int b = 0; b < 16; ++b)
              s[kt][4 * (b >> 1) + 2 * r + (b & 1)] += bb[kt][b];
        }
        if (ragged)
#pragma unroll
          for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
            for (int b = 0; b < 16; ++b)
              if ((kdead[kt] >> b) & 1u)
                s[kt][4 * (b >> 1) + 2 * r + (b & 1)] = -INFINITY;
        // the row's max and sum over four partials each (short chains)
        float mp[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
          for (int b = 0; b < 16; ++b)
            mp[b & 3] = fmaxf(mp[b & 3], s[kt][4 * (b >> 1) + 2 * r + (b & 1)]);
        float m = fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        // exp(v - m) as exp2(v log2 e - m log2 e): one FFMA and ex2
        const float m2 = m * LOG2E;
        float lp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            float& v = s[kt][4 * (b >> 1) + 2 * r + (b & 1)];
            v = exp2f(fmaf(v, LOG2E, -m2));
            lp[b & 3] += v;
          }
        float l = (lp[0] + lp[1]) + (lp[2] + lp[3]);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        // p = e / l, correctly rounded (what __fdiv_rn gives): q = e rl
        // with rl = 1 / l rounded, then one FMA correction (Markstein)
        const bool live = row < n;
        const float rl = __frcp_rn(l);
        auto div = [&](float e) { return fmaf(fmaf(-e * rl, l, e), rl, e * rl); };
#pragma unroll
        for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            pa[kt][2 * j + r] =
                live ? pack_bf16(div(s[kt][4 * j + 2 * r]),
                                 div(s[kt][4 * j + 2 * r + 1]))
                     : 0u;
      }

      // O = P V, P from registers, V MN-major
      float o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0.0f;
      hopper::fence_operands<16>(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < NTK; ++kt)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          hopper::wgmma_rs_n32<1>(o, pa[kt] + 4 * ks,
                                  desc64(v_s + kt * ATOM) + ks * 64);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<16>(o);

      // O in bf16 through the staging atom, out by one TMA store (rows
      // past n16 are not written)
      if (tid == 0) hopper::bulk_wait_read();   // the last store read it
      wg_sync();
      frag_to_atom(out_p, o, wl, g, t);
      hopper::fence_proxy_async();
      wg_sync();   // and every warp is done with the slot's q / K / V
      if (tid == 0) {
        hopper::tma_store_3d(&omap, out_s, h * HDP, 64 * rb, win);
        hopper::bulk_commit();
        if (rb == NTK - 1 && i + a.ns < nitems) put(i + a.ns);
      }
    }
  }
  if (tid == 0) hopper::bulk_wait();
}

// The ring slots of the NTK instance (a block's shared memory sets how
// many blocks share an SM: three at NTK 1, two above).
constexpr int slots(int ntk) { return ntk == 1 ? 4 : 2; }

template <int NTK>
int launch(const void* qkv, const float* bias, void* out, Args a,
           cudaStream_t stream) {
  constexpr int SLOT = 3 * NTK * ATOM;
  const int n16 = round_up(a.n, 16);
  CUtensorMap qmap, omap;
  const uint64_t qd[3] = {static_cast<uint64_t>(a.heads) * 96,
                          static_cast<uint64_t>(n16),
                          static_cast<uint64_t>(a.nwin)};
  const uint32_t qb[3] = {HDP, 64 * NTK, 1};
  const uint64_t od[3] = {static_cast<uint64_t>(a.heads) * HDP,
                          static_cast<uint64_t>(n16),
                          static_cast<uint64_t>(a.nwin)};
  const uint32_t ob[3] = {HDP, 64, 1};
  int err = hopper::make_map(&qmap, qkv, 3, qd, qb,
                             CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = hopper::make_map(&omap, out, 3, od, ob, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  a.bias = bias;
  a.ns = slots(NTK);
  a.offRing = NTK == 1 ? 64 * LDBIAS * 4 : 0;   // 18 KB: 1 KB aligned
  a.offOut = a.offRing + a.ns * SLOT;
  a.offBar = a.offOut + ATOM;
  const int smem = a.offBar + 8 * a.ns + 1024;   // + the alignment
  auto kernel = attn_core_kernel<NTK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a persistent grid of window streams, each its heads' blocks
  a.nstream = std::max(1, std::min(a.nwin, sms * per_sm / a.heads));
  kernel<<<a.nstream * a.heads, NT, smem, stream>>>(qmap, omap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k9

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
  k9::Args a = {};
  a.heads = heads;
  a.ws = ws;
  a.shift = shift;
  a.n = n;
  a.nwh = nwh;
  a.nww = nww;
  a.nwin = nwin;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n16 + 63) / 64) {
    case 1: return k9::launch<1>(qkv, b, out, a, s);
    case 2: return k9::launch<2>(qkv, b, out, a, s);
    case 3: return k9::launch<3>(qkv, b, out, a, s);
    default: return k9::launch<4>(qkv, b, out, a, s);
  }
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
