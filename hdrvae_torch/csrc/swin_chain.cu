// The staged Swin chain: a v1 Swin block (SwinIR, HAT's HAB with the
// optional `extra` residual) as three kernels on Hopper's tensor cores
// (bf16 operands, float32 accumulation, every product by wgmma).
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
//  * K10 and K11 share one skeleton, K7's (swin_block.cu) without its
//    attention: persistent blocks, one an SM, of two warpgroups, each
//    warpgroup one 64-row block of a window (a row block pair an item; a
//    window of more than 64 tokens is several row blocks, the last ragged
//    at ws 10 / 12).  Both warpgroups walk the same weight tiles in the
//    same order, so each tile read from L2 serves 128 rows.  The tiles
//    come by TMA (K7's tiles, swizzles and maps: [CK x 32] slices of
//    Wqkv / W1 with the 64-byte swizzle, [32 x CK] slices of Wp / W2 in
//    64-column boxes with the 128-byte swizzle; CK = 64, 192 or 256, TMA
//    zero-fills past the padded weights) through a ring of up to eight
//    slots, each with a full mbarrier and a count of the warps done with
//    it: the last of the eight to release a slot refills it (no producer
//    warp: a ninth warp caps every thread at 168 registers).  Products
//    are issued one step ahead of the epilogue that reads them, so the
//    tensor cores work while the CUDA cores round, normalize and store.
//  * K10 (bound by writing qkv: 0.09 ms of its 0.12 at SwinIR-M's 512^2
//    tile): LN1 of the row block a quad a row (a row's loads in flight
//    together, the next row block's window rows prefetched into L2) into
//    the K-major A tile; per head q, k and v by three wgmma m64n32k16
//    chains (head h + 1's issued before head h's epilogue), + bq in
//    float32 (pad rows t >= n zero: K9 relies on them), bf16 into one of
//    two staging tiles, out by three TMA boxes of [64 x 32] (rows past n16
//    clipped), so stores stay in flight behind the next head's products.
//  * K11 (products and bytes alike: ~0.09 ms each at SwinIR-M's 512^2
//    tile, 0.10 ms of products with the pads): the row block's o by TMA
//    (one box a head, zero past n16: the K-major A tile of proj as it
//    is), loaded for the next row block as soon as proj has read it, and
//    that row block's x / extra rows prefetched into L2; proj by wgmma
//    m64n64k16, x + proj + bp [+ extra] in float32 on the fragments (x2,
//    kept in the accumulator, which fc2 then adds to), LN2 with the row
//    statistics by quad shuffles into the A tile; the MLP in 32-unit
//    chunks, fc1 two chunks ahead of fc2: fc1 + b1 -> exact GELU (erff)
//    -> bf16 A fragments in registers -> fc2 += by wgmma m64n64k16 with A
//    from registers (no hidden activation in memory); + b2 -> bf16 by
//    16-byte stores of whole window rows where window rows are 16-byte
//    multiples (ws 8 and 16 at C = 180), else by bf16 pairs.
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
//    FMA correction an element) and rounded to bf16 in wgmma's A layout;
//    O = P V by m64n32k16 with A from registers and V MN-major; O in bf16
//    through a staging atom and one TMA store (rows past n16 are not
//    written, padded rows get p = 0, so O = 0).
// Rounding points are the JAX kernels' and K7's: LN rows, q/k/v, the GELU
// output and the block output in bf16; x2, residuals, LN statistics and
// every sum in float32.

#include <algorithm>

#include "hopper.cuh"
#include "window_attention.cuh"

namespace {

using namespace winattn;

int round_up(int v, int m) { return (v + m - 1) / m * m; }

constexpr int SMEM_MAX = 232448;

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
// K10 and K11: persistent blocks of two warpgroups on one weight ring
// ---------------------------------------------------------------------------

namespace rows {

constexpr int NT = 256;         // two warpgroups

struct Args {
  const bf16* x;       // [B, H, W, C] (rolled)
  const bf16* extra;   // K11: [B, H, W, C] or null
  bf16* y;             // K11: [B, H, W, C]
  const float* bq;     // K10: [heads * 96]
  const float* g;      // LN1 (K10) or LN2 (K11) affine, [C]
  const float* be;
  const float* bp;     // K11: [C]
  const float* b1;     // K11: [HP]
  const float* b2;     // K11: [C]
  int H, W, C, heads, hidden, ws, n, n16, nwh, nww;
  int nrb;             // row blocks a window: ceil(n16 / 64)
  int blocks;          // row blocks of every window
  int nwg;             // warpgroups a block: 1 or 2
  int items;           // nwg row blocks each
  int nchunk;          // K11: the MLP's 32-unit chunks, rounded up to even
  int nhead;           // K10: heads rounded up to even
  int ntile;           // weight tiles an item
  int pf;              // window rows of x (and extra) may be prefetched
  int vec_out;         // K11's output leaves by 16-byte stores of window rows
  int regW;            // bytes of a warpgroup's region
  int offPar, offRing, offBar;   // bytes from the aligned base
};

// Element offset of token tok of window win (the windows of every image
// in row-major order).
__device__ __forceinline__ size_t pix(const Args& a, int win, int tok) {
  const int per = a.nwh * a.nww;
  const int b = win / per, wr = (win % per) / a.nww, wc = win % a.nww;
  const int hh = wr * a.ws + tok / a.ws, ww = wc * a.ws + tok % a.ws;
  return ((static_cast<size_t>(b) * a.H + hh) * a.W + ww) * a.C;
}

// Into L2, while this row block computes: the window rows of x (and
// extra) that hold row block rb's tokens (one thread issues it).
__device__ __forceinline__ void prefetch_rows(const Args& a, int rb) {
  if (!a.pf || rb >= a.blocks) return;
  const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);
  const int last = min(tok0 + 64, a.n) - 1;
  for (int r = tok0 / a.ws; r <= last / a.ws; ++r) {
    const size_t px = pix(a, win, r * a.ws);
    prefetch_l2(a.x + px, a.ws * a.C * 2);
    if (a.extra != nullptr) prefetch_l2(a.extra + px, a.ws * a.C * 2);
  }
}

// The weight ring: tile j of a block's walk lands by TMA in slot j % NS
// (NS a constant of the kernel: slot and phase without a divide);
// every consumer warp waits for the tiles it multiplies by and releases
// each once its wgmmas on it are done (waited for: their reads of the slot
// are over, so no fence), and the last of the block's warps to release a
// slot refills it with tile j + NS (put, by that warp's lane 0).
template <int NS>
struct Ring {
  uint32_t slots, bars;
  int* released;       // a slot's count of releases
  int tb, total, warps;

  __device__ __forceinline__ uint32_t at(int j) const {
    return slots + (static_cast<unsigned>(j) % NS) * tb;
  }
  __device__ __forceinline__ uint32_t full(int j) const {
    return bars + 8 * (static_cast<unsigned>(j) % NS);
  }
  __device__ __forceinline__ void wait(int j) const {
    hopper::mbar_wait(full(j), (static_cast<unsigned>(j) / NS) & 1);
  }
  template <typename Put>
  __device__ __forceinline__ void release(int j, Put put) const {
    if ((threadIdx.x & 31) != 0) return;
    const int s = static_cast<unsigned>(j) % NS;
    if (atomicAdd(released + s, 1) == warps - 1) {
      atomicExch(released + s, 0);
      if (j + NS < total) put(j + NS);
    }
  }
};

// The block's ring, its barriers (and extra_bars more after them)
// initialized and the first tiles on their way: put(j, ring) issues tile
// j's copies.
template <int NS, typename Put>
__device__ __forceinline__ Ring<NS> start_ring(const Args& a,
                                               unsigned char* smem,
                                               uint32_t base_s, int tb,
                                               int extra_bars, Put put) {
  const int mine = blockIdx.x < a.items
                       ? (a.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  Ring<NS> r{base_s + a.offRing, base_s + a.offBar,
             reinterpret_cast<int*>(smem + a.offBar + 8 * NS), tb,
             mine * a.ntile, 4 * a.nwg};
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(r.full(s), 1);
      r.released[s] = 0;
    }
    for (int b = 0; b < extra_bars; ++b)
      hopper::mbar_init(base_s + a.offBar + 16 * NS + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(NS, r.total); ++j) put(j, r);
  return r;
}

// the LN rows as wgmma's K-major A at k16 step ks
__device__ __forceinline__ uint64_t a_step(int ks) {
  return static_cast<uint64_t>(((ks >> 1) * ATOM + (ks & 1) * 32) >> 4);
}

// The channel pairs 8 k + 2 t (k < NP) of a token row as raw bf16 pairs,
// zero past C, every load issued before any is used.
template <int NP>
__device__ __forceinline__ void load_row(uint32_t (&u)[NP], const bf16* row,
                                         int t, int C) {
  if ((C & 1) == 0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 8 * k + 2 * t;
      u[k] = c < C ? __ldg(reinterpret_cast<const unsigned*>(row + c)) : 0u;
    }
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 8 * k + 2 * t;
      const uint32_t lo = c < C ? __ldg(h + c) : 0u;
      const uint32_t hi = c + 1 < C ? __ldg(h + c + 1) : 0u;
      u[k] = lo | hi << 16;
    }
  }
}

// K10's ring: a slot a head's three slices, the next head's waited for
// while this one's products run.
constexpr int K10_SLOTS = 3;

// K10: LN1 + qkv.  Tile i of an item is head i's q, k and v slices of
// Wqkv ([CK x 32] each, side by side: one [CK x 96] B operand); heads past
// `heads` (odd heads, rounded up to even) are zero tiles whose products
// are dropped.
template <int NCT>
__global__ void __launch_bounds__(NT, 1)
ln_qkv_kernel(const __grid_constant__ CUtensorMap wqmap,
              const __grid_constant__ CUtensorMap qmap, const Args a) {
  constexpr int CK = 64 * NCT;     // channels, padded for the tiles
  constexpr int TB = 64 * CK;      // bytes of a [CK x 32] slice
  constexpr int KS = CK / 16;      // k16 steps over the channels
  constexpr int NP = CK / 8;       // channel pairs a lane holds of a row
  // aligned by an offset from smem_raw, so every access stays in the
  // shared window
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = a.n;

  // the bias and LayerNorm vectors in shared memory, zero past the heads
  // and C
  float* bq_s = reinterpret_cast<float*>(smem + a.offPar);
  float* g_s = bq_s + a.nhead * 96;
  float* be_s = g_s + CK;
  for (int i = tid; i < a.nhead * 96; i += NT)
    bq_s[i] = i < a.heads * 96 ? a.bq[i] : 0.0f;
  for (int c = tid; c < CK; c += NT) {
    g_s[c] = c < a.C ? a.g[c] : 0.0f;
    be_s[c] = c < a.C ? a.be[c] : 0.0f;
  }
  auto put = [&](int j, const Ring<K10_SLOTS>& r) {
    const int h = j % a.ntile;
    hopper::mbar_expect_tx(r.full(j), 3 * TB);
#pragma unroll
    for (int s = 0; s < 3; ++s)
      hopper::tma_load_3d(r.at(j) + s * TB, &wqmap, r.full(j),
                          h * 96 + s * HDP, 0, 0);
  };
  const Ring<K10_SLOTS> ring =
      start_ring<K10_SLOTS>(a, smem, base_s, 3 * TB, 0, put);
  auto refill = [&](int j) { put(j, ring); };

  const int w = warp >> 2;   // this warpgroup
  if (w >= a.nwg) return;
  const int wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool lead = (tid & 127) == 0;
  // this warpgroup's region: the LN rows (the A tile), then two staging
  // buffers of three atoms (q, k, v of a head)
  unsigned char* regA = smem + w * a.regW;
  const uint32_t A_s = base_s + w * a.regW;
  unsigned char* stage = regA + 128 * CK;
  const uint32_t stage_s = A_s + 128 * CK;
  const uint64_t dA = desc64(A_s);
  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  };
  auto block_of = [&](int item) {   // past the row blocks: the last again
    return min(a.nwg * item + w, a.blocks - 1);
  };

  // this thread's two rows (16 wl + g, + 8) of a row block as raw bf16
  // pairs (lane 4 g + t holds channels 8 k + 2 t, + 1), the next row
  // block's loaded while this one multiplies
  uint32_t xw[2][NP];
  auto load_x = [&](int item) {
    const int rb = block_of(item);
    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tok = tok0 + 16 * wl + g + 8 * i;
      load_row(xw[i], a.x + (tok < n ? pix(a, win, tok) : 0), t, a.C);
    }
  };
  // LN1 of the rows into region A as bf16, their statistics by quad
  // shuffles (a row's channels lie on one quad); zero past the tokens and
  // channels
  auto ln_rows = [&](int tok0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * wl + g + 8 * i;
      const bool live = tok0 + r < n;
      float2 v[NP];
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        v[k] = unpack_bf16(xw[i][k]);
        sum += v[k].x;
        sum += v[k].y;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / a.C;
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = 8 * k + 2 * t;
        const float d0 = v[k].x - mean, d1 = v[k].y - mean;
        if (c < a.C) q += d0 * d0;
        if (c + 1 < a.C) q += d1 * d1;
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      const float rstd = rsqrtf(q / a.C + 1e-5f);
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = 8 * k + 2 * t;
        const float y0 = live && c < a.C
                             ? (v[k].x - mean) * rstd * g_s[c] + be_s[c]
                             : 0.0f;
        const float y1 = live && c + 1 < a.C
                             ? (v[k].y - mean) * rstd * g_s[c + 1] +
                                   be_s[c + 1]
                             : 0.0f;
        *reinterpret_cast<uint32_t*>(regA + swz(r, c)) = pack_bf16(y0, y1);
      }
    }
  };

  if (blockIdx.x < a.items) load_x(blockIdx.x);
  int stores = 0;   // this warpgroup's store groups: the staging buffer
  int j0 = 0;       // the item's first tile
  for (int item = blockIdx.x; item < a.items;
       item += gridDim.x, j0 += a.ntile) {
    const int rbi = a.nwg * item + w;
    const bool real = rbi < a.blocks;   // else a repeat that stores nothing
    const int rb = real ? rbi : a.blocks - 1;
    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);
    wg_sync();   // the last item's products have read region A
    ln_rows(tok0);
    if (item + gridDim.x < a.items) load_x(item + gridDim.x);
    hopper::fence_proxy_async();   // the rows, before wgmma reads them
    wg_sync();

    // head h's q | k | v into f: one wgmma chain of N = 96 (the three
    // slices one atom apart)
    auto issue = [&](int h, float (&f)[48]) {
      const int j = j0 + h;
      ring.wait(j);
#pragma unroll
      for (int e = 0; e < 48; ++e) f[e] = 0.0f;
      hopper::fence_operands<48>(f);
      hopper::wgmma_fence();
      const uint64_t db = hopper::make_desc(ring.at(j), TB, 512,
                                            hopper::LAYOUT_B64);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hopper::wgmma_ss<96, 1>(f, dA + a_step(ks), db + ks * 64);
      hopper::wgmma_commit();
    };
    // head h's products (waited for): its tiles released, + bq in float32
    // (rows past n zero), bf16 into a staging buffer, out by three TMA
    // boxes (rows past n16 clipped)
    auto epi = [&](int h, float (&f)[48]) {
      hopper::fence_operands<48>(f);
      ring.release(j0 + h, refill);
      if (h >= a.heads) return;   // a pad head: zero tiles
      const int b = stores & 1;
      if (lead) hopper::bulk_wait_read<1>();   // buffer b's last store
      wg_sync();
      const float* bqh = bq_s + h * 96;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        float v[16];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool live = tok0 + 16 * wl + g + 8 * i < n;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[4 * jj + 2 * i + e] =
                  live ? f[16 * s + 4 * jj + 2 * i + e] +
                             bqh[s * HDP + 8 * jj + 2 * t + e]
                       : 0.0f;
          }
        frag_to_atom(stage + (3 * b + s) * ATOM, v, wl, g, t);
      }
      hopper::fence_proxy_async();
      wg_sync();
      if (lead) {
        if (real)
#pragma unroll
          for (int s = 0; s < 3; ++s)
            hopper::tma_store_3d(&qmap, stage_s + (3 * b + s) * ATOM,
                                 h * 96 + s * HDP, tok0, win);
        hopper::bulk_commit();
      }
      ++stores;
    };
    // head h + 1's products run while head h's epilogue stores (nhead is
    // even, so the two accumulators alternate by a fixed pattern)
    float f[2][48];
    issue(0, f[0]);
    for (int h = 0; h + 2 < a.nhead; h += 2) {
      issue(h + 1, f[1]);
      hopper::wgmma_wait<1>();
      epi(h, f[0]);
      issue(h + 2, f[0]);
      hopper::wgmma_wait<1>();
      epi(h + 1, f[1]);
    }
    issue(a.nhead - 1, f[1]);
    hopper::wgmma_wait<1>();
    epi(a.nhead - 2, f[0]);
    hopper::wgmma_wait<0>();
    epi(a.nhead - 1, f[1]);
  }
  if (lead) hopper::bulk_wait();
}

// K11's MLP chunk: 32 hidden units (the accumulators of two chunks in
// flight beside x2's fill the registers).
constexpr int CW = 32;

// K11's ring slots: the MLP holds two tiles while it waits for a third;
// eight where they fit beside two warpgroups' regions (all but CK = 256).
__host__ __device__ constexpr int k11_slots(int nct) {
  return nct == 4 ? 4 : 8;
}

// K11: proj + residuals, LN2, MLP, residual.  Tile i of an item is head
// i's proj rows ([32 x CK] of Wp) for i < heads, then the MLP's W1 ([CK x
// 32]) and W2 ([32 x CK]) slices of 32-unit chunks in the order the
// products are issued (fc1 two chunks ahead of fc2: fc1_0, fc1_1, fc2_0,
// fc1_2, fc2_1, ..., fc2_{nchunk-1}); chunks past the hidden width are
// zero tiles whose GELU outputs are dropped.
__device__ __forceinline__ int fc1_tile(int c) { return c < 2 ? c : 2 * c - 1; }
__device__ __forceinline__ int fc2_tile(int c, int nchunk) {
  return c < nchunk - 1 ? 2 * c + 2 : 2 * nchunk - 1;
}

template <int NCT>
__global__ void __launch_bounds__(NT, 1)
proj_mlp_kernel(const __grid_constant__ CUtensorMap omap,
                const __grid_constant__ CUtensorMap wpmap,
                const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap w2map, const Args a) {
  constexpr int CK = 64 * NCT, KS = CK / 16, NP = CK / 8;
  constexpr int TB = 64 * CK;            // bytes of a weight tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.heads, n = a.n;

  // the bias and LayerNorm vectors in shared memory, zero past C / hidden
  float* bp_s = reinterpret_cast<float*>(smem + a.offPar);
  float* g_s = bp_s + CK;
  float* be_s = g_s + CK;
  float* b2_s = be_s + CK;
  float* b1_s = b2_s + CK;
  for (int c = tid; c < CK; c += NT) {
    const bool in = c < a.C;
    bp_s[c] = in ? a.bp[c] : 0.0f;
    g_s[c] = in ? a.g[c] : 0.0f;
    be_s[c] = in ? a.be[c] : 0.0f;
    b2_s[c] = in ? a.b2[c] : 0.0f;
  }
  for (int c = tid; c < CW * a.nchunk; c += NT)
    b1_s[c] = c < a.hidden ? a.b1[c] : 0.0f;

  constexpr int NS = k11_slots(NCT);
  auto put = [&](int j, const Ring<NS>& r) {
    const int i = j % a.ntile, m = i - H;
    const uint32_t dst = r.at(j), fb = r.full(j);
    hopper::mbar_expect_tx(fb, TB);
    if (i < H) {
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)
        hopper::tma_load_3d(dst + jn * 4096, &wpmap, fb, 64 * jn, HDP * i,
                            0);
    } else if (m < 2 || ((m & 1) != 0 && m != 2 * a.nchunk - 1)) {
      const int c = m < 2 ? m : (m + 1) >> 1;   // fc1(c)
      hopper::tma_load_3d(dst, &w1map, fb, CW * c, 0, 0);
    } else {
      const int c = m == 2 * a.nchunk - 1 ? a.nchunk - 1 : (m - 2) >> 1;
#pragma unroll
      for (int jn = 0; jn < NCT; ++jn)   // fc2(c)
        hopper::tma_load_3d(dst + jn * 4096, &w2map, fb, 64 * jn, CW * c,
                            0);
    }
  };
  const Ring<NS> ring = start_ring<NS>(a, smem, base_s, TB, 2, put);
  auto refill = [&](int j) { put(j, ring); };

  const int w = warp >> 2;   // this warpgroup
  if (w >= a.nwg) return;
  const int wl = warp & 3, g = lane >> 2, t = lane & 3;
  const bool lead = (tid & 127) == 0;
  // this warpgroup's region: A the LN2 rows (fc1's operand; then the
  // output rows), O the attention output (one atom a head: proj's operand)
  unsigned char* regA = smem + w * a.regW;
  const uint32_t A_s = base_s + w * a.regW;
  const uint32_t O_s = A_s + 128 * CK;
  const uint32_t obar = base_s + a.offBar + 16 * NS + 8 * w;
  // bit 2 k + e: this lane's column 8 k + 2 t + e lies before C
  uint64_t cols = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cols |= static_cast<uint64_t>(8 * k + 2 * t + e < a.C) << (2 * k + e);
  const uint64_t dA = desc64(A_s), dO = desc64(O_s);
  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  };
  auto block_of = [&](int item) {   // past the row blocks: the last again
    return min(a.nwg * item + w, a.blocks - 1);
  };
  // row block rb's o rows into region O by TMA, one box a head (zero past
  // n16)
  auto load_o = [&](int rb) {
    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);
    hopper::mbar_expect_tx(obar, H * ATOM);
    for (int h = 0; h < H; ++h)
      hopper::tma_load_3d(O_s + h * ATOM, &omap, obar, h * HDP, tok0, win);
  };
  if (lead && blockIdx.x < a.items) load_o(block_of(blockIdx.x));

  int j0 = 0;   // the item's first tile
  int k = 0;    // items done: the o barrier's phase
  for (int item = blockIdx.x; item < a.items;
       item += gridDim.x, j0 += a.ntile, ++k) {
    const int rbi = a.nwg * item + w;
    const bool real = rbi < a.blocks;   // else a repeat that stores nothing
    const int rb = real ? rbi : a.blocks - 1;
    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);

    // this thread's two rows of x as raw bf16 pairs, in flight while proj
    // runs
    size_t px[2];
    bool live[2];
    uint32_t xw[2][NP];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tok = tok0 + 16 * wl + g + 8 * i;
      live[i] = tok < n;
      px[i] = live[i] ? pix(a, win, tok) : 0;
      load_row(xw[i], a.x + px[i], t, a.C);
    }

    // proj: acc = o Wp over the heads' atoms (the next head's tile
    // loading as each is released)
    float acc[NCT][32];
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[jn][e] = 0.0f;
      hopper::fence_operands<32>(acc[jn]);
    }
    hopper::mbar_wait(obar, k & 1);
    for (int h = 0; h < H; ++h) {
      const int j = j0 + h;
      ring.wait(j);
      hopper::wgmma_fence();
      const uint64_t db = desc128(ring.at(j));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
          hopper::wgmma_ss<64, 1>(acc[jn], dO + ((h * ATOM + kk * 32) >> 4),
                                  db + ((jn * 4096 + kk * 2048) >> 4));
      hopper::wgmma_commit();
      if (h > 0) {
        hopper::wgmma_wait<1>();
        ring.release(j - 1, refill);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) hopper::fence_operands<32>(acc[jn]);
    ring.release(j0 + H - 1, refill);
    wg_sync();   // every warp's proj has read region O (and the last
                 // item's stores region A)
    if (lead && item + gridDim.x < a.items) {
      load_o(block_of(item + gridDim.x));
      prefetch_rows(a, a.nwg * (item + gridDim.x) + w);
    }

    // x2 = x + proj + bp [+ extra] in float32 on the fragments (it stays
    // in acc, which fc2 then adds to; past C every term is an exact zero),
    // its row statistics by quad shuffles (a row's columns lie on one
    // quad), LN2's rows into region A as bf16 (zero past C: g and be are)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * wl + g + 8 * i;
      uint32_t ew[NP];   // extra's row (a row at a time: registers)
      if (a.extra != nullptr) load_row(ew, a.extra + px[i], t, a.C);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = 8 * k + 2 * t;
        const float2 xv = unpack_bf16(xw[i][k]);
        const float2 bv = *reinterpret_cast<const float2*>(bp_s + c);
        float& v0 = acc[k >> 3][4 * (k & 7) + 2 * i];
        float& v1 = acc[k >> 3][4 * (k & 7) + 2 * i + 1];
        v0 = xv.x + v0 + bv.x;
        v1 = xv.y + v1 + bv.y;
        if (a.extra != nullptr) {
          const float2 ev = unpack_bf16(ew[k]);
          v0 += ev.x;
          v1 += ev.y;
        }
        sum += v0;
        sum += v1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / a.C;
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[k >> 3][4 * (k & 7) + 2 * i + e] - mean;
          if ((cols >> (2 * k + e)) & 1u) q += d * d;
        }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      const float rstd = live[i] ? rsqrtf(q / a.C + 1e-5f) : 0.0f;
      const float shift = live[i] ? 1.0f : 0.0f;   // dead rows: zero
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int c = 8 * k + 2 * t;
        const float2 gv = *reinterpret_cast<const float2*>(g_s + c);
        const float2 bv = *reinterpret_cast<const float2*>(be_s + c);
        const float v0 = acc[k >> 3][4 * (k & 7) + 2 * i];
        const float v1 = acc[k >> 3][4 * (k & 7) + 2 * i + 1];
        *reinterpret_cast<uint32_t*>(regA + swz(r, c)) =
            pack_bf16((v0 - mean) * rstd * gv.x + bv.x * shift,
                      (v1 - mean) * rstd * gv.y + bv.y * shift);
      }
    }
    hopper::fence_proxy_async();   // the rows, before wgmma reads them
    wg_sync();

    // the MLP in CW-unit chunks, fc1 two chunks ahead of fc2: fc1(c) ->
    // + b1 -> GELU -> bf16 A in registers -> fc2(c) += into acc.  Chunk
    // c's fc1 accumulator and A fragments are h1[c % 2] and ha[c % 2]
    // (nchunk is even, so a loop step takes two chunks).  The wait before
    // chunk c leaves fc2(c - 1) and fc1(c + 1) in flight.
    const int jm = j0 + H;
    float h1[2][CW / 2];
    uint32_t ha[2][CW / 4];
    auto fc1 = [&](int c, float (&h)[CW / 2]) {
      const int j = jm + fc1_tile(c);
      ring.wait(j);
#pragma unroll
      for (int e = 0; e < CW / 2; ++e) h[e] = 0.0f;
      hopper::fence_operands<CW / 2>(h);
      hopper::wgmma_fence();
      const uint64_t db = desc64(ring.at(j));
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);
      hopper::wgmma_commit();
    };
    // chunk c once fc1(c) is done (and fc2(c - 2) with it): GELU, the two
    // tiles released, fc2(c) issued
    auto fc2 = [&](int c, float (&h)[CW / 2], uint32_t (&u)[CW / 4]) {
      hopper::fence_operands<CW / 2>(h);
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(b1_s + CW * c + 8 * j + 2 * t);
#pragma unroll
        for (int i = 0; i < 2; ++i)   // pad units: GELU(0 + 0) = 0
          u[2 * j + i] = pack_bf16(gelu_erf(h[4 * j + 2 * i] + bv.x),
                                   gelu_erf(h[4 * j + 2 * i + 1] + bv.y));
      }
      ring.release(jm + fc1_tile(c), refill);
      if (c >= 2) ring.release(jm + fc2_tile(c - 2, a.nchunk), refill);
      const int j2 = jm + fc2_tile(c, a.nchunk);
      ring.wait(j2);
      hopper::fence_operands<CW / 4>(u);
      hopper::wgmma_fence();
      const uint64_t db = desc128(ring.at(j2));
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk)
#pragma unroll
        for (int jn = 0; jn < NCT; ++jn)
          hopper::wgmma_rs_n64<1>(acc[jn], u + 4 * kk,
                                  db + ((jn * 4096 + kk * 2048) >> 4));
      hopper::wgmma_commit();
    };
    fc1(0, h1[0]);
    hopper::wgmma_commit();   // an empty group in fc2(-1)'s place
    fc1(1, h1[1]);
    int c = 0;
    for (; c + 2 < a.nchunk; c += 2) {
      hopper::wgmma_wait<2>();
      fc2(c, h1[0], ha[0]);
      fc1(c + 2, h1[0]);
      hopper::wgmma_wait<2>();
      fc2(c + 1, h1[1], ha[1]);
      fc1(c + 3, h1[1]);
    }
    hopper::wgmma_wait<2>();
    fc2(c, h1[0], ha[0]);
    hopper::wgmma_wait<1>();
    fc2(c + 1, h1[1], ha[1]);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int jn = 0; jn < NCT; ++jn) hopper::fence_operands<32>(acc[jn]);
    hopper::fence_operands<CW / 4>(ha[0]);
    hopper::fence_operands<CW / 4>(ha[1]);
    ring.release(jm + fc2_tile(c, a.nchunk), refill);
    ring.release(jm + fc2_tile(c + 1, a.nchunk), refill);

    // the output x2 + fc2 + b2 in bf16: staged as [64 tokens][C] in region
    // A (free: every fc1 is done) and out by 16-byte stores of window rows,
    // or stored as bf16 pairs
    auto out = [&](int i, int k) {
      const float2 bv = *reinterpret_cast<const float2*>(b2_s + 8 * k + 2 * t);
      return make_float2(acc[k >> 3][4 * (k & 7) + 2 * i] + bv.x,
                         acc[k >> 3][4 * (k & 7) + 2 * i + 1] + bv.y);
    };
    if (a.vec_out) {   // C even: a pair lies before C or past it
      wg_sync();   // every warp's fc1 has read region A
      if (real)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!live[i]) continue;
          unsigned char* row = regA + 2 * (16 * wl + g + 8 * i) * a.C;
#pragma unroll
          for (int k = 0; k < NP; ++k)
            if ((cols >> (2 * k)) & 1u) {
              const float2 o = out(i, k);
              *reinterpret_cast<uint32_t*>(row + 2 * (8 * k + 2 * t)) =
                  pack_bf16(o.x, o.y);
            }
        }
    } else if (real) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const float2 o = out(i, k);
          store_pair(a.y + px[i], 8 * k + 2 * t, a.C, o.x, o.y);
        }
      }
    }
    if (a.vec_out) {
      wg_sync();
      if (real) {
        // a window row's pixels are ws * C contiguous channels: 16-byte
        // chunks of it across the warpgroup
        const int rows_w = min(64, n - tok0) / a.ws;
        const int per = a.ws * a.C / 8;
        bf16* y0 = a.y + pix(a, win, tok0);
        for (int row = 0; row < rows_w; ++row) {
          uint4* dst = reinterpret_cast<uint4*>(
              y0 + static_cast<size_t>(row) * a.W * a.C);
          const uint4* src = reinterpret_cast<const uint4*>(
              regA + 2 * row * a.ws * a.C);
          for (int ch = tid & 127; ch < per; ch += 128) dst[ch] = src[ch];
        }
      }
    }
  }
}

// The image side of both kernels' arguments, or false for shapes they do
// not take (n16 > 256, C > 256, C > 32 * heads).
bool geometry(Args& a, const void* x, int B, int H, int W, int C, int heads,
              int ws) {
  a.n = ws * ws;
  a.n16 = round_up(a.n, 16);
  if (B < 1 || ws < 1 || H % ws || W % ws || a.n16 > 256 || heads < 1 ||
      C < 1 || C > HDP * heads || C > MAXC * 32)
    return false;
  a.x = static_cast<const bf16*>(x);
  a.H = H;
  a.W = W;
  a.C = C;
  a.heads = heads;
  a.ws = ws;
  a.nwh = H / ws;
  a.nww = W / ws;
  a.nrb = (a.n16 + 63) / 64;
  a.blocks = B * a.nwh * a.nww * a.nrb;
  return true;
}

// Window rows of 16-byte multiples at 16-byte offsets in the image.
bool rows16(const Args& a) {
  return a.C % 2 == 0 && (a.ws * a.C) % 8 == 0 && (a.W * a.C) % 8 == 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The block's shared-memory plan: nwg warpgroup regions of reg bytes, the
// vectors (par bytes), a ring of ns tb-byte slots and its barriers (+
// extra barriers); false if it does not fit.
bool plan(Args& a, int nwg, int reg, int par, int tb, int ns, int extra_bars,
          int& smem) {
  a.nwg = nwg;
  a.regW = round_up(reg, 1024);
  a.offPar = nwg * a.regW;
  a.offRing = a.offPar + round_up(par, 1024);
  a.offBar = a.offRing + ns * tb;
  smem = a.offBar + 16 * ns + 8 * extra_bars + 1024;   // + the alignment
  a.items = (a.blocks + nwg - 1) / nwg;
  return smem <= SMEM_MAX;
}

// The persistent grid: a block an SM, at most one an item.
int grid_size(const Args& a, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = std::max(1, std::min(sms, a.items));
  return static_cast<int>(e);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int NCT>
int launch_ln_qkv(const CUtensorMap* maps, const Args& a, int smem,
                  int grid, cudaStream_t s) {
  int e = prepare(ln_qkv_kernel<NCT>, smem);
  if (e != 0) return e;
  ln_qkv_kernel<NCT><<<grid, NT, smem, s>>>(maps[0], maps[1], a);
  return static_cast<int>(cudaGetLastError());
}

template <int NCT>
int launch_proj_mlp(const CUtensorMap* maps, const Args& a, int smem,
                    int grid, cudaStream_t s) {
  int e = prepare(proj_mlp_kernel<NCT>, smem);
  if (e != 0) return e;
  proj_mlp_kernel<NCT><<<grid, NT, smem, s>>>(maps[0], maps[1], maps[2],
                                               maps[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rows

}  // namespace

extern "C" {

// K10.  x [B, H, W, C] bf16 (rolled), H and W multiples of ws; wq [CP,
// heads*96] bf16, bq [heads*96], g1 / be1 [C] float32; qkv [B * (H/ws) *
// (W/ws), n16, heads*96] bf16.  cudaErrorInvalidValue for shapes it does
// not take (n16 > 256, C > 256, C > 32 * heads, or more than the block's
// shared memory).
int hdrvae_swin_ln_qkv(const void* x, const void* wq, const void* bq,
                       const void* g1, const void* be1, void* qkv, int B,
                       int H, int W, int C, int heads, int ws, void* stream) {
  rows::Args a = {};
  if (!rows::geometry(a, x, B, H, W, C, heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bq = static_cast<const float*>(bq);
  a.g = static_cast<const float*>(g1);
  a.be = static_cast<const float*>(be1);
  a.nhead = round_up(heads, 2);
  a.ntile = a.nhead;
  // channels padded to CK = 64, 192 or 256 (the pads are zeros, exact)
  const int nct = C <= 64 ? 1 : C <= 192 ? 3 : 4, CK = 64 * nct;
  // a warpgroup's LN rows and two staging buffers of three atoms
  const int reg = 128 * CK + 6 * ATOM, par = 4 * (a.nhead * 96 + 2 * CK);
  int smem = 0;
  const int tb = 3 * 64 * CK;
  if (!rows::plan(a, 2, reg, par, tb, rows::K10_SLOTS, 0, smem) &&
      !rows::plan(a, 1, reg, par, tb, rows::K10_SLOTS, 0, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  int e = rows::grid_size(a, grid);
  if (e != 0) return e;
  // Wqkv in [CK x 32] tiles (64-byte swizzle, zero past the padded
  // extents); qkv in [64 x 32] boxes, rows past n16 not written
  CUtensorMap maps[2];
  const uint64_t wd[3] = {uint64_t(heads) * 96, uint64_t(round_up(C, 16)),
                          1};
  const uint32_t wb[3] = {HDP, uint32_t(CK), 1};
  const uint64_t qd[3] = {uint64_t(heads) * 96, uint64_t(a.n16),
                          uint64_t(a.blocks / a.nrb)};
  const uint32_t qb[3] = {HDP, 64, 1};
  e = hopper::make_map(&maps[0], wq, 3, wd, wb, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = hopper::make_map(&maps[1], qkv, 3, qd, qb, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != 0) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nct) {
    case 1: return rows::launch_ln_qkv<1>(maps, a, smem, grid, s);
    case 3: return rows::launch_ln_qkv<3>(maps, a, smem, grid, s);
    default: return rows::launch_ln_qkv<4>(maps, a, smem, grid, s);
  }
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
  rows::Args a = {};
  if (hidden < 1 || !rows::geometry(a, x, B, H, W, C, heads, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  a.extra = static_cast<const bf16*>(extra);
  a.y = static_cast<bf16*>(y);
  a.g = static_cast<const float*>(g2);
  a.be = static_cast<const float*>(be2);
  a.bp = static_cast<const float*>(bp);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.hidden = hidden;
  const int nct = C <= 64 ? 1 : C <= 192 ? 3 : 4, CK = 64 * nct;
  a.nchunk = round_up((hidden + rows::CW - 1) / rows::CW, 2);
  a.ntile = heads + 2 * a.nchunk;
  const bool rows16 = rows::rows16(a);
  a.pf = rows16 && rows::aligned16(x) &&
         (extra == nullptr || rows::aligned16(extra));
  // whole window rows in each row block
  a.vec_out = rows16 && (a.n <= 64 || 64 % ws == 0) && rows::aligned16(y);
  // a warpgroup's LN2 rows and o (one atom a head); two o barriers
  const int reg = 128 * CK + heads * ATOM;
  const int par = 4 * (4 * CK + rows::CW * a.nchunk);
  const int tb = 64 * CK, ns = rows::k11_slots(nct);
  int smem = 0;
  if (!rows::plan(a, 2, reg, par, tb, ns, 2, smem) &&
      !rows::plan(a, 1, reg, par, tb, ns, 2, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  int e = rows::grid_size(a, grid);
  if (e != 0) return e;
  // o in [64 x 32] boxes (64-byte swizzle, zero past n16); the weights as
  // K7 takes them: wp and w2 in [32 x 64] boxes (128-byte swizzle), w1 in
  // [CK x 32] slices (64-byte swizzle), zero past the padded extents
  const uint64_t CP = round_up(C, 16), HP = round_up(hidden, 16);
  CUtensorMap maps[4];
  const uint64_t od[3] = {uint64_t(heads) * HDP, uint64_t(a.n16),
                          uint64_t(a.blocks / a.nrb)};
  const uint64_t pd[3] = {CP, uint64_t(heads) * HDP, 1};
  const uint64_t d1[3] = {HP, CP, 1}, d2[3] = {CP, HP, 1};
  const uint32_t box_o[3] = {HDP, 64, 1}, box_a[3] = {HDP, uint32_t(CK), 1};
  const uint32_t box_b[3] = {64, HDP, 1};
  e = hopper::make_map(&maps[0], o, 3, od, box_o, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = hopper::make_map(&maps[1], wp, 3, pd, box_b,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = hopper::make_map(&maps[2], w1, 3, d1, box_a,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = hopper::make_map(&maps[3], w2, 3, d2, box_b,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nct) {
    case 1: return rows::launch_proj_mlp<1>(maps, a, smem, grid, s);
    case 3: return rows::launch_proj_mlp<3>(maps, a, smem, grid, s);
    default: return rows::launch_proj_mlp<4>(maps, a, smem, grid, s);
  }
}

}  // extern "C"
