// Single-head flash attention for the decoder's mid block:
//   out = softmax(q k^T / sqrt(C)) v,  q, k, v [B, N, C], out float32.
//
// Replaces K3 of the JAX package,
// hdrvae/kernels/attention.py::spatial_attention_pallas (body
// _flash_kernel): one query tile loops over every key tile with an online
// softmax in float32, so the N x N score matrix never exists (at a 2048^2
// decode N = 65,536 and it would take 16 GiB).
//
// What bounds it on the H100: 4*N^2*C flops against 4*N*C values read per
// query tile pass; at N = 16,384 and C = 512 that is far above the ridge,
// so the bound is the arithmetic rate.  C = 512 is above the head sizes
// that fused attention libraries handle, which is why the port writes its
// own.  Three kernels, one per dot mode of the tiers:
//
//  * flash_bf16 (fast tier): bf16 q, k, v; S = q k^T and P v on the tensor
//    cores through WMMA (bf16 operands, float32 accumulation; P is rounded
//    to bf16 for its product, as the TPU's DEFAULT dot does).  32 queries
//    by 128 keys per step with 8 warps.  The 32 x C output accumulator
//    stays in registers (each warp owns 16 rows x C/4 columns); its
//    per-row online-softmax rescale needs the row of every accumulator
//    element, which the kernel reads off a probe fragment loaded from a
//    matrix of row indices, so it assumes nothing about WMMA's layout.
//    Tiles arrive by cp.async; the V tile loads while the softmax runs.
//  * flash_3pass (mixed tier): what _flash_kernel computes in HIGH, the
//    3-pass bf16x3 split of _dot3 (:43).  q is scaled by C^-1/2 in
//    float32 and then split (hi = bf16(x), lo = bf16(x - hi)), as :131
//    does; S = hi.hi + hi.lo + lo.hi and, after the online float32
//    softmax, P v the same way with P split, each dot's three products
//    accumulating into one float32 accumulator on mma.sync m16n8k16 (bf16
//    operands, float32 accumulation; each run of mmas is kept short and
//    added to its sum with round-to-nearest, since the tensor cores
//    truncate).  Each operand is split exactly once,
//    because converting per use, not the extra passes, set the time of the
//    bf16x3 product K12 measured: the q block into hi / lo tiles when it
//    loads, each K and V tile as it lands (float32 global -> registers ->
//    two bf16 stores), P in registers as it is stored.  64 queries by 32
//    keys a step, 8 warps; at C = 512 q takes 130 KB as hi + lo and the K
//    / V tile (V replaces K once the scores are done) 65 KB, ~215 KB in
//    all: one block an SM.  A warp computes a 16 x 16 block of S and owns
//    16 rows x C / 2 columns of the output in registers (128 floats at C =
//    512), so S and P v each read their operands through ldmatrix and no
//    C split or recompute of S is needed.  Bound on the H100: 3 x 4 N^2 C
//    operations on the tensor cores; the design is bound instead by its
//    shared-memory reads (~1.5 KB a 16 x 8 x 16 triple of mmas) and by the
//    K / V tile loads, which stop the block at its barriers.
//  * flash_f32 (parity tier): exact float32 dot products with FMAs on the
//    CUDA cores, never TF32 (HIGHEST).  64 queries by 32 keys per step;
//    each thread computes a 2 x 4 block of scores and keeps a 16-row x
//    8-column block of the output in registers, so shared-memory reads per
//    FMA stay low.
//
// Ragged N is handled by masking: keys at or past N score -inf (and their
// rows load as zero), queries at or past N are computed on zeros and not
// stored.  No padded copy and no flag channel.
//
// key_valid (the JAX kernel's key_valid=, a shape-bucketed decode's pad
// exclusion): an optional [N] byte per key, shared by the batch, nullptr
// for none.  A key whose byte is 0 scores -inf like a key past N: one byte
// load per key and step.  The JAX kernel adds -1e12 * scale to such a
// score through a flag channel, whose weight exp(-1e12 scale - m) is 0 in
// float32, so both give the softmax over the live keys alone.  With an
// arbitrary mask a step can see only dead keys for a row before any live
// one; the running max is then still -inf and exp(-inf - -inf) would be
// NaN, so the online softmax takes 0 as its reference while the max is
// -inf (every weight and the rescale are then 0).  That never happens
// without a mask (key 0 is live) and leaves the unmasked arithmetic as it
// was.

#include "window_attention.cuh"

#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// 16-byte global -> shared copy; zero-fills when !valid (no bytes read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// whether key `key` takes part in the softmax: below N and, given a mask,
// marked live
__device__ __forceinline__ bool key_live(const unsigned char* kvalid,
                                         int key, int N) {
  return key < N && (kvalid == nullptr || __ldg(kvalid + key) != 0);
}

// the online softmax's reference max: m, or 0 while every key seen is dead
__device__ __forceinline__ float softmax_ref(float m) {
  return m == -INFINITY ? 0.0f : m;
}

// rows [row0, row0 + rows) of a [N, C] matrix (elem-byte elements) into
// shared memory with row stride ld elements; rows at or past N are zero.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src,
                                                int row0, int rows, int N,
                                                int C, int ld) {
  constexpr int per = 16 / sizeof(T);
  const int vpr = C / per;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * per;
    const bool valid = row0 + r < N;
    const T* g = valid ? src + static_cast<size_t>(row0 + r) * C + c : src;
    cp_async16(dst + r * ld + c, g, valid);
  }
}

// ---------------------------------------------------------------- bf16 ----
constexpr int BQ16 = 32;          // queries per block
constexpr int BKV16 = 128;        // keys per step
constexpr int NT16 = 256;         // 8 warps
constexpr int SLD = BKV16 + 4;    // score row stride (float)
constexpr int PLD = BKV16 + 8;    // probability row stride (bf16)
constexpr int MAXF16 = 8;         // output fragments per warp: C / 64

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
constexpr int ACC_ELEMS = AccFrag::num_elements;

struct Bf16Layout {
  int qld, old;                   // q/kv row stride (bf16), output (float)
  size_t q, kv, s, p, m, l, alpha, total;
  __host__ __device__ explicit Bf16Layout(int C) {
    qld = C + 8;
    old = C + 4;
    q = 0;
    kv = q + static_cast<size_t>(BQ16) * qld * 2;
    s = kv + static_cast<size_t>(BKV16) * qld * 2;
    p = s + static_cast<size_t>(BQ16) * SLD * 4;
    m = p + static_cast<size_t>(BQ16) * PLD * 2;
    l = m + BQ16 * 4;
    alpha = l + BQ16 * 4;
    total = alpha + BQ16 * 4;
  }
};

__global__ void __launch_bounds__(NT16) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ kvalid,
    float* __restrict__ out, int N, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L(C);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kvs = reinterpret_cast<bf16*>(smem + L.kv);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.p);
  float* ms = reinterpret_cast<float*>(smem + L.m);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  float* as = reinterpret_cast<float*>(smem + L.alpha);
  float* os = reinterpret_cast<float*>(smem + L.kv);   // final staging

  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ16;
  const size_t base = static_cast<size_t>(b) * N * C;

  // row (within its 16 x 16 tile) of each accumulator element
  int row_of[ACC_ELEMS];
  {
    for (int i = tid; i < 256; i += NT16) ss[i] = static_cast<float>(i / 16);
    __syncthreads();
    AccFrag probe;
    wmma::load_matrix_sync(probe, ss, 16, wmma::mem_row_major);
#pragma unroll
    for (int i = 0; i < ACC_ELEMS; ++i)
      row_of[i] = static_cast<int>(probe.x[i]);
    __syncthreads();
  }

  load_rows_async(qs, q + base, q0, BQ16, N, C, L.qld);
  cp_async_commit();
  if (tid < BQ16) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }

  // S = q k^T: warp -> row tile (warp & 1), key tiles 2 * (warp >> 1) + {0,1}
  const int srow = (warp & 1) * 16, scol = (warp >> 1) * 32;
  // softmax: 8 threads per query row, 16 keys each
  const int prow = tid / 8, pcol = (tid % 8) * 16;
  // P v: warp -> rows orow.., columns ocol + 16 f for f < C / 64
  const int orow = (warp & 1) * 16, ocol = (warp >> 1) * (C / 4);
  const int nof = C / 64;

  AccFrag of[MAXF16];
#pragma unroll
  for (int f = 0; f < MAXF16; ++f) wmma::fill_fragment(of[f], 0.0f);

  for (int kv0 = 0; kv0 < N; kv0 += BKV16) {
    __syncthreads();   // the previous step's P v is done with kvs
    load_rows_async(kvs, k + base, kv0, BKV16, N, C, L.qld);
    cp_async_wait_all();
    __syncthreads();
    {
      AccFrag sf[2];
      wmma::fill_fragment(sf[0], 0.0f);
      wmma::fill_fragment(sf[1], 0.0f);
      for (int c = 0; c < C; c += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, qs + srow * L.qld + c, L.qld);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bfr;
          wmma::load_matrix_sync(bfr, kvs + (scol + 16 * j) * L.qld + c,
                                 L.qld);
          wmma::mma_sync(sf[j], af, bfr, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ss + srow * SLD + scol + 16 * j, sf[j], SLD,
                                wmma::mem_row_major);
    }
    __syncthreads();
    // V replaces K while the softmax runs on the scores
    load_rows_async(kvs, v + base, kv0, BKV16, N, C, L.qld);
    cp_async_commit();
    {
      float sv[16];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = kv0 + pcol + j;
        sv[j] = key_live(kvalid, key, N) ? ss[prow * SLD + pcol + j] * scale
                                         : -INFINITY;
        mt = fmaxf(mt, sv[j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = ms[prow];
      const float m_new = fmaxf(m_old, mt);
      const float m_ref = softmax_ref(m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(sv[j] - m_ref);
        rs += p;
        ps[prow * PLD + pcol + j] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (tid % 8 == 0) {
        const float alpha = expf(m_old - m_ref);
        ms[prow] = m_new;
        ls[prow] = ls[prow] * alpha + rs;
        as[prow] = alpha;
      }
    }
    __syncthreads();   // P and alpha visible
#pragma unroll
    for (int f = 0; f < MAXF16; ++f) {
      if (f < nof) {
#pragma unroll
        for (int i = 0; i < ACC_ELEMS; ++i) of[f].x[i] *= as[orow + row_of[i]];
      }
    }
    cp_async_wait_all();
    __syncthreads();   // V visible
    for (int kk = 0; kk < BKV16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, ps + orow * PLD + kk, PLD);
#pragma unroll
      for (int f = 0; f < MAXF16; ++f) {
        if (f < nof) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bfr;
          wmma::load_matrix_sync(bfr, kvs + kk * L.qld + ocol + 16 * f,
                                 L.qld);
          wmma::mma_sync(of[f], af, bfr, of[f]);
        }
      }
    }
  }
  __syncthreads();   // kvs is free: stage the normalized output there
#pragma unroll
  for (int f = 0; f < MAXF16; ++f) {
    if (f < nof) {
#pragma unroll
      for (int i = 0; i < ACC_ELEMS; ++i) of[f].x[i] /= ls[orow + row_of[i]];
      wmma::store_matrix_sync(os + orow * L.old + ocol + 16 * f, of[f], L.old,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ16 * C; i += NT16) {
    const int r = i / C, c = i % C;
    if (q0 + r < N)
      out[base + static_cast<size_t>(q0 + r) * C + c] = os[r * L.old + c];
  }
}

// ---------------------------------------------------------------- f32 -----
constexpr int BQ32 = 64;          // queries per block
constexpr int BKV32 = 32;         // keys per step
constexpr int NT32 = 256;
constexpr int MAXC32 = 512;       // register accumulator bound: C / 64 <= 8
constexpr int PLD32 = BKV32 + 1;

size_t f32_smem(int C) {
  return (static_cast<size_t>(BQ32 + BKV32) * (C + 4) + BQ32 * PLD32 +
          2 * BQ32) * sizeof(float);
}

__global__ void __launch_bounds__(NT32, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ kvalid,
    float* __restrict__ out, int N, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = C + 4;
  float* qs = reinterpret_cast<float*>(smem);
  float* kvs = qs + BQ32 * ld;
  float* ps = kvs + BKV32 * ld;            // [BQ32][PLD32]
  float* as = ps + BQ32 * PLD32;           // alpha per row
  float* ls = as + BQ32;                   // final row sums

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ32;
  const size_t base = static_cast<size_t>(b) * N * C;

  // scores: thread -> rows srow, srow + 1; keys skey + 8 j, j < 4
  const int srow = (tid / 8) * 2, skey = tid % 8;
  // output: thread -> rows orow0 .. orow0 + 15, columns ocol + 64 j
  const int orow0 = (tid / 64) * 16, ocol = tid % 64;
  const int ncol = C / 64;

  float acc[16][MAXC32 / 64];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < MAXC32 / 64; ++j) acc[r][j] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  load_rows_async(qs, q + base, q0, BQ32, N, C, ld);
  cp_async_commit();

  for (int kv0 = 0; kv0 < N; kv0 += BKV32) {
    __syncthreads();   // the previous step's P v is done with kvs
    load_rows_async(kvs, k + base, kv0, BKV32, N, C, ld);
    cp_async_wait_all();
    __syncthreads();
    float sv[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[r][j] = 0.0f;
    const float* q0r = qs + srow * ld;
    const float* q1r = q0r + ld;
    for (int c = 0; c < C; c += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0r + c);
      const float4 a1 = *reinterpret_cast<const float4*>(q1r + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kvs + (skey + 8 * j) * ld + c);
        sv[0][j] = fmaf(a0.x, kk.x, sv[0][j]);
        sv[0][j] = fmaf(a0.y, kk.y, sv[0][j]);
        sv[0][j] = fmaf(a0.z, kk.z, sv[0][j]);
        sv[0][j] = fmaf(a0.w, kk.w, sv[0][j]);
        sv[1][j] = fmaf(a1.x, kk.x, sv[1][j]);
        sv[1][j] = fmaf(a1.y, kk.y, sv[1][j]);
        sv[1][j] = fmaf(a1.z, kk.z, sv[1][j]);
        sv[1][j] = fmaf(a1.w, kk.w, sv[1][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sv[r][j] = key_live(kvalid, kv0 + skey + 8 * j, N) ? sv[r][j] * scale
                                                          : -INFINITY;
        mt = fmaxf(mt, sv[r][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run[r], mt);
      const float m_ref = softmax_ref(m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[r][j] - m_ref);
        rs += p;
        ps[(srow + r) * PLD32 + skey + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_run[r] - m_ref);
      m_run[r] = m_new;
      l_run[r] = l_run[r] * alpha + rs;
      if (skey == 0) as[srow + r] = alpha;
    }
    __syncthreads();   // scores are done with K; P and alpha visible
    load_rows_async(kvs, v + base, kv0, BKV32, N, C, ld);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = as[orow0 + r];
#pragma unroll
      for (int j = 0; j < MAXC32 / 64; ++j) acc[r][j] *= a;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int key = 0; key < BKV32; ++key) {
      float vv[MAXC32 / 64];
#pragma unroll
      for (int j = 0; j < MAXC32 / 64; ++j)
        vv[j] = j < ncol ? kvs[key * ld + ocol + 64 * j] : 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = ps[(orow0 + r) * PLD32 + key];
#pragma unroll
        for (int j = 0; j < MAXC32 / 64; ++j)
          acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }
  if (skey == 0) {
    ls[srow] = l_run[0];
    ls[srow + 1] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + orow0 + r;
    if (row >= N) continue;
    const float inv = 1.0f / ls[orow0 + r];
#pragma unroll
    for (int j = 0; j < MAXC32 / 64; ++j)
      if (j < ncol)
        out[base + static_cast<size_t>(row) * C + ocol + 64 * j] =
            acc[r][j] * inv;
  }
}

// -------------------------------------------------------------- 3-pass ----
constexpr int BQ3 = 64;               // queries per block
constexpr int BKV3 = 32;              // keys per step
constexpr int NT3 = 256;              // 8 warps
constexpr int SLD3 = BKV3 + 4;        // score row stride (float)
constexpr int PLD3 = BKV3 + 8;        // probability row stride (bf16)
constexpr int MAXN3 = MAXC32 / 16;    // output n8 tiles a warp: C / 2 / 8
constexpr int LOADS3 = 8;             // float4 tile loads in flight a thread

// Row strides of C + 8 bf16 (and PLD3) put the eight rows of an ldmatrix
// 16 bytes apart in the banks: conflict-free.
struct Pass3Layout {
  int ld;                             // q / kv row stride (bf16)
  size_t qh, ql, kvh, kvl, s, ph, pl, alpha, l, total;
  __host__ __device__ explicit Pass3Layout(int C) {
    ld = C + 8;
    qh = 0;
    ql = qh + static_cast<size_t>(BQ3) * ld * 2;
    kvh = ql + static_cast<size_t>(BQ3) * ld * 2;
    kvl = kvh + static_cast<size_t>(BKV3) * ld * 2;
    s = kvl + static_cast<size_t>(BKV3) * ld * 2;
    ph = s + static_cast<size_t>(BQ3) * SLD3 * 4;
    pl = ph + static_cast<size_t>(BQ3) * PLD3 * 2;
    alpha = pl + static_cast<size_t>(BQ3) * PLD3 * 2;
    l = alpha + BQ3 * 4;
    total = l + BQ3 * 4;
  }
};

// _dot3's split: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact)
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

// d[16x8] = a[16x16] b[16x8], bf16 operands, float32 out: a fresh
// accumulator.  The tensor cores add each product into float32 with
// truncation, not round-to-nearest, so a long run of mma into one
// accumulator shrinks it by up to an ulp a step, which thousands of steps
// make visible; the kernel keeps each such run short (three or six mmas)
// and adds the runs with round-to-nearest.
__device__ __forceinline__ void mma_bf16_16816_new(float* d,
                                                   const unsigned* a,
                                                   const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

__device__ __forceinline__ uint2 pack4(const bf16 (&h)[4]) {
  uint2 r;
  r.x = static_cast<unsigned>(__bfloat16_as_ushort(h[0])) |
        (static_cast<unsigned>(__bfloat16_as_ushort(h[1])) << 16);
  r.y = static_cast<unsigned>(__bfloat16_as_ushort(h[2])) |
        (static_cast<unsigned>(__bfloat16_as_ushort(h[3])) << 16);
  return r;
}

// Rows [row0, row0 + rows) of a float32 [N, C] matrix, each value times
// scale (one rounded float32 multiply, never fused into the split), split
// into the bf16 hi and lo tiles (row stride ld); rows at or past N are
// zero.  LOADS3 16-byte loads are in flight a thread before their splits
// are stored (the tile loads sit between barriers: their latency is not
// hidden by other work of the block).
__device__ __forceinline__ void split_rows(bf16* hi, bf16* lo,
                                           const float* __restrict__ src,
                                           int row0, int rows, int N, int C,
                                           int ld, float scale) {
  const int vpr = C / 4;
  const int total = rows * vpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += LOADS3 * NT3) {
    float4 v[LOADS3];
#pragma unroll
    for (int u = 0; u < LOADS3; ++u) {
      const int i = i0 + u * NT3;
      const int r = i / vpr, c = (i % vpr) * 4;
      v[u] = i < total && row0 + r < N
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + static_cast<size_t>(row0 + r) * C + c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < LOADS3; ++u) {
      const int i = i0 + u * NT3;
      if (i >= total) break;
      const int r = i / vpr, c = (i % vpr) * 4;
      const float x[4] = {__fmul_rn(v[u].x, scale), __fmul_rn(v[u].y, scale),
                          __fmul_rn(v[u].z, scale), __fmul_rn(v[u].w, scale)};
      bf16 h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(x[e], h[e], l[e]);
      *reinterpret_cast<uint2*>(hi + r * ld + c) = pack4(h);
      *reinterpret_cast<uint2*>(lo + r * ld + c) = pack4(l);
    }
  }
}

__global__ void __launch_bounds__(NT3, 1) flash_3pass_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ kvalid,
    float* __restrict__ out, int N, int C, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Pass3Layout L(C);
  bf16* qh = reinterpret_cast<bf16*>(smem + L.qh);
  bf16* ql = reinterpret_cast<bf16*>(smem + L.ql);
  bf16* kvh = reinterpret_cast<bf16*>(smem + L.kvh);
  bf16* kvl = reinterpret_cast<bf16*>(smem + L.kvl);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* ph = reinterpret_cast<bf16*>(smem + L.ph);
  bf16* pl = reinterpret_cast<bf16*>(smem + L.pl);
  float* as = reinterpret_cast<float*>(smem + L.alpha);
  float* ls = reinterpret_cast<float*>(smem + L.l);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ3;
  const size_t base = static_cast<size_t>(b) * N * C;
  const int ld = L.ld;

  // the q block: scaled in float32, then split (_flash_kernel :131)
  split_rows(qh, ql, q + base, q0, BQ3, N, C, ld, scale);

  // S: warp -> query rows 16 wr .. + 16, keys 16 wh .. + 16 (two n8
  // tiles); P v: warp -> the same rows, output columns col0 .. + C / 2
  const int wr = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int col0 = wh * (C / 2), nnt = C / 16;
  // softmax: four threads a query row, eight keys each
  const int prow = tid >> 2, pcol = (tid & 3) * 8;
  // ldmatrix row addresses: A fragments (q, P) read row lane % 16 at
  // column 8 (lane / 16); K's B fragments of two n8 tiles read key (lane %
  // 8) + 8 (lane / 16) at column 8 ((lane / 8) % 2); V's (.trans) key lane
  // % 16 at column 8 (lane / 16)
  const int qa = (16 * wr + (lane & 15)) * ld + (lane >> 4) * 8;
  const int kb = (16 * wh + (lane & 7) + ((lane >> 4) << 3)) * ld +
                 ((lane >> 3) & 1) * 8;
  const int pa = (16 * wr + (lane & 15)) * PLD3 + (lane >> 4) * 8;
  const int vb = (lane & 15) * ld + col0 + (lane >> 4) * 8;

  float acc[MAXN3][4];
#pragma unroll
  for (int n = 0; n < MAXN3; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int kv0 = 0; kv0 < N; kv0 += BKV3) {
    __syncthreads();   // the previous step's P v is done with the tile
    split_rows(kvh, kvl, k + base, kv0, BKV3, N, C, ld, 1.0f);
    __syncthreads();
    {
      // each 16-channel step's three products into a fresh part, added to
      // the scores with round-to-nearest
      float sacc[2][4] = {};
#pragma unroll 2
      for (int c = 0; c < C; c += 16) {
        unsigned ah[4], al[4], bh[4], bl[4];
        winattn::ldsm_x4(ah, qh + qa + c);
        winattn::ldsm_x4(al, ql + qa + c);
        winattn::ldsm_x4(bh, kvh + kb + c);
        winattn::ldsm_x4(bl, kvl + kb + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float part[4];
          mma_bf16_16816_new(part, ah, bh + 2 * j);
          winattn::mma_bf16_16816(part, ah, bl + 2 * j);
          winattn::mma_bf16_16816(part, al, bh + 2 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] += part[e];
        }
      }
      // mma's C layout: lane holds rows g and g + 8, columns 2 t4 + {0, 1}
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* srow = ss + (16 * wr + g) * SLD3 + 16 * wh + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(srow) = make_float2(sacc[j][0], sacc[j][1]);
        *reinterpret_cast<float2*>(srow + 8 * SLD3) =
            make_float2(sacc[j][2], sacc[j][3]);
      }
    }
    __syncthreads();   // the scores are whole; no warp reads K any more
    {
      float sv[8];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sv[j] = key_live(kvalid, kv0 + pcol + j, N)
                    ? ss[prow * SLD3 + pcol + j]
                    : -INFINITY;
        mt = fmaxf(mt, sv[j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      const float m_ref = softmax_ref(m_new);
      float rs = 0.0f;
      bf16 h[2][4], lo[2][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sv[j] - m_ref);
        rs += p;
        split3(p, h[j / 4][j % 4], lo[j / 4][j % 4]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        *reinterpret_cast<uint2*>(ph + prow * PLD3 + pcol + 4 * hf) =
            pack4(h[hf]);
        *reinterpret_cast<uint2*>(pl + prow * PLD3 + pcol + 4 * hf) =
            pack4(lo[hf]);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = expf(m_run - m_ref);
      m_run = m_new;
      l_run = l_run * alpha + rs;
      if ((tid & 3) == 0) as[prow] = alpha;
    }
    // V replaces K
    split_rows(kvh, kvl, v + base, kv0, BKV3, N, C, ld, 1.0f);
    __syncthreads();   // P, alpha and V visible
    {
      // the tile's P v for 16 columns into a fresh t (both 16-key halves,
      // three passes each), then acc = acc * alpha + t with round-to-nearest
      unsigned pa_h[2][4], pa_l[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        winattn::ldsm_x4(pa_h[ks], ph + pa + 16 * ks);
        winattn::ldsm_x4(pa_l[ks], pl + pa + 16 * ks);
      }
      const float a0 = as[16 * wr + g], a1 = as[16 * wr + g + 8];
#pragma unroll
      for (int n2 = 0; n2 < MAXN3 / 2; ++n2) {
        if (2 * n2 < nnt) {
          float t[2][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            unsigned vh[4], vl[4];
            winattn::ldsm_x4_trans(vh, kvh + vb + 16 * ks * ld + 16 * n2);
            winattn::ldsm_x4_trans(vl, kvl + vb + 16 * ks * ld + 16 * n2);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              if (ks == 0)
                mma_bf16_16816_new(t[jj], pa_h[ks], vh + 2 * jj);
              else
                winattn::mma_bf16_16816(t[jj], pa_h[ks], vh + 2 * jj);
              winattn::mma_bf16_16816(t[jj], pa_h[ks], vl + 2 * jj);
              winattn::mma_bf16_16816(t[jj], pa_l[ks], vh + 2 * jj);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float* a = acc[2 * n2 + jj];
            a[0] = fmaf(a[0], a0, t[jj][0]);
            a[1] = fmaf(a[1], a0, t[jj][1]);
            a[2] = fmaf(a[2], a1, t[jj][2]);
            a[3] = fmaf(a[3], a1, t[jj][3]);
          }
        }
      }
    }
  }
  if ((tid & 3) == 0) ls[prow] = l_run;
  __syncthreads();
  const int r0 = 16 * wr + g;
  const float l0 = ls[r0], l1 = ls[r0 + 8];
#pragma unroll
  for (int n = 0; n < MAXN3; ++n) {
    if (n < nnt) {
      const int col = col0 + 8 * n + 2 * t4;
      if (q0 + r0 < N)
        *reinterpret_cast<float2*>(out + base +
                                   static_cast<size_t>(q0 + r0) * C + col) =
            make_float2(acc[n][0] / l0, acc[n][1] / l0);
      if (q0 + r0 + 8 < N)
        *reinterpret_cast<float2*>(
            out + base + static_cast<size_t>(q0 + r0 + 8) * C + col) =
            make_float2(acc[n][2] / l1, acc[n][3] / l1);
    }
  }
}

}  // namespace

extern "C" {

// q, k, v [B,N,C] bf16, out [B,N,C] f32; C % 64 == 0, C <= 512;
// key_valid [N] bytes (0: the key is dead) or nullptr.
int hdrvae_flash_attention_bf16(const void* q, const void* k, const void* v,
                                const void* key_valid, void* out, int B,
                                int N, int C, float scale, void* stream) {
  const size_t smem = Bf16Layout(C).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ16 - 1) / BQ16, B);
  flash_bf16_kernel<<<grid, NT16, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<float*>(out),
      N, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v [B,N,C] f32, out [B,N,C] f32; C % 64 == 0, C <= 512
// (cudaErrorInvalidValue otherwise); key_valid [N] bytes or nullptr.
int hdrvae_flash_attention_3pass(const void* q, const void* k, const void* v,
                                 const void* key_valid, void* out, int B,
                                 int N, int C, float scale, void* stream) {
  if (C <= 0 || C % 64 != 0 || C > MAXC32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Pass3Layout(C).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_3pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ3 - 1) / BQ3, B);
  flash_3pass_kernel<<<grid, NT3, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<float*>(out),
      N, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v [B,N,C] f32, out [B,N,C] f32; C % 64 == 0, C <= 512;
// key_valid [N] bytes or nullptr.
int hdrvae_flash_attention_f32(const void* q, const void* k, const void* v,
                               const void* key_valid, void* out, int B,
                               int N, int C, float scale, void* stream) {
  const size_t smem = f32_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ32 - 1) / BQ32, B);
  flash_f32_kernel<<<grid, NT32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v),
      static_cast<const unsigned char*>(key_valid), static_cast<float*>(out),
      N, C, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
