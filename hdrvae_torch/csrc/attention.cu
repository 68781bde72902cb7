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
// own.  Two kernels, one per dot mode of the tiers:
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
//  * flash_f32 (parity and mixed tiers): exact float32 dot products with
//    FMAs on the CUDA cores, never TF32.  64 queries by 32 keys per step;
//    each thread computes a 2 x 4 block of scores and keeps a 16-row x
//    8-column block of the output in registers, so shared-memory reads per
//    FMA stay low.  The mixed tier's 3-pass bf16x3 contraction would be
//    cheaper; exact float32 is at least as accurate and is the first
//    version.
//
// Ragged N is handled by masking: keys at or past N score -inf (and their
// rows load as zero), queries at or past N are computed on zeros and not
// stored.  No padded copy and no flag channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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
    const bf16* __restrict__ v, float* __restrict__ out, int N, int C,
    float scale) {
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
        sv[j] = key < N ? ss[prow * SLD + pcol + j] * scale : -INFINITY;
        mt = fmaxf(mt, sv[j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = ms[prow];
      const float m_new = fmaxf(m_old, mt);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(sv[j] - m_new);
        rs += p;
        ps[prow * PLD + pcol + j] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (tid % 8 == 0) {
        const float alpha = expf(m_old - m_new);
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
    const float* __restrict__ v, float* __restrict__ out, int N, int C,
    float scale) {
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
        sv[r][j] = (kv0 + skey + 8 * j < N) ? sv[r][j] * scale : -INFINITY;
        mt = fmaxf(mt, sv[r][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run[r], mt);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sv[r][j] - m_new);
        rs += p;
        ps[(srow + r) * PLD32 + skey + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_run[r] - m_new);
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

}  // namespace

extern "C" {

// q, k, v [B,N,C] bf16, out [B,N,C] f32; C % 64 == 0, C <= 512.
int hdrvae_flash_attention_bf16(const void* q, const void* k, const void* v,
                                void* out, int B, int N, int C, float scale,
                                void* stream) {
  const size_t smem = Bf16Layout(C).total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ16 - 1) / BQ16, B);
  flash_bf16_kernel<<<grid, NT16, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(out), N, C, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v [B,N,C] f32, out [B,N,C] f32; C % 64 == 0, C <= 512.
int hdrvae_flash_attention_f32(const void* q, const void* k, const void* v,
                               void* out, int B, int N, int C, float scale,
                               void* stream) {
  const size_t smem = f32_smem(C);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ32 - 1) / BQ32, B);
  flash_f32_kernel<<<grid, NT32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, C, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
