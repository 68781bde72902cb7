// HAT's overlapping cross-attention core on Hopper's tensor cores (WMMA
// bf16 fragments, float32 accumulation): per (window, head) softmax(q k^T
// + bias) v with nq queries against nk keys, 512 threads a block.
//
// Replaces the TPU kernel K8 of the JAX package:
//   hdrvae/kernels/ocab.py::ocab_attention
// HAT-M (window 16, overlap 0.5): q [nwb, 6, 256, 32], k / v [nwb, 6, 576,
// 32] bf16 (head dim 30 zero-padded to 32, scale folded into q), bias
// [6, 256, 576] float32.
//
// What bounds it on the H100: 4 * nq * nk * 32 flops a (window, head)
// against (nq + 2 nk) * 64 bytes of q/k/v and nq * nk * 4 bytes of bias
// (read from L2; 3.5 MB for all heads): ~22 flops a byte, below the
// card's ridge, so what matters is that the [nq, nk] score tile never
// reaches device memory.  A block takes 64 query rows of one (window,
// head): its [64, nk] float32 scores (147 KB at nk = 576) stay in shared
// memory, the probabilities are written as bf16 over the same bytes; q and
// K are copied to shared memory first, then V into K's place while the
// softmax runs, so both GEMMs read shared memory only.
// Numerics are those of the JAX kernel: float32 scores and softmax (p as
// the exp times the sum's reciprocal, within a float32 ulp of the JAX
// division), P rounded to bf16 for its product with v, the output stored
// in bf16.

#include "window_attention.cuh"

namespace {

using namespace winattn;

constexpr int LDQ = HDP + 8;    // row stride of the staged q / K / V

__global__ void __launch_bounds__(NT)
ocab_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ bias,
            bf16* __restrict__ out, int heads, int nq, int nk, int lds) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);                  // [64, lds]
  bf16* qs = reinterpret_cast<bf16*>(smem + RB * lds * 4);    // [64, LDQ]
  bf16* kv = qs + RB * LDQ;                                   // [nk, LDQ]
  float* stage = reinterpret_cast<float*>(kv + nk * LDQ) +
                 (threadIdx.x >> 5) * 256;
  const int r0 = blockIdx.x * RB;
  const int h = blockIdx.y;
  const size_t wh = static_cast<size_t>(blockIdx.z) * heads + h;
  const int nrt = min(4, (nq - r0) / 16);
  bf16* ob = out + (wh * nq + r0) * HDP;

  copy_rows_async(qs, LDQ, q + (wh * nq + r0) * HDP, HDP, nrt * 16, HDP);
  copy_rows_async(kv, LDQ, k + wh * nk * HDP, HDP, nk, HDP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  gemm_rows<true>(qs, LDQ, nrt, kv, LDQ, 2, nk / 16,
                  [&](int rt, int ct, const Acc& acc) {
    wmma::store_matrix_sync(S + static_cast<size_t>(rt) * 16 * lds + ct * 16,
                            acc, lds, wmma::mem_row_major);
  });
  __syncthreads();
  copy_rows_async(kv, LDQ, v + wh * nk * HDP, HDP, nk, HDP);
  cp_async_commit();
  const float* bias_h = bias + static_cast<size_t>(h) * nq * nk;
  softmax_rows<8>(S, lds, nrt * 16, nrt * 16, nk, nk, [&](int r) {
    const float* brow = bias_h + static_cast<size_t>(r0 + r) * nk;
    return [=](int, int j, float s) { return s + brow[j]; };
  });
  cp_async_wait<0>();
  __syncthreads();
  gemm_rows<false>(reinterpret_cast<const bf16*>(S), 2 * lds, nrt, kv, LDQ,
                   nk / 16, 2, [&](int rt, int ct, const Acc& acc) {
    each_run8(stage, rt, ct, acc, [&](int r, int c, const float* o) {
      store_bf16x8(ob + static_cast<size_t>(r) * HDP + c, o);
    });
  });
}

}  // namespace

extern "C" {

// q [nwb, heads, nq, 32], k / v [nwb, heads, nk, 32], out [nwb, heads, nq,
// 32] bf16; bias [heads, nq, nk] float32.  nq and nk must be multiples of
// 16 and the [64, nk + 4] float32 scores beside the staged q and K / V
// must fit the block's shared memory, nk <= 624 (cudaErrorInvalidValue
// otherwise).
int hdrvae_ocab_attention(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int nwb, int heads,
                          int nq, int nk, void* stream) {
  if (nq < 16 || nq % 16 || nk < 16 || nk % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lds = nk + 4;
  const int smem = RB * lds * 4 + (RB + nk) * LDQ * 2 + NWARPS * 256 * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ocab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + RB - 1) / RB, heads, nwb);
  ocab_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), heads, nq, nk, lds);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
