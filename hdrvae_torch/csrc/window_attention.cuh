// Building blocks of the Swin kernels (the block kernel K7, swin_block.cu;
// the staged chain K9-K11, swin_chain.cu) and of K12 (f32_dot.cu):
// cp.async copies, the exact GELU, bf16 pairs of a row in and out, L2
// prefetch, and the [64 x 32] bf16 atoms with the 64-byte swizzle (and the
// 128-byte swizzle's boxes) that the wgmma products read: their
// descriptors, layout and the store of an accumulator fragment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace winattn {

typedef __nv_bfloat16 bf16;

constexpr int HDP = 32;        // padded head dim
constexpr int ATOM = 64 * HDP * 2;   // a [64 x 32] bf16 atom: 4 KB
constexpr int MAXC = 8;        // 32-channel groups of a token row: C <= 256

// 16-byte global -> shared copy (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Exact (erf) GELU of x in float32.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// Channels c, c + 1 (c even) of a bf16 row, zero past C.
__device__ __forceinline__ float2 load_pair(const bf16* row, int c, int C) {
  if ((C & 1) == 0)
    return c < C ? unpack_bf16(__ldg(reinterpret_cast<const unsigned*>(
                       row + c)))
                 : make_float2(0.0f, 0.0f);
  return make_float2(c < C ? __bfloat162float(row[c]) : 0.0f,
                     c + 1 < C ? __bfloat162float(row[c + 1]) : 0.0f);
}

__device__ __forceinline__ void store_pair(bf16* row, int c, int C, float lo,
                                           float hi) {
  if ((C & 1) == 0) {
    if (c < C) *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(lo, hi);
    return;
  }
  if (c < C) row[c] = __float2bfloat16(lo);
  if (c + 1 < C) row[c + 1] = __float2bfloat16(hi);
}

// Brings [p, p + bytes) into L2 (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// The wgmma descriptor of [64 x 32] bf16 atoms with the 64-byte swizzle
// (64-byte rows, 8-row groups 512 B apart): K-major A / B tiles and
// MN-major B tiles one atom wide (the leading offset is then unused).
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return hopper::make_desc(addr, 16, 512, hopper::LAYOUT_B64);
}

// wgmma descriptors of the 128-byte swizzle (MN-major 64-column boxes,
// 8-row groups 1 KB apart, boxes 4 KB apart).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return hopper::make_desc(addr, 4096, 1024, hopper::LAYOUT_B128);
}

// Byte offset of element (r, c) of a K-major region of [64 x 32] atoms
// (64-byte rows, the 64-byte swizzle: 16-byte chunk bits 4-5 XOR address
// bits 7-8); atoms at 4 KB strides along c.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const uint32_t e = r * 32 + (c & 31);
  return (c >> 5) * ATOM + 2 * (e ^ (((e >> 6) & 3) << 3));
}

// An m64n32 accumulator fragment (f[4 j + 2 i + e]: row 16 w + g + 8 i,
// column 8 j + 2 t + e of warp w, lane 4 g + t) rounded to bf16 into a
// [64 x 32] atom with the 64-byte swizzle.
__device__ __forceinline__ void frag_to_atom(unsigned char* atom,
                                             const float* f, int wl, int g,
                                             int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(atom + swz(16 * wl + g + 8 * i,
                                              8 * j + 2 * t)) =
          pack_bf16(f[4 * j + 2 * i], f[4 * j + 2 * i + 1]);
}

}  // namespace winattn
