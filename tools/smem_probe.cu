// What shared memory costs an FFMA loop on one NVIDIA Hopper GPU: the
// design probe of K3's exact-float32 attention (csrc/attention.cu,
// flash_f32_kernel).  A standalone program, no PyTorch:
//
//   mkdir -p hdrvae_torch/build
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3
//        -o hdrvae_torch/build/smem_probe tools/smem_probe.cu   (one line)
//   hdrvae_torch/build/smem_probe
//
// Part 1 times warp-wide shared loads of one address pattern each (one
// block of 8 warps an SM, every SM, each load's values feeding FFMAs into
// eight independent sums): the SM clocks one warp's load takes.  A 128-bit
// load (LDS.128) whose 32 lanes read one 16-byte chunk, 4, 8 or 32 tells
// whether a broadcast saves shared-memory cycles, or each quarter-warp
// costs one pass whatever it reads; 32- and 64-bit loads, distinct and
// broadcast, and 64-byte rows with and without TMA's 64-byte swizzle give
// the rest of the table.  Part 2 times two register-tiled inner loops the
// kernel was designed from, as a share of the SM's FFMA peak (128 a
// clock): S (8 queries x 8 keys a thread over 4 channels: 8 broadcast q
// loads, 8 K loads from a 64-byte-swizzled stage, 256 FFMAs) and P V (8
// queries x 16 columns a thread per key: 8 shuffles of P, 4 V loads, 128
// FFMAs).  It prints the card's name and clock first.

#include <cuda_runtime.h>
#include <stdio.h>

#define CHECK(x)                                                       \
  do {                                                                 \
    cudaError_t e = (x);                                               \
    if (e != cudaSuccess) {                                            \
      printf("%s:%d %s\n", __FILE__, __LINE__, cudaGetErrorString(e)); \
      return 1;                                                        \
    }                                                                  \
  } while (0)

constexpr int NT = 256;

__device__ __forceinline__ float4 lds128(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float2 lds64(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float lds32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// byte offset of this lane's load in pattern p
__device__ __forceinline__ unsigned pattern(int p, int lane) {
  switch (p) {
    case 0: return 0;                          // one chunk, all lanes
    case 1: return (lane >> 3) << 4;           // 4 chunks, one a quarter
    case 2: return (lane >> 2) << 4;           // 8 chunks, two a quarter
    case 3: return (lane & 7) << 4;            // 8 chunks, each quarter all
    case 4: return lane << 4;                  // 32 chunks
    case 5:                                    // 32 rows of 64 B, swizzled
      return lane * 64 + (((lane >> 1) & 3) << 4);
    case 6: return lane * 64;                  // 32 rows of 64 B, plain
    case 7: return lane << 2;                  // 32-bit: 32 words
    case 8: return 0;                          // 32-bit: one word
    case 9: return lane << 3;                  // 64-bit: 32 pairs
    default: return 0;                         // 64-bit: one pair
  }
}

__global__ void __launch_bounds__(NT, 1) loads(int p, int iters,
                                               long long* cycles,
                                               float* sink) {
  extern __shared__ float4 buf[];
  for (int i = threadIdx.x; i < 4096; i += NT) buf[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned a = base + pattern(p, threadIdx.x & 31);
  // eight independent sums, two FFMAs a 128-bit load (one a 32-bit one):
  // at most 0.75 SM clocks of issue a warp load, below what shared memory
  // takes for any pattern that is not a 32-bit broadcast
  float acc[8] = {};
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const unsigned ai = a + ((it & 3) << 11);   // never loop-invariant
    if (p < 7) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float4 v = lds128(ai + u * 2048);   // 16 addresses
        acc[u % 8] = fmaf(v.x, v.y, acc[u % 8]);
        acc[(u + 4) % 8] = fmaf(v.z, v.w, acc[(u + 4) % 8]);
      }
    } else if (p < 9) {
#pragma unroll
      for (int u = 0; u < 16; ++u) acc[u % 8] += lds32(ai + u * 2048);
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float2 v = lds64(ai + u * 2048);
        acc[u % 8] = fmaf(v.x, v.y, acc[u % 8]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float t = 0.0f;
  for (int i = 0; i < 8; ++i) t += acc[i];
  if (t == 12345.0f) sink[threadIdx.x] = t;
}

// S: rows 8 w .. 8 w + 7 (warp-uniform: broadcast), keys lane + 32 j of a
// [256 keys][16 channels] stage whose 16-byte chunks are XOR-swizzled by
// (key / 2) % 4 (TMA's 64-byte swizzle), q [64][512] plain
__global__ void __launch_bounds__(NT, 1) s_loop(int stages,
                                                long long* cycles,
                                                float* sink) {
  extern __shared__ float smem[];
  float* q = smem;                     // 64 x 512
  float* k = smem + 64 * 512;          // 256 x 16
  for (int i = threadIdx.x; i < 64 * 512 + 256 * 16; i += NT)
    smem[i] = (i % 97) * 1e-3f;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned qb = static_cast<unsigned>(__cvta_generic_to_shared(q)) +
                      warp * 8 * 512 * 4;
  const unsigned kb = static_cast<unsigned>(__cvta_generic_to_shared(k)) +
                      lane * 64;
  const unsigned sw = (lane >> 1) & 3;   // the same for key lane + 32 j
  float acc[8][8] = {};
  const long long t0 = clock64();
  for (int s = 0; s < stages; ++s) {
    const int c0 = (s % 32) * 16;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      float4 qa[8], ka[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        qa[r] = lds128(qb + (r * 512 + c0 + 4 * c4) * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ka[j] = lds128(kb + j * 32 * 64 + ((c4 ^ sw) << 4));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[r][j] = fmaf(qa[r].x, ka[j].x, acc[r][j]);
          acc[r][j] = fmaf(qa[r].y, ka[j].y, acc[r][j]);
          acc[r][j] = fmaf(qa[r].z, ka[j].z, acc[r][j]);
          acc[r][j] = fmaf(qa[r].w, ka[j].w, acc[r][j]);
        }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float t = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) t += acc[r][j];
  if (t == 12345.0f) sink[threadIdx.x] = t;
}

// P V: rows 8 w .. 8 w + 7, columns 4 lane + 128 m (m < 4, 4 each) of an
// [8 keys][512] V stage; P of key (src lane, slot e) by shuffle
__global__ void __launch_bounds__(NT, 1) pv_loop(int stages,
                                                 long long* cycles,
                                                 float* sink) {
  extern __shared__ float smem[];
  float* v = smem;                      // 8 x 512
  for (int i = threadIdx.x; i < 8 * 512; i += NT) v[i] = (i % 89) * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const unsigned vb = static_cast<unsigned>(__cvta_generic_to_shared(v)) +
                      lane * 16;
  float p[8][8], acc[8][16] = {};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) p[r][e] = (lane + r + e) * 1e-3f;
  const long long t0 = clock64();
  for (int s = 0; s < stages; ++s) {
    const int src = s % 32;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float pr[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        pr[r] = __shfl_sync(0xffffffffu, p[r][e], src);
      float4 va[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) va[m] = lds128(vb + e * 2048 + m * 512);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[r][4 * m] = fmaf(pr[r], va[m].x, acc[r][4 * m]);
          acc[r][4 * m + 1] = fmaf(pr[r], va[m].y, acc[r][4 * m + 1]);
          acc[r][4 * m + 2] = fmaf(pr[r], va[m].z, acc[r][4 * m + 2]);
          acc[r][4 * m + 3] = fmaf(pr[r], va[m].w, acc[r][4 * m + 3]);
        }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float t = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) t += acc[r][c];
  if (t == 12345.0f) sink[threadIdx.x] = t;
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  int clock_khz = 0;
  CHECK(cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0));
  printf("%s, %d SMs, %.0f MHz\n", prop.name, prop.multiProcessorCount,
         clock_khz / 1e3);
  const int sms = prop.multiProcessorCount;
  long long* cycles;
  float* sink;
  CHECK(cudaMalloc(&cycles, sms * sizeof(long long)));
  CHECK(cudaMalloc(&sink, NT * sizeof(float)));
  long long host[1024];
  // one block an SM: more shared memory than two blocks could share
  const int smem = 160 * 1024;
  CHECK(cudaFuncSetAttribute(loads,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem));
  CHECK(cudaFuncSetAttribute(s_loop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem));
  CHECK(cudaFuncSetAttribute(pv_loop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem));
  const char* names[] = {
      "LDS.128 1 chunk (full broadcast)", "LDS.128 4 chunks, 1 a quarter",
      "LDS.128 8 chunks, 2 a quarter", "LDS.128 8 chunks, each quarter all 8",
      "LDS.128 32 chunks", "LDS.128 32 64-B rows, 64-B swizzle",
      "LDS.128 32 64-B rows, no swizzle", "LDS.32 32 words",
      "LDS.32 1 word (broadcast)", "LDS.64 32 pairs",
      "LDS.64 1 pair (broadcast)"};
  const int iters = 4096;
  for (int p = 0; p < 11; ++p) {
    loads<<<sms, NT, smem>>>(p, iters, cycles, sink);
    CHECK(cudaDeviceSynchronize());
    CHECK(cudaMemcpy(host, cycles, sms * sizeof(long long),
                     cudaMemcpyDeviceToHost));
    double mean = 0;
    for (int i = 0; i < sms; ++i) mean += host[i];
    mean /= sms;
    printf("%-40s %.3f SM clocks a warp load\n", names[p],
           mean / (iters * 16.0 * (NT / 32)));
  }
  const int stages = 2048;
  for (int which = 0; which < 2; ++which) {
    cudaEvent_t e0, e1;
    CHECK(cudaEventCreate(&e0));
    CHECK(cudaEventCreate(&e1));
    for (int rep = 0; rep < 2; ++rep) {
      CHECK(cudaEventRecord(e0));
      if (which == 0)
        s_loop<<<sms, NT, smem>>>(stages, cycles, sink);
      else
        pv_loop<<<sms, NT, smem>>>(stages, cycles, sink);
      CHECK(cudaEventRecord(e1));
      CHECK(cudaDeviceSynchronize());
    }
    float ms = 0;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    CHECK(cudaMemcpy(host, cycles, sms * sizeof(long long),
                     cudaMemcpyDeviceToHost));
    double mean = 0;
    for (int i = 0; i < sms; ++i) mean += host[i];
    mean /= sms;
    // FMAs a block: S 1024 a thread a stage (8 x 8 x 16), P V 1024 (8 keys
    // x 128)
    const double fma = 1024.0 * NT * stages;
    printf("%s loop: %.1f %% of the FFMA peak by SM clocks, %.3f ms, "
           "%.1f TFLOP/s\n", which == 0 ? "S (8 x 8, 4 channels)"
                                        : "P V (8 x 16, a key)",
           100.0 * fma / (mean * 128.0), ms,
           2.0 * fma * sms / (ms * 1e9));
  }
  return 0;
}
