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
//  * flash_bf16 (fast tier; a mixed head's with fast_head_levels): what
//    _flash_kernel computes in DEFAULT, bf16 q, k, v; S = q k^T and P v by
//    wgmma (bf16 operands, float32 accumulation; P is rounded to bf16 for
//    its product, as the TPU's DEFAULT dot does).  Bound at N = 16,384, C =
//    512: 4 N^2 C = 5.50e11 operations, 0.556 ms at the bf16 tensor-core
//    rate; the q, k, v and float32 output bytes (80 MiB) take 0.025 ms.
//    Every block streams all of K and V through shared memory, so shared
//    memory bounds the design: per 64-key step the two warpgroups' S
//    products read q twice (128 KB: each computes S for half the keys over
//    all of C), K 64 KB, P V 96 KB, and TMA writes 128 KB, ~424 KB at 128
//    B a clock against 2,048 clocks of tensor work.  Halving the L2 reads
//    (two blocks sharing each K / V tile by TMA multicast) gained nothing
//    on the H100.  A block is 64 queries (one m64 block; N = 16,384 gives
//    256 blocks, 1.94 waves on 132 SMs) and two warpgroups; thread 0
//    issues every copy by TMA (3-D maps [B, N, C], so rows past N arrive as
//    zeros and never from the next batch; 64 x 64 boxes with the 128-byte
//    swizzle).  No producer warp: a ninth warp
//    puts three warps on one SM sub-partition, which caps every thread at
//    168 registers; the C = 512 kernel then spilled and ptxas serialized
//    its wgmmas, and setmaxnreg did not lift the cap.  q lands once (C / 64
//    boxes, 64 KB at C = 512); the keys step 64 at a time through two
//    slots, K_j in one and V_j in the other (64 KB each), behind full /
//    empty mbarriers, so K_{j+1} lands during softmax_j and P V_j, and
//    V_{j+1} during S_{j+1}.  The 64 x C float32 output does not fit one
//    warpgroup (256 registers a thread at C = 512), so warpgroup w owns
//    output columns [w C/2, (w+1) C/2) (whole 64-column boxes; at odd C /
//    64 the second's last box multiplies a zero box and is not stored),
//    128 registers a thread at C = 512, and computes S for keys [32 w, 32
//    w + 32) of the step over all of C (wgmma m64n32k16, q and K both
//    K-major from shared memory).  The two halves' row maxima, and at the
//    end their row sums, meet in shared memory behind a named barrier, so
//    both use one m and one alpha.  P (64 x 64 bf16) goes to shared memory
//    in the swizzled layout wgmma reads (A from registers serialized
//    K1's wgmmas), then O_w += P V[:, own columns] by m64n128k16 (V
//    MN-major).  S_{j+1} is issued while P V_j runs, and the next step's
//    key_valid bytes load behind it.  The output (1/256 of a block's
//    bytes at N = 16,384) is stored from the fragments, divided by l, rows
//    past N skipped.
//  * flash_3pass (mixed tier): what _flash_kernel computes in HIGH, the
//    3-pass bf16x3 split of _dot3 (:43): S = hi.hi + hi.lo + lo.hi and, after
//    the online float32 softmax, P v the same way with P split, on wgmma
//    (bf16 operands, float32 accumulation).  Bound at N = 16,384, C = 512: 3
//    x 4 N^2 C = 1.65e12 operations, 1.668 ms at the bf16 tensor-core rate.
//    The split (hi = bf16(x), lo = bf16(x - hi)) is done once a launch, not
//    once a block: split_qkv_kernel writes q's parts (q scaled by C^-1/2 in
//    float32 first, as :131 does), K's and V's into a [6][B, N, C] bf16
//    scratch the wrapper allocates (12 bytes read and written a value, ~0.06
//    ms at N = 16,384; the earlier mma.sync kernel re-read and re-split all
//    of K and V as float32 in every block, which took half its time).  The
//    flash kernel keeps flash_bf16's outer structure: 64 queries a block, two
//    warpgroups, no producer warp, copies by TMA from 3-D [B, N, C] maps
//    (rows past N arrive as zeros, never from the next batch; the 128-byte
//    swizzle).  q's hi and lo stay resident (128 KB at C = 512); K and V
//    stream through a ring of NS3 = 4 slots of 16 KB: per 64-key step NC K
//    stages (64 channels of the step's keys, hi and lo) and 2 NB V stages (32
//    keys of one output box of each warpgroup, hi and lo); ~210 KB of shared
//    memory, one block an SM.  A slot is refilled by the last of the eight
//    warps to release it (a count in shared memory), so no thread waits for
//    the others and the two warpgroups drift apart within the ring's slack
//    (thread 0 refilling once every warp had released, as flash_bf16 does,
//    ran 5.0 ms against 4.8 at N = 16,384, C = 512, one part in S).
//    Warpgroup w computes S for keys [32 w, 32 w + 32) of the step over all
//    of C and owns output columns [64 NB w, 64 NB (w + 1)), as flash_bf16
//    does.  Shared-memory reads bound the design (per step ~450 KB of S
//    operands, ~320 KB of P V operands and 256 KB of TMA writes against
//    ~6,150 clocks of products), so each A operand read feeds two products: B
//    is stacked as [Kh ; Kl] in one m64n64k16 (qh.Kh and qh.Kl in separate
//    accumulator columns, ql.Kh added into the first by an m64n32k16), and P
//    V takes Ph [Vh | Vl] in one m64n128k16 and Pl Vh in one m64n64k16 (three
//    m64n64k16 a box, which would let box b + 1's products run while box b's
//    are folded, ran 4.7 ms against 3.9).  The tensor cores add into float32
//    by truncation, so a long run of wgmmas into one accumulator shrinks it
//    by up to an ulp a step: each K stage's products go into a fresh part
//    added to S with round-to-nearest (two parts, so stage c + 1's products
//    run while stage c's part is added: 3.9 ms against 4.8 with one), and
//    each output box's P V of the step into a fresh part folded as o =
//    fmaf(o, alpha, part). Scores stay in registers (dead keys -inf on the
//    fragment); the two halves' row maxima, and at the end their row sums,
//    meet in shared memory; P is split in registers and stored, hi and lo, in
//    the swizzled K-major layout wgmma reads.
//  * flash_f32 (parity tier): what _flash_kernel computes in HIGHEST,
//    exact float32: q scaled by C^-1/2 first (one rounded multiply, as
//    :131), every product an fmaf on the CUDA cores (no TF32, no tensor
//    cores), expf, the online softmax in float32.  Bound at N = 16,384, C
//    = 512: 4 N^2 C = 5.50e11 operations, 8.205 ms at the 67 TFLOP/s
//    float32 rate, so the design is about feeding 128 FFMAs a clock an SM
//    from registers.  A block is 64 queries and 8 warps, warp w owning
//    rows 8 w .. 8 w + 7 in both products, so each row's max, sum and P
//    stay in its warp.  A step is BK32 = 128 keys: S is an outer-product
//    register tile of 8 rows x 4 keys a thread (keys lane + 32 j), P V one
//    of 8 rows x C / 32 columns (128 registers at C = 512, which leaves
//    no room for a larger S tile).  Shared loads cost by quarter-warp
//    (tools/smem_probe.cu on the H100: a 128-bit load takes 4.0 SM clocks
//    when each quarter-warp reads 8 chunks, 2.3 when it reads one, as a
//    broadcast does), so per 4 channels S takes 8 q broadcasts and 4 K
//    loads, ~34 clocks of loads for 32 of FFMAs: shared memory bounds S.
//    P V takes per key 4 V loads of 4 columns (2 at odd C / 64) and per 4
//    keys one P broadcast a row, ~21 clocks for 32.  q stays resident
//    (128 KB at C = 512, scaled in place once); K and V stream through a
//    ring of NS32 = 4 slots of 16 KB behind full / empty mbarriers, copied
//    by TMA from 3-D [B, N, C] maps (rows past N arrive as zeros, never
//    from the next batch): a K stage is the step's 128 keys x 32 channels
//    (the 128-byte swizzle, so the 8 lanes of a quarter-warp read 8 bank
//    groups), a V stage 8 keys x C.  P goes to shared memory, 8 rows x 128
//    keys a warp (32 KB), and comes back as broadcasts.  ~225 KB of shared
//    memory, one block an SM; 255 registers, no spills.  Thread 0 issues
//    the copies: after each stage it waits until every warp has released
//    it and refills its slot.  This keeps the 8 warps in step: a thread 0
//    that refilled only slots already free, never waiting, let the warps
//    drift apart and ran far slower (sub-partitions idled while the
//    slowest warp caught up); a ninth, producer warp would cap every
//    thread at 168 registers.
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

#include "hopper.cuh"

#include <cuda_bf16.h>

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

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

// ---------------------------------------------------------------- bf16 ----
constexpr int BQ16 = 64;                // queries a block: one m64 block
constexpr int BKV16 = 64;               // keys a step
// two warpgroups, thread 0 of which also issues the copies: a ninth warp
// (a producer) would put three warps on one SM sub-partition and cap every
// thread at 168 registers, which spilled the C = 512 kernel and serialized
// its wgmmas (setmaxnreg did not lift ptxas' cap); 8 warps allow 255
constexpr int NT16 = 256;
constexpr int BOX16 = 64 * 128;         // one 64-row x 64-column bf16 box

// Shared memory of flash_bf16_kernel<NC> (C = 64 NC) from a 1024-byte
// aligned base: q (NC boxes), the K slot (NC boxes), the V slot (NB boxes
// a warpgroup; at odd NC the last is zeros, never loaded), P (one box),
// the two warpgroups' row maxima and row sums, five mbarriers.
template <int NC>
struct Bf16Smem {
  static constexpr int NB = (NC + 1) / 2;   // output boxes a warpgroup
  static constexpr int Q = 0;
  static constexpr int K = Q + NC * BOX16;
  static constexpr int V = K + NC * BOX16;
  static constexpr int P = V + 2 * NB * BOX16;
  static constexpr int MX = P + BOX16;              // float [2][64]
  static constexpr int LS = MX + 2 * BQ16 * 4;      // float [2][64]
  static constexpr int BAR = LS + 2 * BQ16 * 4;
  static constexpr int BYTES = BAR + 5 * 8 + 1024;  // + the alignment
};
static_assert(Bf16Smem<8>::BYTES <= 232448, "shared memory");

__device__ __forceinline__ void sync16() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT16) : "memory");
}

// NC boxes of rows [row0, row0 + 64) of a [B, N, C] map into dst, on bar
template <int NC>
__device__ __forceinline__ void load_boxes(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint32_t bar, int row0, int b) {
  hopper::mbar_expect_tx(bar, NC * BOX16);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    hopper::tma_load_3d(dst + c * BOX16, map, bar, 64 * c, row0, b);
}

// wgmma descriptor of a K-major operand in 64 x 64 boxes with the 128-byte
// swizzle (q, K, P): rows of 128 B, 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return hopper::make_desc(addr, 16, 1024, hopper::LAYOUT_B128);
}

// wgmma descriptor of V [16 keys][64 or 128 columns], MN-major in 64 x 64
// boxes with the 128-byte swizzle: the leading offset is the 8 KB between
// two boxes' columns, the stride the 1 KB between groups of 8 keys
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) {
  return hopper::make_desc(addr, BOX16, 1024, hopper::LAYOUT_B128);
}

// x, hidden from the compiler: a descriptor built from it is built where it
// is used, not hoisted out of the key loop (the loop-invariant descriptors
// of a step's wgmmas would hold ~150 registers)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// s[64 x 32] = q[64 x 64 NC] K[32 keys at kw_s, 64 NC]^T, both K-major
// (fresh: s is zeroed first), one commit group.  Each descriptor is the
// operand's base descriptor plus its byte offset / 16 in the start-address
// field (no carry: shared addresses stay below 256 KB).
template <int NC>
__device__ __forceinline__ void s_wgmmas(float* s, uint32_t q_s,
                                         uint32_t kw_s) {
#pragma unroll
  for (int q = 0; q < 16; ++q) s[q] = 0.0f;
  hopper::fence_operands<16>(s);
  const uint64_t qd = kmajor_desc(opaque(q_s));
  const uint64_t kd = kmajor_desc(opaque(kw_s));
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int off = (c * BOX16 + kk * 32) >> 4;
      hopper::wgmma_ss<32, 0>(s, qd + off, kd + off);
    }
  hopper::wgmma_commit();
}

// The key_valid bytes of this lane's two keys of the step at kv0, kv0 + 2
// lane (+ 1), as loaded (byte 0, byte 1; 0 for a key past N, 1 for a live
// key without a mask); their test waits for live_bits, a step later, so
// the load's latency hides behind the step's waits
__device__ __forceinline__ unsigned mask_bytes(const unsigned char* kvalid,
                                               int kv0, int N, int lane) {
  const int key = kv0 + 2 * lane;
  if (kvalid == nullptr)
    return (key < N ? 1u : 0u) | (key + 1 < N ? 256u : 0u);
  if (key + 1 < N)
    return __ldg(reinterpret_cast<const unsigned short*>(kvalid + key));
  return key < N ? __ldg(kvalid + key) : 0u;
}

// This thread's 8 keys of the step (key kb + 8 jj + e at bit 2 jj + e, kb
// even), 1 where live, from the warp's mask_bytes: a ballot each of the
// even and the odd keys
__device__ __forceinline__ unsigned live_bits(unsigned bytes, int kb) {
  const unsigned even = __ballot_sync(0xffffffffu, (bytes & 0xFFu) != 0);
  const unsigned odd = __ballot_sync(0xffffffffu, (bytes >> 8) != 0);
  unsigned bits = 0;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int l = kb / 2 + 4 * jj;
    bits |= ((even >> l) & 1u) << (2 * jj);
    bits |= ((odd >> l) & 1u) << (2 * jj + 1);
  }
  return bits;
}

// o[64 x 64 NB] += P[64 x 64] V[64 keys, the NB boxes at v_s]: per 16-key
// step one m64n128k16 a pair of boxes, m64n64k16 for an odd one
template <int NB>
__device__ __forceinline__ void pv_wgmmas(float* o, uint32_t p_s,
                                          uint32_t v_s) {
  const uint64_t pd = kmajor_desc(opaque(p_s)), vd = v_desc(opaque(v_s));
#pragma unroll
  for (int ks = 0; ks < BKV16 / 16; ++ks) {
#pragma unroll
    for (int pr = 0; pr < NB / 2; ++pr)
      hopper::wgmma_ss<128, 1>(o + 64 * pr, pd + ks * 2,
                               vd + ((2 * pr * BOX16 + ks * 2048) >> 4));
    if constexpr (NB % 2 == 1)
      hopper::wgmma_ss<64, 1>(o + 64 * (NB / 2), pd + ks * 2,
                              vd + (((NB - 1) * BOX16 + ks * 2048) >> 4));
  }
}

template <int NC>
__global__ void __launch_bounds__(NT16, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const unsigned char* __restrict__ kvalid, float* __restrict__ out,
    int N, float scale) {
  typedef Bf16Smem<NC> L;
  constexpr int NB = L::NB, C = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base_s = hopper::smem_u32(smem);
  const uint32_t q_s = base_s + L::Q, k_s = base_s + L::K;
  const uint32_t v_s = base_s + L::V, p_s = base_s + L::P;
  float* mx = reinterpret_cast<float*>(smem + L::MX);
  float* ls = reinterpret_cast<float*>(smem + L::LS);
  const uint32_t q_full = base_s + L::BAR, k_full = q_full + 8,
                 k_empty = q_full + 16, v_full = q_full + 24,
                 v_empty = q_full + 32;

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ16;
  const int ntiles = (N + BKV16 - 1) / BKV16;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(k_full, 1);
    hopper::mbar_init(v_full, 1);
    hopper::mbar_init(k_empty, NT16 / 32);
    hopper::mbar_init(v_empty, NT16 / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (NC % 2 == 1) {
    // the second warpgroup's last V box: zeros, read by wgmma only
    uint4* z = reinterpret_cast<uint4*>(smem + L::V + NC * BOX16);
    for (int i = tid; i < BOX16 / 16; i += NT16)
      z[i] = make_uint4(0, 0, 0, 0);
    hopper::fence_proxy_async();
  }
  __syncthreads();
  // thread 0 issues every copy: q and the first K and V now, each later one
  // once every warp has arrived on the slot's empty barrier
  if (tid == 0) {
    load_boxes<NC>(q_s, &qmap, q_full, q0, b);
    load_boxes<NC>(k_s, &kmap, k_full, 0, b);
    load_boxes<NC>(v_s, &vmap, v_full, 0, b);
  }

  // warpgroup wg, its warp wl, the fragment's rows r0, r0 + 8
  const int wg = tid / 128, wl = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * wl + g;
  const int other = (wg ^ 1) * BQ16;
  // this warpgroup's keys of a step (S) and its boxes of V (P V)
  const uint32_t kw_s = k_s + 32 * 128 * wg;
  const uint32_t vw_s = v_s + NB * BOX16 * wg;
  // wgmma fragments: s[4 j + 2 i + e] is row r0 + 8 i, key 32 wg + 8 j +
  // 2 t + e of the step; o[4 j + 2 i + e] row r0 + 8 i, column 64 NB wg +
  // 8 j + 2 t + e
  float o[NB * 32], s[16];
#pragma unroll
  for (int q = 0; q < NB * 32; ++q) o[q] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  const int kb = 32 * wg + 2 * t;   // this thread's first key of a step
  unsigned bytes = mask_bytes(kvalid, 0, N, lane);

  hopper::mbar_wait(q_full, 0);
  hopper::mbar_wait(k_full, 0);
  s_wgmmas<NC>(s, q_s, kw_s);
  hopper::wgmma_wait<0>();
  hopper::fence_operands<16>(s);
  if (lane == 0) hopper::mbar_arrive(k_empty);
  if (tid == 0 && ntiles > 1) {
    hopper::mbar_wait(k_empty, 0);
    load_boxes<NC>(k_s, &kmap, k_full, BKV16, b);
  }

#pragma unroll 1
  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * BKV16;
    // scaled scores; keys past N or outside key_valid score -inf
    const unsigned live = kvalid == nullptr && kv0 + BKV16 <= N
                              ? 0xFFu : live_bits(bytes, kb);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * jj + 2 * i + e];
          x = (live >> (2 * jj + e)) & 1u ? x * scale : -INFINITY;
          mt[i] = fmaxf(mt[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    }
    // the row maxima of both halves of the step
    if (t == 0) {
      mx[wg * BQ16 + r0] = mt[0];
      mx[wg * BQ16 + r0 + 8] = mt[1];
    }
    sync16();
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mt_both = fmaxf(mt[i], mx[other + r0 + 8 * i]);
      const float m_next = fmaxf(m_run[i], mt_both);
      const float ref = softmax_ref(m_next);
      alpha[i] = expf(m_run[i] - ref);
      m_run[i] = m_next;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * jj + 2 * i + e];
          x = expf(x - ref);
          rs += x;
        }
      l_run[i] = l_run[i] * alpha[i] + rs;
    }
    // P in bf16, K-major with the 128-byte swizzle: row r's 16-byte chunk
    // c at ((c ^ (r % 8)) << 4); r % 8 == g
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(
            smem + L::P + (r0 + 8 * i) * 128 + (((4 * wg + jj) ^ g) << 4) +
            4 * t) = __floats2bfloat162_rn(s[4 * jj + 2 * i],
                                           s[4 * jj + 2 * i + 1]);
#pragma unroll
    for (int q = 0; q < NB * 32; ++q) o[q] *= alpha[(q >> 1) & 1];
    hopper::fence_proxy_async();   // P's generic stores, before wgmma reads
    sync16();                      // both halves of P are in place

    hopper::mbar_wait(v_full, j & 1);
    hopper::fence_operands<NB * 32>(o);
    hopper::wgmma_fence();
    pv_wgmmas<NB>(o, p_s, vw_s);
    hopper::wgmma_commit();
    if (j + 1 < ntiles) {
      // the next step's S while P V runs
      hopper::mbar_wait(k_full, (j + 1) & 1);
      s_wgmmas<NC>(s, q_s, kw_s);
      bytes = mask_bytes(kvalid, kv0 + BKV16, N, lane);
      hopper::wgmma_wait<1>();
      hopper::fence_operands<NB * 32>(o);
      if (lane == 0) hopper::mbar_arrive(v_empty);
      if (tid == 0) {   // V_{j+1} once every warp's P V_j is done
        hopper::mbar_wait(v_empty, j & 1);
        load_boxes<NC>(v_s, &vmap, v_full, kv0 + BKV16, b);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands<16>(s);
      if (lane == 0) hopper::mbar_arrive(k_empty);
      if (tid == 0 && j + 2 < ntiles) {   // K_{j+2} once S_{j+1} is done
        hopper::mbar_wait(k_empty, (j + 1) & 1);
        load_boxes<NC>(k_s, &kmap, k_full, kv0 + 2 * BKV16, b);
      }
    } else {
      hopper::wgmma_wait<0>();
      hopper::fence_operands<NB * 32>(o);
    }
  }

  // the row sums: this thread's keys, its quad's, then both warpgroups'
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i] + __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (t == 0) {
    ls[wg * BQ16 + r0] = l[0];
    ls[wg * BQ16 + r0 + 8] = l[1];
  }
  sync16();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += ls[other + r0 + 8 * i];
    const int row = q0 + r0 + 8 * i;
    if (row >= N) continue;
    float* orow = out + (static_cast<size_t>(b) * N + row) * C +
                  64 * NB * wg;
#pragma unroll
    for (int jj = 0; jj < 8 * NB; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (64 * NB * wg + col < C)
        *reinterpret_cast<float2*>(orow + col) = make_float2(
            o[4 * jj + 2 * i] / l[i], o[4 * jj + 2 * i + 1] / l[i]);
    }
  }
}

// Maps of q, k, v [B, N, C] (64 x 64 boxes, the 128-byte swizzle), the
// launch: one block a 64-query tile and batch element.
template <int NC>
int launch_bf16(const void* q, const void* k, const void* v,
                const unsigned char* kvalid, float* out, int B, int N,
                float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const uint64_t dims[3] = {uint64_t(64 * NC), uint64_t(N), uint64_t(B)};
  const uint32_t box[3] = {64, BKV16, 1};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::make_map(&maps[i], ptrs[i], 3, dims, box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  const int smem = Bf16Smem<NC>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BQ16 - 1) / BQ16, B);
  flash_bf16_kernel<NC><<<grid, NT16, smem, stream>>>(
      maps[0], maps[1], maps[2], kvalid, out, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32 -----
constexpr int MAXC32 = 512;       // C / 64 <= 8
constexpr int BQ32 = 64;          // queries a block: 8 rows a warp
constexpr int JK32 = 4;           // keys a lane a step: lane + 32 j, j < JK32
constexpr int BK32 = 32 * JK32;   // keys a step
constexpr int NT32 = 256;         // 8 warps; thread 0 also issues the copies
constexpr int KC32 = 32;          // channels of a K stage: BK32 rows of 128 B
constexpr int VK32 = 8;           // keys of a V stage: 8 x C
constexpr int NS32 = 4;           // ring slots
constexpr int SLOT32 = BK32 * KC32 * 4;   // 16 KB: a K stage, a V one at C 512
constexpr int QBOX32 = 64 * 64 * 4;       // a 64-row x 64-column q box
static_assert(SLOT32 >= VK32 * MAXC32 * 4, "a V stage fits a slot");
static_assert(KC32 * 4 == 128, "K stage rows span the 128-byte swizzle");

// Shared memory of flash_f32_kernel<NC> (C = 64 NC) from a 1024-byte
// aligned base: q (NC boxes [64 rows][64 columns]), the ring's NS32 slots,
// P (each warp's 8 rows x BK32 keys), the ring's full and empty mbarriers
// and q's.  A step of BK32 keys is KST K stages (all its keys, KC32
// channels each) and then BK32 / VK32 V stages (8 keys, all of C each; NC
// boxes [8 keys][64 columns]).
template <int NC>
struct F32Smem {
  static constexpr int KST = 64 * NC / KC32;
  static constexpr int STAGES = KST + BK32 / VK32;   // a step
  static constexpr int Q = 0;
  static constexpr int RING = Q + NC * QBOX32;
  static constexpr int P = RING + NS32 * SLOT32;
  static constexpr int BAR = P + BQ32 * BK32 * 4;
  static constexpr int BYTES = BAR + (2 * NS32 + 1) * 8 + 1024;
};
static_assert(F32Smem<8>::BYTES <= 232448, "shared memory");

// Stage g of the ring (step g / STAGES) into slot g % NS32 by TMA,
// completing on that slot's full barrier: a K stage, or a V stage's NC
// boxes.  Rows at or past N arrive as zeros.
template <int NC>
__device__ __forceinline__ void f32_stage_copy(int g, uint32_t ring_s,
                                               uint32_t full_s,
                                               const CUtensorMap* kmap,
                                               const CUtensorMap* vmap,
                                               int b) {
  typedef F32Smem<NC> L;
  const int step = g / L::STAGES, i = g - step * L::STAGES;
  const uint32_t dst = ring_s + (g % NS32) * SLOT32;
  const uint32_t bar = full_s + (g % NS32) * 8;
  if (i < L::KST) {
    hopper::mbar_expect_tx(bar, SLOT32);
    hopper::tma_load_3d(dst, kmap, bar, KC32 * i, BK32 * step, b);
  } else {
    const int row = BK32 * step + VK32 * (i - L::KST);
    hopper::mbar_expect_tx(bar, NC * VK32 * 256);
#pragma unroll
    for (int m = 0; m < NC; ++m)
      hopper::tma_load_3d(dst + m * VK32 * 256, vmap, bar, 64 * m, row, b);
  }
}

// The ring, as each thread tracks it: stage g's slot, waited for, and
// released once every lane of the warp is done reading it; thread 0 then
// waits until every warp has released it and refills it with the stage
// NS32 later.  Shared addresses are 32-bit offsets from the aligned base.
template <int NC>
struct F32Ring {
  uint32_t base_s;
  int b, nst, g = 0;

  __device__ __forceinline__ uint32_t full(int h) const {
    return base_s + F32Smem<NC>::BAR + (h % NS32) * 8;
  }
  __device__ __forceinline__ uint32_t empty(int h) const {
    return full(h) + 8 * NS32;
  }

  // the byte offset of stage g's slot from the aligned base, once it landed
  __device__ __forceinline__ int wait() const {
    hopper::mbar_wait(full(g), (g / NS32) & 1);
    return F32Smem<NC>::RING + (g % NS32) * SLOT32;
  }

  __device__ __forceinline__ void release(int tid, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap) {
    __syncwarp();
    if (tid % 32 == 0) hopper::mbar_arrive(empty(g));
    if (tid == 0 && g + NS32 < nst) {
      hopper::mbar_wait(empty(g), (g / NS32) & 1);
      f32_stage_copy<NC>(g + NS32, base_s + F32Smem<NC>::RING,
                         base_s + F32Smem<NC>::BAR, kmap, vmap, b);
    }
    ++g;
  }
};

template <int NC>
__global__ void __launch_bounds__(NT32, 1) flash_f32_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const unsigned char* __restrict__ kvalid, float* __restrict__ out,
    int N, float scale) {
  typedef F32Smem<NC> L;
  constexpr int C = 64 * NC;
  // aligned by an offset from smem_raw (not through an integer), so the
  // compiler keeps every access below in the shared window: 32-bit
  // addresses and shared loads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  float* qs = reinterpret_cast<float*>(smem + L::Q);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* pw = reinterpret_cast<float*>(smem + L::P) + warp * 8 * BK32;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ32;
  const int nsteps = (N + BK32 - 1) / BK32;
  F32Ring<NC> ring;
  ring.base_s = base_s;
  ring.b = b;
  ring.nst = nsteps * L::STAGES;
  const uint32_t q_full = base_s + L::BAR + 16 * NS32;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < NS32; ++i) {
      hopper::mbar_init(ring.full(i), 1);
      hopper::mbar_init(ring.empty(i), NT32 / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_full, NC * QBOX32);
    for (int m = 0; m < NC; ++m)
      hopper::tma_load_3d(base_s + L::Q + m * QBOX32, &qmap, q_full, 64 * m,
                          q0, b);
    for (int g = 0; g < NS32 && g < ring.nst; ++g)
      f32_stage_copy<NC>(g, base_s + L::RING, base_s + L::BAR, &kmap, &vmap,
                         b);
  }
  // q times C^-1/2, one rounded multiply each, as the reference's q * scale
  hopper::mbar_wait(q_full, 0);
  for (int i = tid; i < NC * QBOX32 / 16; i += NT32) {
    float4* p = reinterpret_cast<float4*>(qs) + i;
    float4 x = *p;
    x.x = __fmul_rn(x.x, scale);
    x.y = __fmul_rn(x.y, scale);
    x.z = __fmul_rn(x.z, scale);
    x.w = __fmul_rn(x.w, scale);
    *p = x;
  }
  __syncthreads();

  // S: this warp's rows 8 warp + r, this lane's keys lane + 32 j of a step.
  // TMA's 128-byte swizzle keeps the 16-byte chunk c of a K stage's key row
  // k at c ^ (k % 8), the same for k = lane + 32 j and every j: the eight
  // lanes of a quarter-warp read eight different bank groups.
  const int sw = lane & 7;
  const float* qw = qs + warp * 8 * 64;   // row 8 warp of the first box
  // P V: o[r][VW m + x] is row 8 warp + r, column 32 VW m + VW lane + x:
  // VW = 4 columns a lane and load (2 at odd NC), NV loads a key; in a V
  // stage (NC boxes [8 keys][64 columns]) at lane_v + m_v(m) floats
  constexpr int VW = NC % 2 == 0 ? 4 : 2, NV = 2 * NC / VW;
  const int lane_v = (VW * lane / 64) * VK32 * 64 + (VW * lane) % 64;
  float o[8][2 * NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 2 * NC; ++m) o[r][m] = 0.0f;
  // the running max and sum of row 8 warp + r, kept by lane r
  float m_lane = -INFINITY, l_lane = 0.0f;

#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    const int kv0 = step * BK32;
    // bit j: key kv0 + lane + 32 j is below N and, given a mask, live
    unsigned live = 0xFFu;
    if (kvalid != nullptr || kv0 + BK32 > N) {
      live = 0;
#pragma unroll
      for (int j = 0; j < JK32; ++j)
        live |= unsigned(key_live(kvalid, kv0 + lane + 32 * j, N)) << j;
    }
    float s[8][JK32];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < JK32; ++j) s[r][j] = 0.0f;
#pragma unroll 1
    for (int kc = 0; kc < L::KST; ++kc) {
      const float* ks =
          reinterpret_cast<const float*>(smem + ring.wait()) + lane * KC32;
      const float* qc = qw + (kc * KC32 / 64) * (QBOX32 / 4) +
                        (kc * KC32) % 64;
#pragma unroll
      for (int c4 = 0; c4 < KC32 / 4; ++c4) {
        float4 kf[JK32];
#pragma unroll
        for (int j = 0; j < JK32; ++j)
          kf[j] = *reinterpret_cast<const float4*>(ks + 32 * KC32 * j +
                                                   4 * (c4 ^ sw));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qc + 64 * r + 4 * c4);
#pragma unroll
          for (int j = 0; j < JK32; ++j) {
            s[r][j] = fmaf(qv.x, kf[j].x, s[r][j]);
            s[r][j] = fmaf(qv.y, kf[j].y, s[r][j]);
            s[r][j] = fmaf(qv.z, kf[j].z, s[r][j]);
            s[r][j] = fmaf(qv.w, kf[j].w, s[r][j]);
          }
        }
      }
      ring.release(tid, &kmap, &vmap);
    }

    // the online softmax of each row over the step's keys, dead keys -inf
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < JK32; ++j) {
        if (!((live >> j) & 1u)) s[r][j] = -INFINITY;
        mt = fmaxf(mt, s[r][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = __shfl_sync(0xffffffffu, m_lane, r);
      const float m_next = fmaxf(m_old, mt);
      const float base = softmax_ref(m_next);
      const float alpha = expf(m_old - base);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < JK32; ++j) {
        s[r][j] = expf(s[r][j] - base);
        rs += s[r][j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float l_old = __shfl_sync(0xffffffffu, l_lane, r);
      if (lane == r) {
        m_lane = m_next;
        l_lane = l_old * alpha + rs;
      }
#pragma unroll
      for (int m = 0; m < 2 * NC; ++m) o[r][m] *= alpha;
    }

    // P to this warp's rows of shared memory, once its last P V has read
    // them: pw[r][key of the step]
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < JK32; ++j) pw[r * BK32 + lane + 32 * j] = s[r][j];
    __syncwarp();

    // P V: V stage v holds keys 8 v .. 8 v + 7 of the step; their P comes
    // four keys a row at a time, one broadcast load
#pragma unroll 1
    for (int v = 0; v < BK32 / VK32; ++v) {
      const float* vs =
          reinterpret_cast<const float*>(smem + ring.wait()) + lane_v;
#pragma unroll
      for (int e4 = 0; e4 < VK32; e4 += 4) {
        float4 pr[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          pr[r] = *reinterpret_cast<const float4*>(pw + r * BK32 +
                                                   VK32 * v + e4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[2 * NC];
#pragma unroll
          for (int m = 0; m < NV; ++m) {
            const float* src = vs + (VW * m / 2) * VK32 * 64 + (e4 + e) * 64;
            if constexpr (VW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(src);
              vv[4 * m] = x.x;
              vv[4 * m + 1] = x.y;
              vv[4 * m + 2] = x.z;
              vv[4 * m + 3] = x.w;
            } else {
              const float2 x = *reinterpret_cast<const float2*>(src);
              vv[2 * m] = x.x;
              vv[2 * m + 1] = x.y;
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float p = e == 0 ? pr[r].x : e == 1 ? pr[r].y
                            : e == 2 ? pr[r].z : pr[r].w;
#pragma unroll
            for (int m = 0; m < 2 * NC; ++m)
              o[r][m] = fmaf(p, vv[m], o[r][m]);
          }
        }
      }
      ring.release(tid, &kmap, &vmap);
    }
  }

  // divided by the row sums; rows past N are not stored
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float l = __shfl_sync(0xffffffffu, l_lane, r);
    const int row = q0 + 8 * warp + r;
    if (row >= N) continue;
    float* orow = out + (static_cast<size_t>(b) * N + row) * C + VW * lane;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(orow + 128 * m) =
            make_float4(o[r][4 * m] / l, o[r][4 * m + 1] / l,
                        o[r][4 * m + 2] / l, o[r][4 * m + 3] / l);
      else
        *reinterpret_cast<float2*>(orow + 64 * m) =
            make_float2(o[r][2 * m] / l, o[r][2 * m + 1] / l);
    }
  }
}

// Maps of q (64 x 64 boxes), K (16 channels x 256 keys, the 64-byte
// swizzle) and V (64 x 8 boxes), all [B, N, C] float32; the launch: one
// block a 64-query tile and batch element.
template <int NC>
int launch_f32(const void* q, const void* k, const void* v,
               const unsigned char* kvalid, float* out, int B, int N,
               float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const uint64_t dims[3] = {uint64_t(64 * NC), uint64_t(N), uint64_t(B)};
  const uint32_t boxes[3][3] = {{64, BQ32, 1}, {KC32, BK32, 1}, {64, VK32, 1}};
  const CUtensorMapSwizzle swz[3] = {CU_TENSOR_MAP_SWIZZLE_NONE,
                                     CU_TENSOR_MAP_SWIZZLE_128B,
                                     CU_TENSOR_MAP_SWIZZLE_NONE};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::make_map(&maps[i], ptrs[i], 3, dims, boxes[i],
                                     swz[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != 0) return err;
  }
  const int smem = F32Smem<NC>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BQ32 - 1) / BQ32, B);
  flash_f32_kernel<NC><<<grid, NT32, smem, stream>>>(
      maps[0], maps[1], maps[2], kvalid, out, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- 3-pass ----
constexpr int BQ3 = 64;               // queries a block: one m64 block
constexpr int BKV3 = 64;              // keys a step
constexpr int NT3 = 256;              // two warpgroups, no producer warp
constexpr int NS3 = 4;                // ring slots
constexpr int QUART3 = 32 * 128;      // 32 rows x 64 bf16 columns (4 KB)
constexpr int SLOT3 = 4 * QUART3;     // a stage: four quarters (16 KB)

// Shared memory of flash_3pass_kernel<NC> (C = 64 NC) from a 1024-byte
// aligned base: q's hi and lo parts (NC boxes each), the ring's NS3 slots,
// P's hi and lo parts (one box each), the two warpgroups' row maxima and
// row sums, the ring's release counts, q's mbarrier and the ring's full
// ones.  A step of BKV3 keys is NC K stages (chunk c: channels 64 c .. 64 c + 63 of the
// step's keys, quarters Kh keys 0-31, Kl keys 0-31, Kh 32-63, Kl 32-63)
// and then 2 NB V stages (box b's keys 32 h .. 32 h + 31, h = 0, 1:
// quarters Vh and Vl of warpgroup 0's box b, Vh and Vl of warpgroup 1's
// box NB + b, which at odd NC is past C and never copied).
template <int NC>
struct Pass3Smem {
  static constexpr int NB = (NC + 1) / 2;      // output boxes a warpgroup
  static constexpr int STAGES = NC + 2 * NB;   // a step
  static constexpr int QH = 0;
  static constexpr int QL = QH + NC * BOX16;
  static constexpr int RING = QL + NC * BOX16;
  static constexpr int PH = RING + NS3 * SLOT3;
  static constexpr int PL = PH + BOX16;
  static constexpr int MX = PL + BOX16;            // float [2][64]
  static constexpr int LS = MX + 2 * BQ3 * 4;      // float [2][64]
  static constexpr int CNT = LS + 2 * BQ3 * 4;     // int [NS3]
  static constexpr int BAR = CNT + 8 * NS3;         // q, full[NS3]
  static constexpr int BYTES = BAR + (1 + NS3) * 8 + 1024;
};
static_assert(Pass3Smem<8>::BYTES <= 232448, "shared memory");

// _dot3's split: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact)
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(x);
  lo = __float2bfloat16(x - __bfloat162float(hi));
}

__device__ __forceinline__ uint2 pack4(const bf16 (&h)[4]) {
  uint2 r;
  r.x = static_cast<unsigned>(__bfloat16_as_ushort(h[0])) |
        (static_cast<unsigned>(__bfloat16_as_ushort(h[1])) << 16);
  r.y = static_cast<unsigned>(__bfloat16_as_ushort(h[2])) |
        (static_cast<unsigned>(__bfloat16_as_ushort(h[3])) << 16);
  return r;
}

// The split of q (times scale: one rounded float32 multiply, never fused
// into the split), k and v, once a launch: tensor blockIdx.y of the three,
// n values each, into parts [3][2][n] (hi, lo of q, then of k, of v).
// Bound by its bytes: 12 n read, 12 n written.
__global__ void __launch_bounds__(256) split_qkv_kernel(
    const float4* __restrict__ q, const float4* __restrict__ k,
    const float4* __restrict__ v, uint2* __restrict__ parts, long long n,
    float scale) {
  const int w = blockIdx.y;
  const float4* src = w == 0 ? q : w == 1 ? k : v;
  const float s = w == 0 ? scale : 1.0f;
  const long long n4 = n / 4;
  uint2* hi = parts + 2 * w * n4;
  uint2* lo = hi + n4;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += 256ll * gridDim.x) {
    const float4 x = __ldcs(src + i);
    const float xs[4] = {__fmul_rn(x.x, s), __fmul_rn(x.y, s),
                         __fmul_rn(x.z, s), __fmul_rn(x.w, s)};
    bf16 h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(xs[e], h[e], l[e]);
    hi[i] = pack4(h);
    lo[i] = pack4(l);
  }
}

// Stage g of the ring (step g / STAGES) into slot g % NS3 by TMA,
// completing on that slot's full barrier (Pass3Smem's layout).  Rows at or
// past N arrive as zeros.
template <int NC>
__device__ __forceinline__ void pass3_stage_copy(int g, uint32_t base_s,
                                                 const CUtensorMap* maps,
                                                 int b) {
  typedef Pass3Smem<NC> L;
  const int step = g / L::STAGES, i = g - step * L::STAGES;
  const uint32_t dst = base_s + L::RING + (g % NS3) * SLOT3;
  const uint32_t bar = base_s + L::BAR + 8 + (g % NS3) * 8;
  const int kv0 = step * BKV3;
  if (i < NC) {   // K: maps[2] Kh, maps[3] Kl
    hopper::mbar_expect_tx(bar, SLOT3);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      hopper::tma_load_3d(dst + p * QUART3, &maps[2 + p % 2], bar, 64 * i,
                          kv0 + 32 * (p / 2), b);
  } else {        // V: maps[4] Vh, maps[5] Vl
    const int box = (i - NC) / 2, row = kv0 + 32 * ((i - NC) % 2);
    const bool second = L::NB + box < NC;
    hopper::mbar_expect_tx(bar, second ? SLOT3 : 2 * QUART3);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p < 2 || second)
        hopper::tma_load_3d(dst + p * QUART3, &maps[4 + p % 2], bar,
                            64 * (box + (p / 2) * L::NB), row, b);
  }
}

// wgmma descriptor of a V stage's [Vh | Vl] quarters of one warpgroup as
// B [16 keys][128 columns], MN-major with the 128-byte swizzle: the leading
// offset is the 4 KB from Vh's 64 columns to Vl's, the stride the 1 KB
// between groups of 8 keys (v_desc's layout with quarters for boxes)
__device__ __forceinline__ uint64_t v3_desc(uint32_t addr) {
  return hopper::make_desc(addr, QUART3, 1024, hopper::LAYOUT_B128);
}

// The ring, as each thread tracks it: stage g's slot is waited for, read
// by both warpgroups' wgmmas, and released by each warp once its wgmmas on
// it are done; the last of the eight warps to release it (a count in
// shared memory) refills it with the stage NS3 later.  No thread waits for
// the others: the two warpgroups may drift apart by up to the ring's
// slack, so one's products fill the other's waits and folds.
template <int NC>
struct Pass3Ring {
  uint32_t base_s;
  int* released;   // [NS3] warps done with the slot's current stage
  int b, nst, g = 0;

  __device__ __forceinline__ uint32_t full(int h) const {
    return base_s + Pass3Smem<NC>::BAR + 8 + (h % NS3) * 8;
  }
  // the shared address of stage h's slot, once it landed
  __device__ __forceinline__ uint32_t wait(int h) const {
    hopper::mbar_wait(full(h), (h / NS3) & 1);
    return base_s + Pass3Smem<NC>::RING + (h % NS3) * SLOT3;
  }
  __device__ __forceinline__ void release(int tid, const CUtensorMap* maps) {
    if (tid % 32 == 0) {
      __threadfence_block();
      if (atomicAdd(released + g % NS3, 1) == NT3 / 32 - 1) {
        atomicExch(released + g % NS3, 0);
        if (g + NS3 < nst) pass3_stage_copy<NC>(g + NS3, base_s, maps, b);
      }
    }
    ++g;
  }
};

// part[64 x 32 | 32] = qh [Kh ; Kl] + ql [Kh ; 0] of one K stage at k_s
// (fresh: part is zeroed first), warpgroup wg's keys: qh.Kh (+ ql.Kh) in
// columns 0-31, qh.Kl in 32-63; one commit group
__device__ __forceinline__ void s_stage(float* part, uint32_t qh_s,
                                        uint32_t ql_s, uint32_t k_s,
                                        int wg) {
#pragma unroll
  for (int x = 0; x < 32; ++x) part[x] = 0.0f;
  hopper::fence_operands<32>(part);
  const uint64_t qhd = kmajor_desc(opaque(qh_s));
  const uint64_t qld = kmajor_desc(opaque(ql_s));
  const uint64_t kd = kmajor_desc(opaque(k_s + 2 * QUART3 * wg));
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::wgmma_ss<64, 0>(part, qhd + 2 * kk, kd + 2 * kk);
    hopper::wgmma_ss<32, 0>(part, qld + 2 * kk, kd + 2 * kk);
  }
  hopper::wgmma_commit();
}

// q's parts (maps[0], maps[1]: 64 x 64 boxes), Kh, Kl, Vh, Vl (maps[2..5]:
// 64 columns x 32 rows), all [B, N, C] bf16 with the 128-byte swizzle.
struct Pass3Maps {
  CUtensorMap m[6];
};

template <int NC>
__global__ void __launch_bounds__(NT3, 1) flash_3pass_kernel(
    const __grid_constant__ Pass3Maps maps,
    const unsigned char* __restrict__ kvalid, float* __restrict__ out,
    int N) {
  typedef Pass3Smem<NC> L;
  constexpr int NB = L::NB, C = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  float* mx = reinterpret_cast<float*>(smem + L::MX);
  float* ls = reinterpret_cast<float*>(smem + L::LS);
  const uint32_t q_full = base_s + L::BAR;

  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ3;
  const int nsteps = (N + BKV3 - 1) / BKV3;
  Pass3Ring<NC> ring;
  ring.base_s = base_s;
  ring.released = reinterpret_cast<int*>(smem + L::CNT);
  ring.b = b;
  ring.nst = nsteps * L::STAGES;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < NS3; ++i) {
      hopper::mbar_init(ring.full(i), 1);
      ring.released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_full, 2 * NC * BOX16);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_3d(base_s + L::QH + c * BOX16, &maps.m[0], q_full,
                          64 * c, q0, b);
      hopper::tma_load_3d(base_s + L::QL + c * BOX16, &maps.m[1], q_full,
                          64 * c, q0, b);
    }
    for (int g = 0; g < NS3 && g < ring.nst; ++g)
      pass3_stage_copy<NC>(g, base_s, maps.m, b);
  }

  // warpgroup wg, its warp wl, the fragment's rows r0, r0 + 8
  const int wg = tid / 128, wl = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * wl + g;
  const int other = (wg ^ 1) * BQ3;
  const int kb = 32 * wg + 2 * t;   // this thread's first key of a step
  // wgmma fragments: s[4 j + 2 i + e] is row r0 + 8 i, key 32 wg + 8 j +
  // 2 t + e of the step; o[4 j + 2 i + e] row r0 + 8 i, column 64 NB wg +
  // 8 j + 2 t + e
  float o[NB * 32];
#pragma unroll
  for (int x = 0; x < NB * 32; ++x) o[x] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  hopper::mbar_wait(q_full, 0);

#pragma unroll 1
  for (int j = 0; j < nsteps; ++j) {
    const int kv0 = j * BKV3;
    const unsigned bytes = mask_bytes(kvalid, kv0, N, lane);
    // S = qh Kh + qh Kl + ql Kh over the K stages: each stage's products
    // into a fresh part, added to s with round-to-nearest; stage c + 1's
    // products run while stage c's part is added
    float s[16], part[2][32];
#pragma unroll
    for (int x = 0; x < 16; ++x) s[x] = 0.0f;
    s_stage(part[0], base_s + L::QH, base_s + L::QL, ring.wait(ring.g), wg);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c + 1 < NC) {
        s_stage(part[(c + 1) % 2], base_s + L::QH + (c + 1) * BOX16,
                base_s + L::QL + (c + 1) * BOX16, ring.wait(ring.g + 1), wg);
        hopper::wgmma_wait<1>();
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_operands<32>(part[c % 2]);
      ring.release(tid, maps.m);
#pragma unroll
      for (int x = 0; x < 16; ++x)
        s[x] += part[c % 2][x] + part[c % 2][16 + x];
    }

    // keys past N or outside key_valid score -inf
    const unsigned live = kvalid == nullptr && kv0 + BKV3 <= N
                              ? 0xFFu : live_bits(bytes, kb);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * jj + 2 * i + e];
          if (!((live >> (2 * jj + e)) & 1u)) x = -INFINITY;
          mt[i] = fmaxf(mt[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    }
    // the row maxima of both halves of the step
    if (t == 0) {
      mx[wg * BQ3 + r0] = mt[0];
      mx[wg * BQ3 + r0 + 8] = mt[1];
    }
    sync16();
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_next = fmaxf(m_run[i],
                                 fmaxf(mt[i], mx[other + r0 + 8 * i]));
      const float ref = softmax_ref(m_next);
      alpha[i] = expf(m_run[i] - ref);
      m_run[i] = m_next;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * jj + 2 * i + e];
          x = expf(x - ref);
          rs += x;
        }
      l_run[i] = l_run[i] * alpha[i] + rs;
    }
    // P split into hi and lo, each K-major with the 128-byte swizzle: row
    // r's 16-byte chunk c at ((c ^ (r % 8)) << 4); r % 8 == g
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bf16 h0, l0, h1, l1;
        split3(s[4 * jj + 2 * i], h0, l0);
        split3(s[4 * jj + 2 * i + 1], h1, l1);
        const int off = (r0 + 8 * i) * 128 + (((4 * wg + jj) ^ g) << 4) +
                        4 * t;
        *reinterpret_cast<__nv_bfloat162*>(smem + L::PH + off) =
            __halves2bfloat162(h0, h1);
        *reinterpret_cast<__nv_bfloat162*>(smem + L::PL + off) =
            __halves2bfloat162(l0, l1);
      }
    hopper::fence_proxy_async();   // P's generic stores, before wgmma reads
    sync16();                      // both halves of P are in place

    // P V = Ph Vh + Ph Vl + Pl Vh, box by box: the step's products for a
    // box into a fresh part (Ph [Vh | Vl] stacked on n: hh in columns
    // 0-63, hl in 64-127; lh added into hh), folded as o = o alpha + part
    // with round-to-nearest
    const uint64_t phd = kmajor_desc(opaque(base_s + L::PH));
    const uint64_t pld = kmajor_desc(opaque(base_s + L::PL));
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
      const uint32_t slot0 = ring.wait(ring.g);
      const uint32_t slot1 = ring.wait(ring.g + 1);
      float part[64];
#pragma unroll
      for (int x = 0; x < 64; ++x) part[x] = 0.0f;
      hopper::fence_operands<64>(part);
      const uint64_t vd0 = v3_desc(opaque(slot0 + 2 * QUART3 * wg));
      const uint64_t vd1 = v3_desc(opaque(slot1 + 2 * QUART3 * wg));
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKV3 / 16; ++ks) {
        const uint64_t vd = (ks < 2 ? vd0 : vd1) + (ks % 2) * (2048 >> 4);
        hopper::wgmma_ss<128, 1>(part, phd + 2 * ks, vd);
        hopper::wgmma_ss<64, 1>(part, pld + 2 * ks, vd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands<64>(part);
      ring.release(tid, maps.m);
      ring.release(tid, maps.m);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float& acc = o[32 * bx + x];
        acc = fmaf(acc, alpha[(x >> 1) & 1], part[x] + part[32 + x]);
      }
    }
  }

  // the row sums: this thread's keys, its quad's, then both warpgroups'
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l_run[i] + __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (t == 0) {
    ls[wg * BQ3 + r0] = l[0];
    ls[wg * BQ3 + r0 + 8] = l[1];
  }
  sync16();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += ls[other + r0 + 8 * i];
    const int row = q0 + r0 + 8 * i;
    if (row >= N) continue;
    float* orow = out + (static_cast<size_t>(b) * N + row) * C +
                  64 * NB * wg;
#pragma unroll
    for (int jj = 0; jj < 8 * NB; ++jj) {
      const int col = 8 * jj + 2 * t;
      if (64 * NB * wg + col < C)
        *reinterpret_cast<float2*>(orow + col) = make_float2(
            o[4 * jj + 2 * i] / l[i], o[4 * jj + 2 * i + 1] / l[i]);
    }
  }
}

// Maps of the parts [6][B, N, C] bf16 (qh, ql, kh, kl, vh, vl), the launch:
// one block a 64-query tile and batch element.
template <int NC>
int launch_3pass(const bf16* parts, const unsigned char* kvalid, float* out,
                 int B, int N, cudaStream_t stream) {
  Pass3Maps maps;
  const size_t n = static_cast<size_t>(B) * N * 64 * NC;
  const uint64_t dims[3] = {uint64_t(64 * NC), uint64_t(N), uint64_t(B)};
  const uint32_t qbox[3] = {64, BQ3, 1}, kvbox[3] = {64, 32, 1};
  for (int i = 0; i < 6; ++i) {
    const int err = hopper::make_map(&maps.m[i], parts + i * n, 3, dims,
                                     i < 2 ? qbox : kvbox,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  const int smem = Pass3Smem<NC>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_3pass_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BQ3 - 1) / BQ3, B);
  flash_3pass_kernel<NC><<<grid, NT3, smem, stream>>>(maps, kvalid, out, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v [B,N,C] bf16, out [B,N,C] f32; C % 64 == 0, C <= 512
// (cudaErrorInvalidValue otherwise); key_valid [N] bytes (0: the key is
// dead) or nullptr.
int hdrvae_flash_attention_bf16(const void* q, const void* k, const void* v,
                                const void* key_valid, void* out, int B,
                                int N, int C, float scale, void* stream) {
  const unsigned char* kv = static_cast<const unsigned char*>(key_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C % 64 == 0 ? C / 64 : 0) {
    case 1: return launch_bf16<1>(q, k, v, kv, o, B, N, scale, s);
    case 2: return launch_bf16<2>(q, k, v, kv, o, B, N, scale, s);
    case 3: return launch_bf16<3>(q, k, v, kv, o, B, N, scale, s);
    case 4: return launch_bf16<4>(q, k, v, kv, o, B, N, scale, s);
    case 5: return launch_bf16<5>(q, k, v, kv, o, B, N, scale, s);
    case 6: return launch_bf16<6>(q, k, v, kv, o, B, N, scale, s);
    case 7: return launch_bf16<7>(q, k, v, kv, o, B, N, scale, s);
    case 8: return launch_bf16<8>(q, k, v, kv, o, B, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v [n] f32 (n % 4 == 0) -> parts [3][2][n] bf16: hi, lo of q *
// scale, of k, of v (_dot3's split, once a launch).
int hdrvae_split_qkv(const void* q, const void* k, const void* v,
                     void* parts, long long n, float scale, void* stream) {
  if (n <= 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n / 4 + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 1056 ? blocks : 1056), 3);
  split_qkv_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<uint2*>(parts), n, scale);
  return static_cast<int>(cudaGetLastError());
}

// parts [6][B,N,C] bf16 (hdrvae_split_qkv's: q's scaled), out [B,N,C]
// f32; C % 64 == 0, C <= 512 (cudaErrorInvalidValue otherwise); key_valid
// [N] bytes or nullptr.
int hdrvae_flash_attention_3pass(const void* parts, const void* key_valid,
                                 void* out, int B, int N, int C,
                                 void* stream) {
  const bf16* p = static_cast<const bf16*>(parts);
  const unsigned char* kv = static_cast<const unsigned char*>(key_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C % 64 == 0 ? C / 64 : 0) {
    case 1: return launch_3pass<1>(p, kv, o, B, N, s);
    case 2: return launch_3pass<2>(p, kv, o, B, N, s);
    case 3: return launch_3pass<3>(p, kv, o, B, N, s);
    case 4: return launch_3pass<4>(p, kv, o, B, N, s);
    case 5: return launch_3pass<5>(p, kv, o, B, N, s);
    case 6: return launch_3pass<6>(p, kv, o, B, N, s);
    case 7: return launch_3pass<7>(p, kv, o, B, N, s);
    case 8: return launch_3pass<8>(p, kv, o, B, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v [B,N,C] f32, out [B,N,C] f32; C % 64 == 0, C <= 512
// (cudaErrorInvalidValue otherwise); key_valid [N] bytes or nullptr.
int hdrvae_flash_attention_f32(const void* q, const void* k, const void* v,
                               const void* key_valid, void* out, int B,
                               int N, int C, float scale, void* stream) {
  const unsigned char* kv = static_cast<const unsigned char*>(key_valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C % 64 == 0 ? C / 64 : 0) {
    case 1: return launch_f32<1>(q, k, v, kv, o, B, N, scale, s);
    case 2: return launch_f32<2>(q, k, v, kv, o, B, N, scale, s);
    case 3: return launch_f32<3>(q, k, v, kv, o, B, N, scale, s);
    case 4: return launch_f32<4>(q, k, v, kv, o, B, N, scale, s);
    case 5: return launch_f32<5>(q, k, v, kv, o, B, N, scale, s);
    case 6: return launch_f32<6>(q, k, v, kv, o, B, N, scale, s);
    case 7: return launch_f32<7>(q, k, v, kv, o, B, N, scale, s);
    case 8: return launch_f32<8>(q, k, v, kv, o, B, N, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
