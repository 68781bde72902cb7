// HAT's overlapping cross-attention core (K8) for Hopper: per (window,
// head) softmax(q k^T + bias) v with nq queries against nk keys, bf16
// products by wgmma with float32 accumulation.
//
// Replaces the TPU kernel K8 of the JAX package:
//   hdrvae/kernels/ocab.py::ocab_attention
// HAT-M (window 16, overlap 0.5): q [nwb, 6, 256, 32], k / v [nwb, 6, 576,
// 32] bf16 (head dim 30 zero-padded to 32, scale folded into q), bias
// [6, 256, 576] float32.
//
// What bounds it on the H100: at HAT-M's 512^2 tile (1024 windows) the q,
// K, V, bias and output bytes take 0.196 ms at 3.35 TB/s and the 116
// GFLOP 0.12 ms at the bf16 tensor-core rate, but each of the 906 M scores
// takes one exponential, and an SM's MUFU retires 16 a clock: 0.234 ms on
// 132 SMs.  The design takes exactly one exponential a score (and one a
// row and key tile for the rescale) and keeps the rest out of the way:
//
//  * Scores stay in registers.  A warpgroup owns 64 queries (a slice) of
//    one (window, head) and walks its keys 64 at a time: S = q K^T by
//    wgmma m64n64k16 (q and K from shared memory, K-major, 64-byte rows
//    with the 64-byte swizzle), an online softmax in float32 on the
//    accumulator fragment, P rounded to bf16 into registers in wgmma's
//    A-operand layout (the fragment's own: no shuffles), and O += P V by
//    wgmma m64n32k16 with A from registers and V MN-major from shared
//    memory.  A tile's S is issued beside the last tile's P V.
//  * The bias stays resident.  A block holds one slice's [64, nk] float32
//    bias (147 KB at nk = 576) in shared memory, times log2(e) and in the
//    fragment's order (a float4 a thread and four scores, consecutive
//    lanes on consecutive 16 bytes: no bank conflicts), and walks a run of
//    windows of one head with it, as the JAX kernel's grid (heads outer)
//    keeps its bias block in VMEM across the window sweep.  Keys past nk
//    hold -inf there, so the last tile masks itself; rows past nq hold 0.
//  * K / V come from device memory once per (window, head): the nq / 64
//    slices of a head are nq / 64 blocks (a group) that walk the same
//    windows in the same order at the same time, so the later reads of
//    each 4 KB K / V tile hit L2 (taking the K / V copies out entirely
//    saves nothing measurable, so a cluster multicasting them would save
//    nothing either).  Groups split the (head, window) jobs, head-major,
//    in contiguous runs; a block reloads its bias where its run crosses
//    into the next head (once at HAT-M's shape).  Persistent: one block
//    an SM.
//  * Latency, not a unit's rate, sets the pace: a tile's chain (S, its
//    wait, the softmax, P V) runs ~1 us, so the block keeps three chains:
//    three consumer warpgroups on alternate windows of the run.  A
//    producer warp for each streams its windows' q through two slots and
//    their K and V tiles (8 KB a tile) through a ring of two (three with
//    two warpgroups), refilling a slot once the warpgroup's four warps
//    have released it, so no consumer waits on a copy's issue.  Fifteen
//    warps cap a thread at 128 registers, which the kernel fits.  Three
//    warpgroups fit up to 576 keys (HAT-M), two with a ring of three up to
//    640.
//
// Numerics: float32 scores (s * log2(e) + bias * log2(e), one fma) and
// softmax with ex2.approx, one exponential per score against the running
// row max; P = exp(s - m_run) rounded to bf16 for its product with V, O
// rescaled in float32 when the max grows and divided by the row sum at the
// end, stored in bf16.  The JAX kernel rounds the normalized exp(s - m) /
// l instead; both roundings are 2^-9 of p and average out over the keys
// (the card's tests hold the two within two bf16 ulps of the largest
// output, peaked inputs included).  A row whose keys are all -inf so far
// takes 0 as its reference max, so exp(-inf - -inf) never makes a NaN.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 32;                 // padded head dim: 64-byte rows
constexpr int BQ = 64;                 // queries a slice: one m64 block
constexpr int BK = 64;                 // keys a tile
constexpr int TILE = BK * HD * 2;      // a q, K or V tile: 4 KB
constexpr int STAGE = 2 * TILE;        // a ring slot: K and V of one tile
constexpr int BIAS_TILE = BQ * BK * 4; // a key tile's float32 bias: 16 KB
constexpr int SMEM_MAX = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// The block of ocab_kernel<NWG>: NWG consumer warpgroups, a producer warp
// for each, RING ring slots a warpgroup, and its shared memory from a
// 1024-byte aligned base: q (two slots a warpgroup), the rings, the bias
// (ntk key tiles), and each warpgroup's mbarriers (a full and an empty
// barrier for each ring slot and q slot).  Three warpgroups fit with two
// slots each up to nine key tiles (576 keys, HAT-M's); two with three
// slots up to ten (640).
template <int NWG>
struct Plan {
  static constexpr int NC = 128 * NWG;          // consumer threads
  static constexpr int NT = NC + 32 * NWG;
  static constexpr int RING = NWG == 2 ? 3 : 2;
  static constexpr int NSLOT = RING + 2;
  static constexpr int RING_OFF = NWG * 2 * TILE;
  static constexpr int BIAS_OFF = RING_OFF + NWG * RING * STAGE;
  __host__ __device__ static constexpr int bar_off(int ntk) {
    return BIAS_OFF + ntk * BIAS_TILE;
  }
  __host__ __device__ static constexpr int smem_bytes(int ntk) {
    return bar_off(ntk) + NWG * 2 * NSLOT * 8 + 1024;   // + the alignment
  }
};
static_assert(Plan<3>::smem_bytes(9) <= SMEM_MAX, "shared memory");
static_assert(Plan<2>::smem_bytes(10) <= SMEM_MAX, "shared memory");

struct Args {
  const float* bias;    // [heads, nq, nk] float32
  bf16* out;            // [nwb, heads, nq, 32]
  int nwb, heads, nq, nk;
  int ntk;              // key tiles: ceil(nk / 64)
  int nsl;              // query slices: ceil(nq / 64), blocks a group
  int groups;           // groups: the grid is groups * nsl blocks
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the consumers' own barrier (the producer warps take no part)
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// wgmma descriptors of a 64-byte-row tile with the 64-byte swizzle: K-major
// (q, K: 8-row groups 512 B apart) and MN-major (V: 8-key groups 512 B
// apart; one 32-column atom, so the leading offset is unused)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return hopper::make_desc(addr, 16, 512, hopper::LAYOUT_B64);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return hopper::make_desc(addr, 16, 512, hopper::LAYOUT_B64);
}

// The job after `job` in a warpgroup's walk (j1 when none): the jobs of a
// head's segment of the run [.., j1) go round the NWG warpgroups from the
// segment's start, wg = 0 taking the first.
template <int NWG>
__device__ __forceinline__ int next_job(int job, int wg, int j1, int nwb) {
  int end = min(j1, (job / nwb + 1) * nwb);
  if (job + NWG < end) return job + NWG;
  for (int s0 = end; s0 < j1; s0 = end) {
    end = min(j1, (s0 / nwb + 1) * nwb);
    if (s0 + wg < end) return s0 + wg;
  }
  return j1;
}

template <int NWG>
__device__ __forceinline__ int first_job(int j0, int wg, int j1, int nwb) {
  for (int s0 = j0, end; s0 < j1; s0 = end) {
    end = min(j1, (s0 / nwb + 1) * nwb);
    if (s0 + wg < end) return s0 + wg;
  }
  return j1;
}

// Slice sl's bias rows of head h into shared memory, times log2(e), as
// float4 [ntk][4 warps][8][32 lanes]: entry (kt, w, j, lane) holds rows 16
// w + g (x, y) and + 8 (z, w), columns 64 kt + 8 j + 2 t (+ 1) of the
// slice, g = lane / 4, t = lane % 4: the S fragment's elements 4 j ..
// 4 j + 3 of that thread.  -inf past nk, 0 past nq.  The column pairs
// land by 8-byte cp.async, all in flight at once, and each consumer thread
// then scales and pads the entries it copied.
template <int NC>
__device__ void load_bias(float4* dst, const Args& a, int h, int sl) {
  const int n = a.ntk * 4 * 8 * 32;
  auto place = [&](int idx, int& row, int& col) {
    const int ln = idx & 31, j = (idx >> 5) & 7, w = (idx >> 8) & 3;
    col = 64 * (idx >> 10) + 8 * j + 2 * (ln & 3);
    row = BQ * sl + 16 * w + (ln >> 2);
  };
  for (int idx = threadIdx.x; idx < n; idx += NC) {
    int row, col;
    place(idx, row, col);
    const uint32_t d = hopper::smem_u32(dst + idx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r < a.nq && col < a.nk) {
        const float* src =
            a.bias + (static_cast<size_t>(h) * a.nq + r) * a.nk + col;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         d + 8 * i),
                     "l"(src)
                     : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  for (int idx = threadIdx.x; idx < n; idx += NC) {
    int row, col;
    place(idx, row, col);
    // keys past nk score -inf; rows past nq are zeros
    const float key_pad = -INFINITY;
    const bool r0 = row < a.nq, r1 = row + 8 < a.nq, in = col < a.nk;
    float4 v = dst[idx];
    v.x = !r0 ? 0.0f : in ? v.x * LOG2E : key_pad;
    v.y = !r0 ? 0.0f : in ? v.y * LOG2E : key_pad;
    v.z = !r1 ? 0.0f : in ? v.z * LOG2E : key_pad;
    v.w = !r1 ? 0.0f : in ? v.w * LOG2E : key_pad;
    dst[idx] = v;
  }
}

template <int NWG>
__global__ void __launch_bounds__(Plan<NWG>::NT, 1)
ocab_kernel(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Args a) {
  typedef Plan<NWG> P;
  constexpr int NC = P::NC, RING = P::RING, NSLOT = P::NSLOT;
  // aligned by an offset from smem_raw, so every access below stays in
  // the shared window
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = hopper::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  float4* bias_s = reinterpret_cast<float4*>(smem + P::BIAS_OFF);

  // warpgroups 0 .. NWG - 1 compute; warp 4 NWG + wg copies for
  // warpgroup wg
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool producer = warp >= 4 * NWG;
  const int wg = producer ? warp - 4 * NWG : warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int sl = blockIdx.x % a.nsl, grp = blockIdx.x / a.nsl;
  const long long jobs = static_cast<long long>(a.heads) * a.nwb;
  const int j0 = static_cast<int>(grp * jobs / a.groups);
  const int j1 = static_cast<int>((grp + 1) * jobs / a.groups);

  // this warpgroup's slots and barriers: slot i's full barrier at bar_s +
  // 8 i, its empty one NSLOT barriers on (ring slots 0 .. RING - 1, q
  // slots RING, RING + 1)
  const uint32_t q_s = base_s + wg * 2 * TILE;
  const uint32_t ring_s = base_s + P::RING_OFF + wg * RING * STAGE;
  const uint32_t bar_s = base_s + P::bar_off(a.ntk) + wg * 2 * NSLOT * 8;
  auto full = [&](int tile) { return bar_s + (tile % RING) * 8; };
  auto qfull = [&](int n) { return bar_s + (RING + (n & 1)) * 8; };
  auto empty = [&](uint32_t full_bar) { return full_bar + NSLOT * 8; };
  auto tensor_index = [&](int job) {    // [nwb, heads] index of a job
    return (job % a.nwb) * a.heads + job / a.nwb;
  };

  if (producer && lane == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      hopper::mbar_init(bar_s + i * 8, 1);
      hopper::mbar_init(empty(bar_s + i * 8), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (producer) {
    // The producer of warpgroup wg: its windows' q (window n into slot n %
    // 2 once window n - 2 has done its S products) and their K / V tiles
    // (tile n into slot n % RING once tile n - RING is released), in its
    // walk's order.
    if (lane == 0) {
      int n = 0, tile = 0;
      for (int job = first_job<NWG>(j0, wg, j1, a.nwb); job < j1;
           job = next_job<NWG>(job, wg, j1, a.nwb), ++n) {
        const int b = tensor_index(job);
        if (n >= 2) hopper::mbar_wait(empty(qfull(n)), ((n >> 1) - 1) & 1);
        hopper::mbar_expect_tx(qfull(n), TILE);
        hopper::tma_load_3d(q_s + (n & 1) * TILE, &qmap, qfull(n), 0,
                            BQ * sl, b);
        for (int kt = 0; kt < a.ntk; ++kt, ++tile) {
          if (tile >= RING)
            hopper::mbar_wait(empty(full(tile)), (tile / RING - 1) & 1);
          const uint32_t dst = ring_s + (tile % RING) * STAGE;
          hopper::mbar_expect_tx(full(tile), STAGE);
          hopper::tma_load_3d(dst, &kmap, full(tile), 0, BK * kt, b);
          hopper::tma_load_3d(dst + TILE, &vmap, full(tile), 0, BK * kt, b);
        }
      }
    }
    return;
  }

  // S fragment: s[4 j + 2 i + e] is row 16 wl + g + 8 i of the slice, key
  // 8 j + 2 t + e of the tile; O's o[4 j + 2 i + e] is column 8 j + 2 t + e
  float s[32], o[16], m_run[2], l_run[2];
  uint32_t p[16];
  int it = 0, wn = 0;   // this warpgroup's K / V tiles and windows so far

  // S = q K^T (q and K tiles at qs, ks), one commit group
  auto s_wgmma = [&](uint32_t qs, uint32_t ks) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    hopper::fence_operands<32>(s);
    const uint64_t qd = kmajor_desc(qs);
    const uint64_t kd = kmajor_desc(ks);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      hopper::wgmma_ss<64, 0>(s, qd + 2 * kk, kd + 2 * kk);
    hopper::wgmma_commit();
  };
  // O += P V (V's tile at vs), one commit group
  auto pv_wgmma = [&](uint32_t vs) {
    hopper::fence_operands<16>(o);
    hopper::fence_operands<16>(p);
    hopper::wgmma_fence();
    const uint64_t vd = mnmajor_desc(vs);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::wgmma_rs_n32<1>(o, p + 4 * ks, vd + ks * (1024 >> 4));
    hopper::wgmma_commit();
  };
  auto release = [&](uint32_t full_bar) {
    if (lane == 0) hopper::mbar_arrive(empty(full_bar));
  };
  // a window starts: its first tile's rescale (alpha = exp(-inf) = 0)
  // clears O
  auto new_window = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[i] = -INFINITY;
      l_run[i] = 0.0f;
    }
  };
  // window job's output: O / l in bf16, rows past nq not stored
  auto store = [&](int job, const float* l_fin) {
    bf16* ob = a.out + static_cast<size_t>(tensor_index(job)) * a.nq * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_fin[i] + __shfl_xor_sync(0xffffffffu, l_fin[i], 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / l;
      const int row = BQ * sl + 16 * wl + g + 8 * i;
      if (row >= a.nq) continue;
      bf16* orow = ob + static_cast<size_t>(row) * HD;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) = pack_bf16(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
  };
  // The online softmax of key tile kt on its scores s: s becomes
  // exp(s + bias - m_run) (one exponential a score, in log2 units), the
  // row sums and maxima move on, alpha is the factor on the old O
  const float4* bw = bias_s + wl * 8 * 32 + lane;
  auto softmax = [&](int kt, float* alpha) {
    const float4* bt = bw + kt * 4 * 8 * 32;
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bb = bt[j * 32];
      s[4 * j] = fmaf(s[4 * j], LOG2E, bb.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], LOG2E, bb.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], LOG2E, bb.z);
      s[4 * j + 3] = fmaf(s[4 * j + 3], LOG2E, bb.w);
      mt[0] = fmaxf(mt[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_next = fmaxf(m_run[i], mt[i]);
      const float ref = m_next == -INFINITY ? 0.0f : m_next;
      alpha[i] = ex2(m_run[i] - ref);
      m_run[i] = m_next;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = ex2(x - ref);
          rs += x;
        }
      l_run[i] = l_run[i] * alpha[i] + rs;
    }
  };

#pragma unroll 1
  for (int seg = j0; seg < j1;) {
    const int h = seg / a.nwb;
    const int seg_end = min(j1, (h + 1) * a.nwb);
    consumers_sync<NC>();   // every warpgroup is done with the last bias
    load_bias<NC>(bias_s, a, h, sl);
    consumers_sync<NC>();

    // this warpgroup's walk of the segment: windows seg + wg, + NWG, ..., key
    // tiles kt of window `job`.  Every tile issues the same wgmmas and
    // waits: its S joins the last tile's P V in flight, both are waited
    // for, and its own P V is left in flight (a P V of zeros before the
    // first tile; a window's output is stored by the tile after its last),
    // so ptxas need not serialize them.
    int job = seg + wg;
    if (job >= seg_end) {
      seg = seg_end;
      continue;
    }
    int kt = 0, ojob = job;   // ojob: the window whose output is pending
    bool pv_pending = false, store_pending = false;
    float l_fin[2];
    new_window();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      o[i] = 0.0f;
      p[i] = 0u;
    }
    hopper::mbar_wait(full(it), (it / RING) & 1);
    pv_wgmma(ring_s + (it % RING) * STAGE + TILE);
#pragma unroll 1
    while (true) {
      const uint32_t kv = ring_s + (it % RING) * STAGE;
      if (kt == 0) hopper::mbar_wait(qfull(wn), (wn >> 1) & 1);
      hopper::mbar_wait(full(it), (it / RING) & 1);
      s_wgmma(q_s + (wn & 1) * TILE, kv);
      hopper::wgmma_wait<0>();
      hopper::fence_operands<32>(s);
      hopper::fence_operands<16>(o);
      hopper::fence_operands<16>(p);
      if (pv_pending) release(full(it - 1));
      pv_pending = true;
      if (store_pending) store(ojob, l_fin);
      store_pending = false;
      const bool last = kt + 1 == a.ntk;
      if (last) release(qfull(wn));   // every S of this window is done
      float alpha[2];
      softmax(kt, alpha);
      // O = alpha O + P V, P in bf16 in wgmma's A layout: for the 16 keys
      // of step ks, p[4 ks + 2 u + i] holds row + 8 i, keys 16 ks + 8 u +
      // 2 t (+ 1)
#pragma unroll
      for (int q = 0; q < 16; ++q) o[q] *= alpha[(q >> 1) & 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p[2 * j + i] = pack_bf16(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
      pv_wgmma(kv + TILE);
      ++it;
      if (last) {
        l_fin[0] = l_run[0];
        l_fin[1] = l_run[1];
        ojob = job;
        store_pending = true;
        new_window();
        ++wn;
        job += NWG;
        kt = 0;
        if (job >= seg_end) break;
      } else {
        ++kt;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands<16>(o);
    hopper::fence_operands<16>(p);
    release(full(it - 1));
    store(ojob, l_fin);
    seg = seg_end;
  }
}

// Launches ocab_kernel<NWG> on maps (q, k, v) and a.
template <int NWG>
int launch(const CUtensorMap* maps, const Args& a, cudaStream_t stream) {
  const int smem = Plan<NWG>::smem_bytes(a.ntk);
  const cudaError_t err = cudaFuncSetAttribute(
      ocab_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ocab_kernel<NWG><<<a.groups * a.nsl, Plan<NWG>::NT, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [nwb, heads, nq, 32], k / v [nwb, heads, nk, 32], out [nwb, heads, nq,
// 32] bf16; bias [heads, nq, nk] float32.  nq and nk must be multiples of
// 16, and the slice's [64, ceil(nk / 64) * 64] float32 bias beside q and
// the rings must fit the block's shared memory: nk <= 640
// (cudaErrorInvalidValue otherwise).  Three warpgroups a block where the
// bias leaves room for them (nk <= 576), two otherwise.
int hdrvae_ocab_attention(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int nwb, int heads,
                          int nq, int nk, void* stream) {
  if (nq < 16 || nq % 16 || nk < 16 || nk % 16 || nwb < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.nwb = nwb;
  a.heads = heads;
  a.nq = nq;
  a.nk = nk;
  a.ntk = (nk + BK - 1) / BK;
  a.nsl = (nq + BQ - 1) / BQ;
  if (Plan<2>::smem_bytes(a.ntk) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = static_cast<long long>(nwb) * heads;
  a.groups = static_cast<int>(
      std::max(1LL, std::min<long long>(sms / a.nsl, jobs)));

  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const uint32_t box[3] = {HD, BK, 1};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[3] = {HD, uint64_t(i == 0 ? nq : nk),
                              uint64_t(jobs)};
    const int e = hopper::make_map(&maps[i], ptrs[i], 3, dims, box,
                                   CU_TENSOR_MAP_SWIZZLE_64B);
    if (e != 0) return e;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Plan<3>::smem_bytes(a.ntk) <= SMEM_MAX) return launch<3>(maps, a, st);
  return launch<2>(maps, a, st);
}

}  // extern "C"
