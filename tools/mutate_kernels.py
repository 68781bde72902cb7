#!/usr/bin/env python3
"""Mutation check of a kernel's test in ``chip_smoke.py``, on one NVIDIA
GPU.

    python3 tools/mutate_kernels.py [k1|k2|k1_owned|k2_owned|k6|k5|chain|
                                     k3_f32|k3_3pass|k3_bf16|k8|k7|k4|k9
                                     ...]
                                    (default: all)

For each mutation of a target below it copies ``hdrvae_torch/`` and
``chip_smoke.py`` into a temporary directory, breaks one CUDA source
there (one or more edits), builds that copy's kernels and runs the
target's check of ``chip_smoke`` (k1: ``_check_k1``, K1 against its
plain version at the 1024^2 decode's six conv shapes and a ragged one;
k2: ``_check_k2``, K2 at the decode's three upsample convs and a ragged
one; k1_owned / k2_owned: ``_check_owned``, K1 / K2 with owned_rows at
the same shapes over three intervals cut at odd rows (y bit-equal to the
unrestricted launch's, each interval's sums against the plain version's,
the three adding up to the whole; built from conv3x3.cu alone); k6: ``_check_k6``, K6 at one 512^2 tile's shapes of the ESRGAN x4 net
and more (a ragged conv5, conv_body, conv_first of unshuffle 2 and 4);
k5: ``_check_k5``, K5 against its plain version at the 2048^2 decode's
junction and a ragged map (built from upconv.cu and conv3x3.cu alone);
chain:
``_check_chain(with_k7=False)``, K10, K9 and K11 of the staged Swin chain
within SWIN_BUDGET of their plain versions at K7's v1 shapes and on
CHAIN_RAGGED's windows, each output in a block that held NaNs, padded
rows zero (built from swin_chain.cu alone); k3_f32: ``_check_k3_f32``,
K3's exact
float32 mode within 1e-5 of its plain version at N = 16,384, C = 512, on
the ragged, peaked input and at batch 2 and C = 64 (each also into a
buffer whose tail past the last row must stay untouched), and in its two
key_valid records; k3_3pass: ``_check_k3_3pass``, K3's
3-pass mode's split bit-equal to its plain version, the mode against
exact float32 and its plain version at N = 16,384, C = 512, against its
plain version on a ragged input with peaked scores, in its two key_valid
records and at N = 65,536 (built from attention.cu alone); k3_bf16:
``_check_k3_bf16``, K3's bf16 mode within one bf16 ulp of the exact
plain version at N = 16,384, C = 512, on the same ragged,
peaked input, at batch 2 and C = 64, and in its two key_valid records;
k8: ``_check_k8``, K8 within two bf16 ulps of its plain version at
HAT-M's OCAB shape, with a peaked bias and at a ragged 20 x 36 shape, and
through its C entry into a NaN-filled buffer; k7: ``_check_k7``, K7's v1
body within two bf16 ulps of its plain version at ``K7_SHAPES`` and its
v2 body within its budget at ``K7_V2_SHAPES``, each output in a block
that held NaNs, built for C <= 192 alone; k4: ``_check_k4``, K4's
collapse bit-exact, min / max exact and mean / std within K4_BUDGET at
K4_SHAPE and on K4_EXTRA's maps, built from epilogue.cu alone; k9:
``_check_chain(with_k7=False)``, K9 within SWIN_BUDGET of its plain
version at K7_SHAPES and on CHAIN_RAGGED's ragged windows, padded rows
zero, built from swin_chain.cu alone),
then reports whether the check refused the broken kernel: by a
failed assertion, or by a fault of the broken kernel on the card (a
mutant that writes past an output stops the check there).  The
checkout itself is never changed.  Exits non-zero if a mutant the check
must catch survives; one marked ``sub-ulp`` moves each value by less than
one bf16 ulp, below what the 5e-2 budgets can see, and is reported only,
as is k3_3pass's "P v in place across steps" (what the fresh parts buy).

    python3 tools/mutate_kernels.py --time-k6 [as-is|no-stores|...]
                                    (default: all; a name may repeat)

times what each part of K6 (``dense_conv.cu``) costs instead: each variant
takes one part out of the kernel in such a copy (its results are then
wrong: these are timings only) and times K6 at ``chip_smoke.py``'s phase-3
shapes and conv_body, each as the device time of the kernel alone
(``torch.profiler``, mean of 10 launches after 3 warm-ups) and the
wrapper's time (CUDA events, mean of 10), with the weights prepared
beforehand as the ESRGAN chain passes them:

- as-is: the kernel as it is;
- no-stores: the epilogue computes (into the staged output tile where it
  takes one) but stores nothing;
- no-slab-loads: the producer issues no TMA slab copies (the weights still
  stream; the gathers of conv_first still run);
- no-weight-loads: the producer issues no weight copies (the slabs still
  load): what the weights' stream through the ring costs, the most that
  weights kept resident in shared memory could save;
- no-wgmma: the consumers issue no wgmma (the feed and the epilogue run).

    python3 tools/mutate_kernels.py --time-k3 [as-is|no-loads|...]

does the same for K3's bf16 kernel (``attention.cu``), timed by CUDA
events (mean of 10 launches after 2 warm-ups, twice) at ``chip_smoke.py``'s
N = 16,384, C = 512, unmasked and with phase 3's key_valid mask:

- as-is: the kernel as it is;
- no-loads: no TMA copies of q, K or V (their barriers still complete);
- no-k-loads, no-v-loads: no copies of K, or of V;
- no-s-wgmma, no-pv-wgmma, no-wgmma: no S = q K^T wgmmas, no P V ones,
  neither (the feed, the softmax and the barriers run);
- fast-exp: ``__expf`` (the bare ex2 path) for ``expf`` in the softmax;
- skip-rescale: the output's rescale skipped where every alpha of the
  warp is 1.

    python3 tools/mutate_kernels.py --time-k3-f32 [as-is|no-loads|...]

does the same for K3's exact float32 kernel (CUDA events, mean of 5
launches after 2 warm-ups, twice, unmasked and masked at N = 16,384, C =
512):

- as-is: the kernel as it is;
- no-loads, no-k-loads, no-v-loads: no TMA copies of K and V, of K, or of
  V (their barriers still complete; q still loads);
- no-s-ffma, no-pv-ffma: no S = q K^T FFMAs, or no P V ones (the shared
  loads that fed them go with them; the ring, the softmax and the
  barriers run);
- refill-lag-1, refill-lag-2: thread 0 refills the slot of the stage
  before the one its warp has just released, or of the one two before,
  instead of that one (each once every warp has released it).

    python3 tools/mutate_kernels.py --time-k3-3pass [--tree DIR] [as-is|...]

does the same for K3's 3-pass kernel and its split (``attention.cu``,
built alone; CUDA events, mean of 5 launches after 2 warm-ups, twice,
unmasked and masked at N = 16,384, C = 512), in the tree at DIR (default:
this one; by default the variants its sources hold):

- as-is: the kernel as it is;
- no-loads: no TMA copies of K and V (their barriers still complete; q
  still loads);
- no-s-wgmma, no-pv-wgmma, no-wgmma: no S wgmmas, no P V ones, neither;
- no-presplit: the wrapper launches no split (the parts uninitialized);
- for the earlier mma.sync kernel, which split K and V from float32 in
  every block: as-is; no-loads (K and V neither read nor split);
  no-s-products, no-pv-products (their mma.sync taken out);
  barriers-only (all three).

    python3 tools/mutate_kernels.py --time-k8 [as-is|no-kv-loads|...]

does the same for K8 (``ocab.cu``; CUDA events, mean of 10 launches after
2 warm-ups, twice, at ``chip_smoke.py``'s K8_SHAPE):

- as-is: the kernel as it is;
- no-kv-loads: no TMA copies of K and V (their barriers still complete;
  q and the bias still load): what the K / V feed holds back;
- no-bias-fill: the bias is not copied from device memory at each head's
  start (what the resident bias's fill costs);
- no-bias-loads: the softmax reads no bias from shared memory (zeros);
- no-exp: no exponentials (the scores' scaled differences stand in);
- no-softmax: no softmax at all (P is S rounded, alpha 1): what the rest
  of a tile's work costs;
- no-s-wgmma, no-pv-wgmma: no S = q K^T wgmmas, or no P V ones;
- no-stores: the outputs are not stored;
- two-warpgroups: the kernel with two consumer warpgroups a block (and
  three ring slots each), as for more than 576 keys, instead of three.

    python3 tools/mutate_kernels.py --time-k5 [--tree DIR] [as-is|...]

does the same for K5 (``upconv.cu``, built with conv3x3.cu alone; the
kernel's device time from ``torch.profiler``, mean of 5 launches after 2
warm-ups, and the wrapper's by CUDA events, twice, at ``chip_smoke.py``'s
K5_SHAPES and summed), in the tree at DIR (default: this one; an older
tree times PR 5's mma.sync kernel, where the variant exists for it):

- as-is: the kernel as it is;
- no-weight-loads: the weight stages are not copied (their barriers
  still complete; the slab still loads);
- no-upconv-products, no-conv1-products: no up-conv products, or no
  conv1 products (the feed and the epilogues run);
- no-band-epilogue: the band is not written (no up_bias, GroupNorm
  affine, SiLU or stores);
- no-y-stores: y is not stored (its statistics still run).

    python3 tools/mutate_kernels.py --time-k7 [--tree DIR] [as-is|...]

does the same for K7's v1 body (``swin_block.cu``; CUDA events, mean of
10 launches after 2 warm-ups, twice, at each of ``chip_smoke.py``'s
K7_SHAPES and over all four), in the tree at DIR (default: this one; an
older tree times the earlier mma.sync / WMMA kernel, where the variant
exists for it):

- as-is: the kernel as it is;
- no-weight-loads: the weight tiles are not copied (their barriers still
  complete);
- no-attention: no S, softmax or P V;
- no-qkv-scratch: q, k and v neither stored to nor read from device
  memory (windows past 64 tokens; the earlier kernel: every window);
- no-bias-reads: the position bias is not read;
- no-ln-gelu: no LN1 statistics and no GELU (the earlier kernel: no LN
  statistics at all);
- no-x-loads: the input image is not read (LN1's rows and the residual);
- no-stores: the output is not stored;
- reciprocal: P as e times 1 / l, as before the kernel divided (it
  computes p = e / l correctly rounded: e rl plus one FMA correction);
- divide: the same quotient by ``__fdiv_rn``, with its range check;
- one-warpgroup: one row block in flight a block instead of two.

    python3 tools/mutate_kernels.py --time-k4 [--tree DIR] [as-is|...]

times K4 (``epilogue.cu``, built alone; the wrapper by CUDA events, mean
of 10 launches after 2 warm-ups, twice, at ``chip_smoke.py``'s K4_SHAPE in
float32 and bf16), in the tree at DIR (default: this one; an older tree
times PR 2's kernel, a warp a row with a Welford step a value):

- as-is: the kernel as it is;
- no-loads: every lane reads the map's first row (cached) instead of its
  own (the earlier kernel: its first 8 values);
- no-stores: the collapsed rows are not stored;
- no-products: no per-element statistics or group maxes (K4 has no
  matrix products; its per-element arithmetic stands in for them).

    python3 tools/mutate_kernels.py --time-k9 [--tree DIR] [as-is|...]

does the same for K9 (``swin_chain.cu``, built alone; CUDA events, mean of
10 launches after 2 warm-ups, twice, at ``chip_smoke.py``'s K7_SHAPES on
K10's qkv; an older tree times PR 6's WMMA kernel):

- as-is: the kernel as it is;
- no-loads: no TMA copies of q, K and V (their barriers still complete;
  the earlier kernel: no cp.async copies);
- no-stores: the output is not stored;
- no-products: no S or P V wgmma (the softmax runs, P kept alive by an
  opaque use);
- reciprocal: P as e times 1 / l instead of the correctly rounded divide.

    python3 tools/mutate_kernels.py --time-k10 [--tree DIR] [as-is|...]
    python3 tools/mutate_kernels.py --time-k11 [--tree DIR] [as-is|...]

do the same for K10 and K11 (``swin_chain.cu``, built alone; CUDA events,
mean of 10 launches after 2 warm-ups, twice, at ``chip_smoke.py``'s
K7_SHAPES, K11 on K9's output of K10's qkv).  Each run times both kernels
(and K9, the control); the flag picks the variants, made in the kernel it
names (an older tree's earlier mma.sync kernels: as-is only):

- as-is: the kernels as they are;
- no-stores: K10's qkv, or K11's output, not stored;
- no-products: K10's qkv products, or K11's proj, fc1 and fc2 products,
  not issued (their groups still committed and waited for);
- no-weight-loads: the weight tiles not copied (the ring's barriers still
  complete; the slots keep stale bytes);
- no-x-loads: K10's LN1 rows, or K11's residual rows of x, not read (a
  constant);
- no-gelu (K11): fc1 + b1 passed on without the GELU;
- one-warpgroup (K11): one warpgroup a block instead of two.

    python3 tools/mutate_kernels.py --time-k12 [--tree DIR] [as-is|...]

times K12 (``f32_dot.cu``, built alone) through the probe's measurement
(``tools/f32_dot_probe_torch.py`` at 8192 x 256 x 256: CUDA events over
100 launches queued behind a sleeping kernel, operands rotating over four
copies): each mode's call, and for high and default the split alone and
the tensor-core kernel alone, in the tree at DIR (default: this one):

- as-is: the kernels as they are;
- no-x-loads, no-w-loads, no-loads: the tensor-core kernel copies no x
  chunks, no w part tiles, or neither (their barriers still complete; the
  slots keep stale bytes);
- no-split: the tensor-core kernel's threads do not split x (its atoms
  keep stale bytes; the waits remain);
- no-products: no wgmma issued (the groups are still committed and
  waited for);
- no-stores: y is staged in shared memory but not stored;
- no-pdl: the tensor-core kernel launched as a plain launch after the
  split, not beside it;
- ffma-tn16: highest with 8 x 16 outputs a thread (128 threads): 96
  shared wavefronts a k an SM against 128 FFMA cycles, not 128;
- ffma-bk16: highest on 16-deep slices through four stages;
- ffma-eighth: highest with an eighth of its FFMAs (every shared load
  still feeds one): what the loads, barriers and copies cost;
- ffma-no-loads: highest with no cp.async copies (its FFMAs on stale
  slices).

It prints the card's name and power limit first.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# target: (chip_smoke call, log prefixes, mutations); each mutation name:
# (CUDA source under csrc/, text of it, its broken form, must the check
# catch it); text and broken form may be tuples of edits made together
# K1 / K2's wgmma of one m64 block and tap
K1_WGMMA = "            wgmma_ss<BN, 1>(acc[mb], da, b_desc(st + ks * 2048));\n"

# K7 built for C <= 192 alone (the checks' and timings' width): one
# instance a body instead of three
K7_ONLY_C192 = (
    "    case 1: return launch<V2, 1>(maps, a, smem, grid, s);\n"
    "    case 3: return launch<V2, 3>(maps, a, smem, grid, s);\n"
    "    default: return launch<V2, 4>(maps, a, smem, grid, s);",
    "    default: return launch<V2, 3>(maps, a, smem, grid, s);")


# K1 / K2's owned-row test of an accumulator row, and its mutants
OWNED_TEST = "oh >= a.own_lo && oh < a.own_hi"
OWNED_MUTANTS = {
    "lo off by one (row lo not counted)": (
        "conv3x3.cu", OWNED_TEST, "oh > a.own_lo && oh < a.own_hi", True),
    "hi off by one (row hi counted)": (
        "conv3x3.cu", OWNED_TEST, "oh >= a.own_lo && oh <= a.own_hi", True),
}


def _k7(text: str, broken: str, must_catch: bool = True):
    """A K7 mutation (swin_block.cu), built for C <= 192 alone."""
    return ("swin_block.cu", (text, K7_ONLY_C192[0]),
            (broken, K7_ONLY_C192[1]), must_catch)


TARGETS = {
    # K1 and K2 share conv3x3.cu's mainloop: each mutant keeps the producer
    # and consumer schedules in step (a broken schedule would trap, not
    # compute a wrong y)
    "k1": ("_check_k1(np.random.default_rng(0))", ("K1",), {
        "one tap skipped": (
            "conv3x3.cu", K1_WGMMA,
            "            if (!(tap == 4 && !proj))\n" + K1_WGMMA, True),
        "last K chunk skipped": (
            "conv3x3.cu", K1_WGMMA,
            "            if (ci != nmain - 1)\n" + K1_WGMMA, True),
        "prologue on halo pixels outside the image": (
            "conv3x3.cu",
            "if (c >= a.Cin || hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) "
            "continue;", "if (c >= a.Cin) continue;", True),
        "identity residual dropped": (
            "conv3x3.cu", "                v0 += __low2float(rr[mb][i][j]);\n"
            "                v1 += __high2float(rr[mb][i][j]);\n", "", True),
        "last nin_shortcut chunk skipped": (
            "conv3x3.cu", "? (a.Cr + BK - 1) / BK : 0;",
            "? (a.Cr + BK - 1) / BK - 1 : 0;", True),
        "statistics before the bf16 rounding (sub-ulp)": (
            "conv3x3.cu", "              v0 = __low2float(yb);   // statistics "
            "of y as stored\n              v1 = __high2float(yb);\n", "",
            False),
    }),
    "k2": ("_check_k2(np.random.default_rng(0))", ("K2",), {
        "phase 3 with phase 2's weights": (
            "conv3x3.cu", "(MODE == MODE_UP) ? wk.ph * 4 + tap : tap;",
            "(MODE == MODE_UP) ? (wk.ph == 3 ? 2 : wk.ph) * 4 + tap : tap;",
            True),
        "one tap skipped": (
            "conv3x3.cu", K1_WGMMA, "            if (tap != 3)\n" + K1_WGMMA,
            True),
    }),
    # K1 / K2 owned_rows: the statistics' row test (y is left alone);
    # built from conv3x3.cu alone
    "k1_owned": ('_check_owned(np.random.default_rng(9), "K1")', ("K1",),
                 OWNED_MUTANTS),
    "k2_owned": ('_check_owned(np.random.default_rng(9), "K2")', ("K2",), {
        **OWNED_MUTANTS,
        "K2's phase row 2 i + a taken as 2 i": (
            "conv3x3.cu", OWNED_TEST,
            "oh - pa >= a.own_lo && oh - pa < a.own_hi", True),
    }),
    # K6: the mainloop's chunk count and the tap loop are shared by the
    # producer and the consumers, so the schedules stay in step
    "k6": ("_check_k6(np.random.default_rng(0))", ("K6",), {
        "one tap skipped": (
            "dense_conv.cu", "          wgmma_ss<NP, 0>(acc[mb],\n",
            "          if (tap != 4) wgmma_ss<NP, 0>(acc[mb],\n", True),
        "the last input's last chunk dropped": (
            "dense_conv.cu", "const int nchunks = a.nchunks;",
            "const int nchunks = a.nchunks - 1;", True),
        "LeakyReLU slope 0 (ReLU)": (
            "dense_conv.cu", "__fmul_rn(0.2f, v)", "__fmul_rn(0.0f, v)", True),
        "res_scale dropped": (
            "dense_conv.cu",
            "return __fadd_rn(r, __fmul_rn(a.res_scale, v));",
            "return __fadd_rn(r, v);", True),
        "conv_last's column mask dropped": (
            "dense_conv.cu", "              if (n + e < a.Cout) {",
            "              if (true) {", True),
    }),
    # K5: every mutant keeps the producer's and the consumers' schedules in
    # step; built from K5_SOURCES alone
    "k5": ("_check_k5(np.random.default_rng(5))", ("K5",), {
        "band not zeroed outside the image": (
            "upconv.cu", "  if (!in) return __floats2bfloat162_rn(0.0f, 0.0f);",
            "  if (false) return __floats2bfloat162_rn(0.0f, 0.0f);", True),
        "up_bias dropped": (
            "upconv.cu",
            "up[4 * j + 2 * i] + u2.x, up[4 * j + 2 * i + 1] + u2.y",
            "up[4 * j + 2 * i], up[4 * j + 2 * i + 1]", True),
        "one Cm chunk's band skipped": (
            "upconv.cu",
            "        if (ri >= PH_ROWS || ci >= PH_COLS) continue;",
            "        if (ri >= PH_ROWS || ci >= PH_COLS || c == 1) continue;",
            True),
        "last conv1 tap skipped": (
            "upconv.cu", "            wgmma_ss<CO, 1>(\n",
            "            if (tap != 8) wgmma_ss<CO, 1>(\n", True),
        "last Cm chunk's conv1 skipped": (
            "upconv.cu", "            wgmma_ss<CO, 1>(\n",
            "            if (c != nchunks - 1) wgmma_ss<CO, 1>(\n", True),
        "one phase's tap skipped": (
            "upconv.cu", "              wgmma_ss<64, 1>(up, a_desc(",
            "              if (!(p == 3 && (i & 1) && v == 1))\n"
            "                wgmma_ss<64, 1>(up, a_desc(", True),
        "ragged-edge store mask dropped": (
            "upconv.cu", "        ok[mb][i] = oh < H2 && ow < W2;",
            "        ok[mb][i] = true;", True),
        "z not rounded to bf16 (sub-ulp)": (
            "upconv.cu",
            "const float2 z = __bfloat1622float2(__floats2bfloat162_rn(\n"
            "                up[4 * j + 2 * i] + u2.x, up[4 * j + 2 * i + 1] + u2.y));",
            "const float2 z = make_float2(\n"
            "                up[4 * j + 2 * i] + u2.x, up[4 * j + 2 * i + 1] + u2.y);",
            False),
    }),
    # K10's and K11's (K9's are the k9 target's), built from swin_chain.cu
    # alone: the chain's kernels against their plain versions at K7_SHAPES
    # and on CHAIN_RAGGED's windows, each output in a block that held NaNs
    # (the chain against K7 left out)
    "chain": ("_check_chain(np.random.default_rng(6), with_k7=False)",
              ("swin_",), {
        "K10: LN1 skipped": (
            "swin_chain.cu",
            ("? (v[k].x - mean) * rstd * g_s[c] + be_s[c]",
             "? (v[k].y - mean) * rstd * g_s[c + 1] +\n"
             "                                   be_s[c + 1]"),
            ("? v[k].x", "? v[k].y"), True),
        "K10: qkv bias dropped": (
            "swin_chain.cu",
            "                  live ? f[16 * s + 4 * jj + 2 * i + e] +\n"
            "                             bqh[s * HDP + 8 * jj + 2 * t + e]\n",
            "                  live ? f[16 * s + 4 * jj + 2 * i + e]\n", True),
        "K10: a Wqkv tile of the ring skipped (head 2)": (
            "swin_chain.cu",
            "        hopper::wgmma_ss<96, 1>(f, dA + a_step(ks), db + ks * 64);",
            "        if (h != 2) hopper::wgmma_ss<96, 1>(f, dA + a_step(ks), db + ks * 64);",
            True),
        "K10: pad rows not zeroed": (
            "swin_chain.cu",
            "            const bool live = tok0 + 16 * wl + g + 8 * i < n;",
            "            const bool live = true;", True),
        "K11: extra dropped": (
            "swin_chain.cu",
            ("          v0 += ev.x;\n", "          v1 += ev.y;\n"), ("", ""),
            True),
        "K11: fc2 bias dropped": (
            "swin_chain.cu",
            ("      return make_float2(acc[k >> 3][4 * (k & 7) + 2 * i] + bv.x,\n"
             "                         acc[k >> 3][4 * (k & 7) + 2 * i + 1] + bv.y);"),
            ("      return make_float2(acc[k >> 3][4 * (k & 7) + 2 * i],\n"
             "                         acc[k >> 3][4 * (k & 7) + 2 * i + 1]);"),
            True),
        "K11: an fc1 tile of the ring skipped (chunk 2)": (
            "swin_chain.cu",
            "        hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);",
            "        if (c != 2) hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);",
            True),
        "K11: the last row block of a ws-16 window not stored": (
            "swin_chain.cu",
            "      if (real) {\n        // a window row's pixels",
            "      if (real && (a.nrb < 4 || rb % a.nrb != a.nrb - 1)) {\n"
            "        // a window row's pixels", True),
    }),
    # K4, built from epilogue.cu alone: its check holds the collapse
    # bit-exact, min / max exact and mean / std within K4_BUDGET at
    # K4_SHAPE and on K4_EXTRA's ragged, offset, ramp and narrow maps
    "k4": ("_check_k4()", ("K4",), {
        "group bound off by one": (
            "epilogue.cu",
            ("    keep[0][e] = c < b1 ? ~0u : 0u;",
             "    keep[1][e] = c >= b1 && c < b2 ? ~0u : 0u;"),
            ("    keep[0][e] = c <= b1 ? ~0u : 0u;",
             "    keep[1][e] = c > b1 && c < b2 ? ~0u : 0u;"), True),
        "last partial dropped": (
            "epilogue.cu",
            "  for (int i = threadIdx.x; i < nblocks; i += NTHREADS) {",
            "  for (int i = threadIdx.x; i < nblocks - 1; i += NTHREADS) {",
            True),
        "ragged last chunk unmasked": (
            "epilogue.cu",
            "      return rl + tpr * sl < vpr && row < M;",
            "      return rl + tpr * sl < vpr;", True),
        "M2 merged without the delta term": (
            "epilogue.cu", "    a.m2 = a.m2 + b.m2 + d * d * a.n * f;",
            "    a.m2 = a.m2 + b.m2;", True),
    }),
    # K9, built from swin_chain.cu alone: its check holds it to its plain
    # version at K7_SHAPES and on CHAIN_RAGGED's ragged windows (the chain
    # against K7 left out)
    "k9": ("_check_chain(np.random.default_rng(6), with_k7=False)",
           ("swin_attn_core",), {
        "a k-step of S skipped": (
            "swin_chain.cu",
            "          hopper::wgmma_ss<64, 0>(s[kt], dq + 2 * kk,",
            "          if (kk == 0) hopper::wgmma_ss<64, 0>(s[kt], dq + 2 * kk,",
            True),
        "position bias dropped": (
            "swin_chain.cu",
            "            bb[kt][b] = RESIDENT ? brow[key]\n"
            "                                 : (key < n ? __ldg(brow + key) : 0.0f);",
            "            bb[kt][b] = 0.0f;", True),
        "bias head off by one": (
            "swin_chain.cu",
            "a.bias + static_cast<size_t>(h) * n * n;",
            "a.bias + static_cast<size_t>((h + 1) % a.heads) * n * n;", True),
        "last-row mask dropped": (
            "swin_chain.cu", "              if ((xr >> b) & 1u) bb[kt][b] += -100.0f;\n",
            "", True),
        "last-column mask dropped": (
            "swin_chain.cu", "              if ((xc >> b) & 1u) v += -100.0f;\n",
            "", True),
        "band masks in the first window row": (
            "swin_chain.cu", "const bool lr = a.shift > 0 && wr == a.nwh - 1;",
            "const bool lr = a.shift > 0 && wr == 0;", True),
        "band masks in the first window column": (
            "swin_chain.cu", "const bool lc = a.shift > 0 && wc == a.nww - 1;",
            "const bool lc = a.shift > 0 && wc == 0;", True),
        "last 16 keys dropped": (
            "swin_chain.cu",
            "kdead[kt] |= static_cast<uint32_t>(key >= n) << (2 * j + e);",
            "kdead[kt] |= static_cast<uint32_t>(key >= n - 16) << (2 * j + e);",
            True),
        "normalization dropped": (
            "swin_chain.cu",
            ("pack_bf16(div(s[kt][4 * j + 2 * r]),",
             "div(s[kt][4 * j + 2 * r + 1]))"),
            ("pack_bf16(s[kt][4 * j + 2 * r],",
             "s[kt][4 * j + 2 * r + 1])"), True),
        "padded rows not zeroed": (
            "swin_chain.cu", "        const bool live = row < n;",
            "        const bool live = true;", True),
    }),
    # K3's 3-pass kernel: qh [Kh ; Kl] is one wgmma (hh, hl), ql Kh another
    # (lh); Ph [Vh | Vl] likewise (hh, hl), Pl Vh another (lh).  Built from
    # attention.cu alone.
    "k3_3pass": ("_check_k3_3pass(*chip_smoke._k3_inputs("
                 "np.random.default_rng(0)))", ("K3", "split_qkv"), {
        "S: hi.hi dropped": (
            "attention.cu",
            "    hopper::wgmma_ss<64, 0>(part, qhd + 2 * kk, kd + 2 * kk);",
            "    hopper::wgmma_ss<32, 0>(part + 16, qhd + 2 * kk,\n"
            "                            kd + 2 * kk + (QUART3 >> 4));",
            True),
        "S: hi.lo dropped": (
            "attention.cu",
            "    hopper::wgmma_ss<64, 0>(part, qhd + 2 * kk, kd + 2 * kk);",
            "    hopper::wgmma_ss<32, 0>(part, qhd + 2 * kk, kd + 2 * kk);",
            True),
        "S: lo.hi dropped": (
            "attention.cu",
            "    hopper::wgmma_ss<32, 0>(part, qld + 2 * kk, kd + 2 * kk);\n",
            "", True),
        "P v: hi.hi dropped": (
            "attention.cu",
            "        hopper::wgmma_ss<128, 1>(part, phd + 2 * ks, vd);",
            "        hopper::wgmma_ss<64, 1>(part + 32, phd + 2 * ks,\n"
            "                                vd + (QUART3 >> 4));", True),
        "P v: hi.lo dropped": (
            "attention.cu",
            "        hopper::wgmma_ss<128, 1>(part, phd + 2 * ks, vd);",
            "        hopper::wgmma_ss<64, 1>(part, phd + 2 * ks, vd);", True),
        "P v: lo.hi dropped": (
            "attention.cu",
            "        hopper::wgmma_ss<64, 1>(part, pld + 2 * ks, vd);\n", "",
            True),
        # q split unscaled, the scores scaled after the three passes
        "split before the scale": (
            "attention.cu",
            ("  const float s = w == 0 ? scale : 1.0f;",
             "        s[x] += part[c % 2][x] + part[c % 2][16 + x];"),
            ("  const float s = 1.0f;",
             "        s[x] += (part[c % 2][x] + part[c % 2][16 + x]) *\n"
             "                rsqrtf(64.0f * NC);"),
            True),
        # the split's lo parts rounded toward zero: below what the
        # attention's bars see; the split's bit-equality refuses it
        "split: lo rounded toward zero": (
            "attention.cu",
            "    for (int e = 0; e < 4; ++e) split3(xs[e], h[e], l[e]);",
            "    for (int e = 0; e < 4; ++e) {\n"
            "      h[e] = __float2bfloat16(xs[e]);\n"
            "      l[e] = __float2bfloat16_rz(xs[e] - __bfloat162float(h[e]));\n"
            "    }", True),
        "last key step dropped": (
            "attention.cu", "const int nsteps = (N + BKV3 - 1) / BKV3;",
            "const int nsteps = (N + BKV3 - 1) / BKV3 - 1;", True),
        # P V accumulated in place across the key steps (o = o alpha, then
        # the three products into o): what the fresh parts buy; reported
        "P v in place across steps": (
            "attention.cu",
            ("      hopper::fence_operands<64>(part);\n"
             "      const uint64_t vd0",
             "        hopper::wgmma_ss<128, 1>(part, phd + 2 * ks, vd);\n"
             "        hopper::wgmma_ss<64, 1>(part, pld + 2 * ks, vd);",
             "      hopper::fence_operands<64>(part);\n"
             "      ring.release(tid, maps.m);",
             "        acc = fmaf(acc, alpha[(x >> 1) & 1], part[x] + part[32 + x]);"),
            ("#pragma unroll\n"
             "      for (int x = 0; x < 32; ++x) o[32 * bx + x] *= alpha[(x >> 1) & 1];\n"
             "      hopper::fence_operands<32>(o + 32 * bx);\n"
             "      const uint64_t vd0",
             "        hopper::wgmma_ss<64, 1>(o + 32 * bx, phd + 2 * ks, vd);\n"
             "        hopper::wgmma_ss<64, 1>(o + 32 * bx, phd + 2 * ks,\n"
             "                                vd + (QUART3 >> 4));\n"
             "        hopper::wgmma_ss<64, 1>(o + 32 * bx, pld + 2 * ks, vd);",
             "      hopper::fence_operands<32>(o + 32 * bx);\n"
             "      ring.release(tid, maps.m);",
             "        (void)acc;"), False),
    }),
    # K3's exact float32 kernel: every mutant keeps the producer's and the
    # consumers' schedules in step
    "k3_f32": ("_check_k3_f32(*chip_smoke._k3_inputs("
               "np.random.default_rng(0)))", ("K3",), {
        "one K stage's last 4 channels skipped": (
            "attention.cu",
            "      for (int c4 = 0; c4 < KC32 / 4; ++c4) {",
            "      for (int c4 = 0; c4 < KC32 / 4 - (kc == 3); ++c4) {", True),
        "alpha rescale dropped": (
            "attention.cu", "for (int m = 0; m < 2 * NC; ++m) o[r][m] *= alpha;",
            "for (int m = 0; m < 2 * NC; ++m) o[r][m] *= 1.0f;", True),
        # each stage's copy lands in the slot of the stage after it (on
        # its own slot's barrier): it overwrites a slot whose readers have
        # not released it, and its own readers find the older stage
        "a ring slot overwritten before its readers release it": (
            "attention.cu",
            "  const uint32_t dst = ring_s + (g % NS32) * SLOT32;",
            "  const uint32_t dst = ring_s + ((g + 1) % NS32) * SLOT32;",
            True),
        "key_valid ignored (dead keys left live)": (
            "attention.cu",
            "live |= unsigned(key_live(kvalid, kv0 + lane + 32 * j, N)) << j;",
            "live |= unsigned(key_live(nullptr, kv0 + lane + 32 * j, N)) << j;",
            True),
        "the -inf guard removed": (
            "attention.cu", "const float base = softmax_ref(m_next);",
            "const float base = m_next;", True),
        "the last partial key step dropped": (
            "attention.cu", "const int nsteps = (N + BK32 - 1) / BK32;",
            "const int nsteps = N / BK32;", True),
        "P of the next V stage's keys": (
            "attention.cu", "VK32 * v + e4);",
            "VK32 * ((v + 1) % (BK32 / VK32)) + e4);", True),
        "rows past N stored": (
            "attention.cu", "    const int row = q0 + 8 * warp + r;\n"
            "    if (row >= N) continue;",
            "    const int row = q0 + 8 * warp + r;\n"
            "    if (row >= N + BQ32) continue;", True),
    }),
    # K3's bf16 kernel: every mutant keeps the producer's and the
    # consumers' schedules in step
    "k3_bf16": ("_check_k3_bf16(*chip_smoke._k3_inputs("
                "np.random.default_rng(0)))", ("K3",), {
        "last key tile skipped": (
            "attention.cu",
            "x = (live >> (2 * jj + e)) & 1u ? x * scale : -INFINITY;",
            "x = (live >> (2 * jj + e)) & 1u && j + 1 < ntiles ? x * scale "
            ": -INFINITY;", True),
        "alpha rescale dropped": (
            "attention.cu", "o[q] *= alpha[(q >> 1) & 1];", "o[q] *= 1.0f;",
            True),
        "the other warpgroup's row maximum ignored": (
            "attention.cu",
            "const float mt_both = fmaxf(mt[i], mx[other + r0 + 8 * i]);",
            "const float mt_both = mt[i];", True),
        "key_valid ignored": (
            "attention.cu", "  if (kvalid == nullptr)\n    return (key < N",
            "  if (true)\n    return (key < N", True),
        "the -inf guard removed": (
            "attention.cu", "const float ref = softmax_ref(m_next);",
            "const float ref = m_next;", True),
        "the last ragged query rows not stored": (
            "attention.cu", "    const int row = q0 + r0 + 8 * i;\n"
            "    if (row >= N) continue;",
            "    const int row = q0 + r0 + 8 * i;\n"
            "    if (row >= N / BQ16 * BQ16) continue;", True),
        "V's column halves swapped": (
            "attention.cu", "const uint32_t vw_s = v_s + NB * BOX16 * wg;",
            "const uint32_t vw_s = v_s + NB * BOX16 * (wg ^ 1);", True),
    }),
    # K8: every mutant keeps the issuer's and the consumers' schedules in
    # step; the check's NaN-filled C-entry call sees an output never stored
    "k8": ("_check_k8(np.random.default_rng(0))", ("K8",), {
        "one key tile skipped": (
            "ocab.cu", "          x = ex2(x - ref);",
            "          x = kt == 1 ? 0.0f : ex2(x - ref);", True),
        "bias row off by one": (
            "ocab.cu", "a.bias + (static_cast<size_t>(h) * a.nq + r) * a.nk + col;",
            "a.bias + (static_cast<size_t>(h) * a.nq + (r + 1) % a.nq) * a.nk "
            "+ col;", True),
        "bias head off by one": (
            "ocab.cu", "a.bias + (static_cast<size_t>(h) * a.nq + r) * a.nk + col;",
            "a.bias + (static_cast<size_t>((h + 1) % a.heads) * a.nq + r) * "
            "a.nk + col;", True),
        "O not rescaled when the max grows": (
            "ocab.cu", "o[q] *= alpha[(q >> 1) & 1];", "o[q] *= 1.0f;", True),
        "the row sum missing a key tile": (
            "ocab.cu", "l_run[i] = l_run[i] * alpha[i] + rs;",
            "l_run[i] = l_run[i] * alpha[i] + (kt == 1 ? 0.0f : rs);", True),
        "the last window dropped": (
            "ocab.cu",
            "const long long jobs = static_cast<long long>(a.heads) * a.nwb;",
            "const long long jobs = static_cast<long long>(a.heads) * a.nwb "
            "- 1;", True),
        "the last 64-row slice not stored": (
            "ocab.cu", "      if (row >= a.nq) continue;",
            "      if (row >= a.nq - BQ) continue;", True),
        "a padded key scored 0, not -inf": (
            "ocab.cu", "const float key_pad = -INFINITY;",
            "const float key_pad = 0.0f;", True),
    }),
    # K7: the check holds v1 within two bf16 ulps of its plain version at
    # K7_SHAPES (the HAT shape with extra) and v2 within its budget at
    # K7_V2_SHAPES; its output buffer comes from a freed NaN-filled block,
    # so a window never stored shows.  Each mutant builds K7 for C = 180
    # alone (K7_ONLY_C192), to keep the builds short.
    "k7": ("_check_k7(np.random.default_rng(0), chip_smoke.K7_SHAPES) and "
           "chip_smoke._check_k7(np.random.default_rng(0), "
           "chip_smoke.K7_V2_SHAPES, v2=True)", ("K7",), {
        "a k-step of the qkv products skipped": _k7(
            "        hopper::wgmma_ss<32, 1>(f[s], dA + a_step(ks), db + ks * 64);",
            "        if (ks != 1) hopper::wgmma_ss<32, 1>(f[s], dA + a_step(ks), db + ks * 64);"),
        "one fc1 tile of the ring skipped": _k7(
            "        hopper::wgmma_ss<32, 1>(h1, dA + a_step(ks), db1 + ks * 64);",
            "        if (ch != 2) hopper::wgmma_ss<32, 1>(h1, dA + a_step(ks), db1 + ks * 64);"),
        "the band mask in the wrong window row": _k7(
            "    lr = a.shift > 0 && wr == a.nwh - 1;",
            "    lr = a.shift > 0 && wr == a.nwh - 2;"),
        "the band mask in the wrong window column": _k7(
            "    lc = a.shift > 0 && wc == a.nww - 1;",
            "    lc = a.shift > 0 && wc == a.nww - 2;"),
        "the bias head off by one": _k7(
            "          a.bias + (static_cast<size_t>(h) * n + rows[i]) * n;",
            "          a.bias + (static_cast<size_t>((h + 1) % H) * n + rows[i]) * n;"),
        "the bias row off by one": _k7(
            "          a.bias + (static_cast<size_t>(h) * n + rows[i]) * n;",
            "          a.bias + (static_cast<size_t>(h) * n + min(rows[i] + 1, n - 1)) * n;"),
        "the P normalization dropped": _k7(
            "              x = fmaf(fmaf(-q, l, x), il, q);",
            "              x = x + 0.0f * q;"),
        "the last window never stored": _k7(
            "      const bool real = wi < a.nwin;",
            "      const bool real = wi < a.nwin - 1;"),
        "the last row block of a ws-16 window never stored": _k7(
            "      const bool real = rb < nrb;\n"
            "      const int tok0 = 64 * (real ? rb : nrb - 1);\n"
            "      int rows[2];",
            "      const bool real = rb < nrb - 1;\n"
            "      const int tok0 = 64 * (rb < nrb ? rb : nrb - 1);\n"
            "      int rows[2];"),
        "extra dropped": _k7(
            "                if (er != nullptr) v += es[e];", ""),
        "v2's q scale not applied": _k7(
            "          const float m = s == 0 ? a.qs[h] : 1.0f;",
            "          const float m = 1.0f;"),
    }),
}

# the kernel library built from some CUDA sources alone (the copy's other
# sources removed), binding the C entries they hold: for a target or timing
# whose kernel's sources need no other
ONE_SOURCE = """
import ctypes, glob, os
for src in glob.glob("hdrvae_torch/csrc/*.cu"):
    if os.path.basename(src) not in {sources!r}:
        os.remove(src)
from hdrvae_torch.kernels import _build
lib = ctypes.CDLL(str(_build.build()[0]))
for name, argtypes in _build.SIGNATURES.items():
    if hasattr(lib, name):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
_build.library = lambda: lib
"""
# K5's kernel (upconv.cu) and its statistics' reduction (conv3x3.cu's
# hdrvae_group_stats)
K5_SOURCES = ("upconv.cu", "conv3x3.cu")
# targets checked on a library built from some sources (see ONE_SOURCE)
ONE_SOURCE_TARGETS = {"k3_3pass": ("attention.cu",), "k5": K5_SOURCES,
                      "k1_owned": ("conv3x3.cu",),
                      "k2_owned": ("conv3x3.cu",),
                      "k4": ("epilogue.cu",), "k9": ("swin_chain.cu",),
                      "chain": ("swin_chain.cu",)}

CHECK = """
import sys
import numpy as np
import torch
sys.path.insert(0, '.')
import chip_smoke
{build}
try:
    chip_smoke.{call}
    torch.cuda.synchronize()
    print('SURVIVED')
except AssertionError as exc:
    print('CAUGHT:', exc)
except torch.AcceleratorError as exc:   # a fault of the broken kernel
    print('CAUGHT (the check faulted):', str(exc).splitlines()[0])
"""


# --time-k6: variant -> edits (text of dense_conv.cu, its replacement)
K6_VARIANTS = {
    "as-is": [],
    "two-warpgroups": [("  if (Plan<3>::smem_bytes(a.ntk) <= SMEM_MAX) return launch<3>(maps, a, st);",
                        "")],
    "no-stores": [
        ("            tma_store_4d(&ymap,",
         "            if (half < 0) tma_store_4d(&ymap,"),
        ("          if (pairs) {\n            if (n < a.Cout) {",
         "          if (pairs) {\n            if (n < 0) {"),
        ("              if (n + e < a.Cout) {", "              if (n < 0) {"),
    ],
    "no-slab-loads": [
        ("          if (tma) {\n            tma_load_4d(",
         "          if (false) {\n            tma_load_4d("),
        ("wbytes + (tma ? (two ? 2 : 1) * C::PLANE_TX\n"
         "                                             : 0)", "wbytes"),
    ],
    "no-weight-loads": [
        ("mbar_add_tx(full(s), wbytes + (tma", "mbar_add_tx(full(s), (tma"),
        ("          bulk_load(st_s + 2 * C::PLANE,",
         "          if (false) bulk_load(st_s + 2 * C::PLANE,"),
    ],
    "no-wgmma": [
        ("          wgmma_ss<NP, 0>(acc[mb],",
         "          if (ntaps < 0) wgmma_ss<NP, 0>(acc[mb],"),
    ],
}

# --time-k3: variant -> edits (text of attention.cu, its replacement)
K3_NO_K = [(f"load_boxes<NC>(k_s, &kmap, k_full, {row}, b);",
            f"load_boxes<0>(k_s, &kmap, k_full, {row}, b);")
           for row in ("0", "BKV16", "kv0 + 2 * BKV16")]
K3_NO_V = [(f"load_boxes<NC>(v_s, &vmap, v_full, {row}, b);",
            f"load_boxes<0>(v_s, &vmap, v_full, {row}, b);")
           for row in ("0", "kv0 + BKV16")]
K3_NO_S = [("      hopper::wgmma_ss<32, 0>(s, qd + off, kd + off);", "")]
K3_NO_PV = [("      hopper::wgmma_ss<128, 1>(o + 64 * pr,",
             "      if (NB < 0) hopper::wgmma_ss<128, 1>(o + 64 * pr,"),
            ("      hopper::wgmma_ss<64, 1>(o + 64 * (NB / 2),",
             "      if (NB < 0) hopper::wgmma_ss<64, 1>(o + 64 * (NB / 2),")]
K3_VARIANTS = {
    "as-is": [],
    "no-loads": [("  hopper::mbar_expect_tx(bar, NC * BOX16);\n#pragma unroll\n"
                  "  for (int c = 0; c < NC; ++c)",
                  "  hopper::mbar_expect_tx(bar, 0);\n#pragma unroll\n"
                  "  for (int c = 0; c < 0; ++c)")],
    "no-k-loads": K3_NO_K,
    "no-v-loads": K3_NO_V,
    "no-s-wgmma": K3_NO_S,
    "no-pv-wgmma": K3_NO_PV,
    "no-wgmma": K3_NO_S + K3_NO_PV,
    "fast-exp": [("      alpha[i] = expf(m_run[i] - ref);",
                  "      alpha[i] = __expf(m_run[i] - ref);"),
                 ("          x = expf(x - ref);",
                  "          x = __expf(x - ref);")],
    "skip-rescale": [
        ("#pragma unroll\n    for (int q = 0; q < NB * 32; ++q) o[q] *= "
         "alpha[(q >> 1) & 1];",
         "    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || "
         "alpha[1] != 1.0f))\n#pragma unroll\n"
         "    for (int q = 0; q < NB * 32; ++q) o[q] *= alpha[(q >> 1) & 1];")],
}

# --time-k3-f32: variant -> edits (text of attention.cu, its replacement)
K3F_NO_K = [("    hopper::mbar_expect_tx(bar, SLOT32);\n"
             "    hopper::tma_load_3d(dst, kmap, bar, KC32 * i, BK32 * step, b);",
             "    hopper::mbar_expect_tx(bar, 0);")]
K3F_NO_V = [("    hopper::mbar_expect_tx(bar, NC * VK32 * 256);\n#pragma unroll\n"
             "    for (int m = 0; m < NC; ++m)",
             "    hopper::mbar_expect_tx(bar, 0);\n#pragma unroll\n"
             "    for (int m = 0; m < 0; ++m)")]
K3F_VARIANTS = {
    "as-is": [],
    "no-loads": K3F_NO_K + K3F_NO_V,
    "no-k-loads": K3F_NO_K,
    "no-v-loads": K3F_NO_V,
    # the products' FFMAs taken out: their shared loads (and P's
    # shuffles) then feed nothing and go too
    "no-s-ffma": [("            s[r][j] = fmaf(qv.x, kf[j].x, s[r][j]);\n"
                   "            s[r][j] = fmaf(qv.y, kf[j].y, s[r][j]);\n"
                   "            s[r][j] = fmaf(qv.z, kf[j].z, s[r][j]);\n"
                   "            s[r][j] = fmaf(qv.w, kf[j].w, s[r][j]);\n",
                   "")],
    "no-pv-ffma": [("              o[r][m] = fmaf(p, vv[m], o[r][m]);",
                    "              {}")],
    # thread 0 refills the slot of the stage before the one its warp has
    # just released, or of the one two before (each once every warp has
    # released it)
    "refill-lag-1": [("    if (tid == 0 && g + NS32 < nst) {\n"
                      "      hopper::mbar_wait(empty(g), (g / NS32) & 1);\n"
                      "      f32_stage_copy<NC>(g + NS32,",
                      "    if (tid == 0 && g >= 1 && g - 1 + NS32 < nst) {\n"
                      "      hopper::mbar_wait(empty(g - 1), ((g - 1) / NS32) & 1);\n"
                      "      f32_stage_copy<NC>(g - 1 + NS32,")],
    "refill-lag-2": [("    if (tid == 0 && g + NS32 < nst) {\n"
                      "      hopper::mbar_wait(empty(g), (g / NS32) & 1);\n"
                      "      f32_stage_copy<NC>(g + NS32,",
                      "    if (tid == 0 && g >= 2 && g - 2 + NS32 < nst) {\n"
                      "      hopper::mbar_wait(empty(g - 2), ((g - 2) / NS32) & 1);\n"
                      "      f32_stage_copy<NC>(g - 2 + NS32,")],
}

# --time-k3-3pass: variant -> alternatives, each a list of (source, text,
# replacement), as for --time-k7; the first alternative that the tree holds
# is made.  K3P_OLD times the earlier mma.sync kernel (K and V split from
# float32 in every block) in an older tree (--tree).
AT = "attention.cu"
K3P_OLD_NO_SPLIT = [
    (AT, "    split_rows(kvh, kvl, k + base, kv0, BKV3, N, C, ld, 1.0f);\n", ""),
    (AT, "    split_rows(kvh, kvl, v + base, kv0, BKV3, N, C, ld, 1.0f);\n", "")]
K3P_OLD_NO_S = [
    (AT, "          mma_bf16_16816_new(part, ah, bh + 2 * j);\n"
         "          winattn::mma_bf16_16816(part, ah, bl + 2 * j);\n"
         "          winattn::mma_bf16_16816(part, al, bh + 2 * j);\n",
     "          part[0] = part[1] = part[2] = part[3] = 0.0f;\n")]
K3P_OLD_NO_PV = [
    (AT, "              if (ks == 0)\n"
         "                mma_bf16_16816_new(t[jj], pa_h[ks], vh + 2 * jj);\n"
         "              else\n"
         "                winattn::mma_bf16_16816(t[jj], pa_h[ks], vh + 2 * jj);\n"
         "              winattn::mma_bf16_16816(t[jj], pa_h[ks], vl + 2 * jj);\n"
         "              winattn::mma_bf16_16816(t[jj], pa_l[ks], vh + 2 * jj);\n",
     "              t[jj][0] = t[jj][1] = t[jj][2] = t[jj][3] = 0.0f;\n")]
K3P_OLD = {
    "as-is": [],
    # K and V neither read nor split (the tiles keep stale bytes)
    "no-loads": K3P_OLD_NO_SPLIT,
    # no S mma (the ldmatrix loads that fed them stay)
    "no-s-products": K3P_OLD_NO_S,
    # no P V mma (likewise)
    "no-pv-products": K3P_OLD_NO_PV,
    # neither loads nor products: the barriers, q's split, the ldmatrix
    # loads and the softmax
    "barriers-only": K3P_OLD_NO_SPLIT + K3P_OLD_NO_S + K3P_OLD_NO_PV,
}
K3P_NO_S = [(AT, "    hopper::wgmma_ss<64, 0>(part, qhd + 2 * kk, kd + 2 * kk);\n"
                  "    hopper::wgmma_ss<32, 0>(part, qld + 2 * kk, kd + 2 * kk);\n",
             "")]
K3P_NO_PV = [(AT, "        hopper::wgmma_ss<128, 1>(part, phd + 2 * ks, vd);\n"
                   "        hopper::wgmma_ss<64, 1>(part, pld + 2 * ks, vd);\n",
              "")]
K3P_NEW = {
    "as-is": [],
    # no TMA copies of K and V (their barriers still complete; the slots
    # keep stale bytes; q still loads)
    "no-loads": [
        (AT, "    hopper::mbar_expect_tx(bar, SLOT3);\n#pragma unroll\n"
             "    for (int p = 0; p < 4; ++p)",
         "    hopper::mbar_expect_tx(bar, 0);\n#pragma unroll\n"
         "    for (int p = 0; p < 0; ++p)"),
        (AT, "    hopper::mbar_expect_tx(bar, second ? SLOT3 : 2 * QUART3);",
         "    hopper::mbar_expect_tx(bar, 0);"),
        (AT, "      if (p < 2 || second)", "      if (p < 0)")],
    # no S = q K^T wgmmas (scores 0), or no P V ones
    "no-s-wgmma": K3P_NO_S,
    "no-pv-wgmma": K3P_NO_PV,
    "no-wgmma": K3P_NO_S + K3P_NO_PV,
    # the wrapper launches no split (the parts are uninitialized)
    "no-presplit": [
        ("../kernels/attention.py", "    parts = split_qkv(q, k, v)\n",
         "    parts = torch.empty(3, 2, *q.shape, device=q.device,\n"
         "                        dtype=torch.bfloat16)\n")],
}
K3P_VARIANTS = {name: [alt[name] for alt in (K3P_NEW, K3P_OLD)
                       if name in alt]
                for name in dict.fromkeys([*K3P_NEW, *K3P_OLD])}

# --time-k8: variant -> edits (text of ocab.cu, its replacement)
K8_VARIANTS = {
    "as-is": [],
    "no-kv-loads": [("          hopper::mbar_expect_tx(full(tile), STAGE);\n"
                     "          hopper::tma_load_3d(dst, &kmap, full(tile), 0, BK * kt, b);\n"
                     "          hopper::tma_load_3d(dst + TILE, &vmap, full(tile), 0, BK * kt, b);",
                     "          hopper::mbar_arrive(full(tile));")],
    "no-bias-fill": [("      if (r < a.nq && col < a.nk) {", "      if (r < 0) {")],
    "no-bias-loads": [("      const float4 bb = bt[j * 32];",
                       "      const float4 bb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);")],
    "no-exp": [("          x = ex2(x - ref);", "          x = (x - ref) * 0.5f;"),
               ("      alpha[i] = ex2(m_run[i] - ref);", "      alpha[i] = 1.0f;")],
    "no-softmax": [("      softmax(kt, alpha);", "      alpha[0] = alpha[1] = 1.0f;")],
    "no-s-wgmma": [("      hopper::wgmma_ss<64, 0>(s, qd + 2 * kk, kd + 2 * kk);",
                    "      if (kk < 0) hopper::wgmma_ss<64, 0>(s, qd + 2 * kk, kd + 2 * kk);")],
    "no-pv-wgmma": [("      hopper::wgmma_rs_n32<1>(o, p + 4 * ks, vd + ks * (1024 >> 4));",
                     "      if (ks < 0) hopper::wgmma_rs_n32<1>(o, p + 4 * ks, vd + ks * (1024 >> 4));")],
    "two-warpgroups": [("  if (Plan<3>::smem_bytes(a.ntk) <= SMEM_MAX) return launch<3>(maps, a, st);",
                        "")],
    "no-stores": [("      if (store_pending) store(ojob, l_fin);\n", ""),
                  ("    store(ojob, l_fin);\n    seg = seg_end;", "    seg = seg_end;")],
}

# --time-k7: variant -> alternatives, each a list of (source, text,
# replacement); the first alternative whose texts the tree holds is made.
# The first alternative is the wgmma kernel; a second, where there is one,
# is the earlier mma.sync / WMMA kernel (one window a block, qkv through a
# device-memory scratch), for timing it in an older tree (--tree).
SB, WA = "swin_block.cu", "window_attention.cuh"
K7_NEW = {
    "as-is": [],
    # the weight tiles are not copied (the ring's barriers still complete;
    # the slots keep stale bytes)
    "no-weight-loads": [
        (SB, "    hopper::mbar_expect_tx(fb, TB);\n    if (i < 3 * H) {",
         "    hopper::mbar_arrive(fb);\n    if (true) {\n    } else if (i < 3 * H) {")],
    # no attention: no S, softmax or P V (the attention output stays as
    # it was)
    "no-attention": [
        (SB, "        scores(s, bb, qa, k_s, 0, rows, lr, lc);",
         "        for (int e = 0; e < 32; ++e) s[e] = 0.0f;"),
        (SB, "        pv(o, pa, v_s);\n", ""),
        (SB, "for (int kt = 0; kt < ntk; ++kt) {   // pass 1",
         "for (int kt = 0; kt < 0; ++kt) {"),
        (SB, "for (int kt = 0; kt < ntk; ++kt) {   // pass 2",
         "for (int kt = 0; kt < 0; ++kt) {")],
    # q / k / v neither stored to nor read from device memory (windows
    # past 64 tokens; up to 64 tokens they stay on chip)
    "no-qkv-scratch": [
        (SB, "        if (!real) continue;\n        bf16* sq",
         "        continue;\n        bf16* sq"),
        (SB, "off < n64 * 64;", "off < 0;"),
        (SB, "            qa[2 * j + i] = __ldcg(",
         "            qa[2 * j + i] = 0 * __ldcg(")],
    # the position bias not read (zeros)
    "no-bias-reads": [
        (SB, "bb[4 * j + 2 * i + e] = key < n ? __ldg(brow + key) : 0.0f;",
         "bb[4 * j + 2 * i + e] = 0.0f;")],
    # no LN1 statistics and no GELU (the rows pass as they are)
    "no-ln-gelu": [
        (SB, "      if constexpr (!V2) {\n        float sum = 0.0f;",
         "      if constexpr (false) {\n        float sum = 0.0f;"),
        (SB, "? winattn::gelu_erf(h1[4 * j + 2 * i + e] + b1_s[c])",
         "? (h1[4 * j + 2 * i + e] + b1_s[c])")],
    # the input image not read (LN1's rows and the proj residual)
    "no-x-loads": [
        (SB, "        v[k] = live ? load_pair(src, 8 * k + 2 * t, a.C)",
         "        v[k] = live ? make_float2(0.5f, 0.5f)"),
        (SB, "              const float2 xv = load_pair(xr, c, a.C);",
         "              const float2 xv = make_float2(0.5f, 0.5f);")],
    # the block's output not stored
    "no-stores": [
        (SB, "      if (real) {\n        const int rows_w",
         "      if (false) {\n        const int rows_w"),
        (SB, "            store_pair(dst, c, a.C, o[0], o[1]);", "            {}")],
    # P as e times 1 / l (the kernel before it divided) instead of the
    # correctly rounded e / l
    "reciprocal": [
        (SB, """            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * j + 2 * i + e];
              const float q = x * il;
              x = fmaf(fmaf(-q, l, x), il, q);
            }""", "            for (int e = 0; e < 2; ++e) s[4 * j + 2 * i + e] *= il;"),
        (SB, """                const float ex = expf(x - m[i]), q = ex * il[i];
                x = fmaf(fmaf(-q, l[i], ex), il[i], q);   // ex / l, as above""",
         "                x = expf(x - m[i]) * il[i];")],
    # the divide by __fdiv_rn (with its range check) instead of the
    # reciprocal and one FMA correction: the same quotient
    "divide": [
        (SB, """              const float q = x * il;
              x = fmaf(fmaf(-q, l, x), il, q);""",
         "              x = il == 0.0f ? 0.0f : __fdiv_rn(x, l);"),
        (SB, """                const float ex = expf(x - m[i]), q = ex * il[i];
                x = fmaf(fmaf(-q, l[i], ex), il[i], q);   // ex / l, as above""",
         "                x = il[i] == 0.0f ? 0.0f : __fdiv_rn(expf(x - m[i]), l[i]);")],
    # one warpgroup a block (as past C = 192) instead of two
    "one-warpgroup": [
        (SB, "if (!plan(a, CK, 2, smem) && !plan(a, CK, 1, smem))",
         "if (!plan(a, CK, 1, smem))")],
}
# The earlier mma.sync / WMMA kernel (one window a block, qkv through a
# device-memory scratch), for timing it in an older tree (--tree)
K7_OLD = {
    "as-is": [],
    "no-weight-loads": [
        (WA, "    if (i < total) {\n      const int c0",
         "    if (false) {\n      const int c0")],
    "no-attention": [
        (SB, "    for (int h = 0; h < a.heads; ++h) {\n      const bf16* qs",
         "    for (int h = 0; h < 0; ++h) {\n      const bf16* qs")],
    "no-qkv-scratch": [
        (SB, "        store_bf16x8(dst + static_cast<size_t>(r) * QW + c, o);", ""),
        (SB, "      copy_rows_async(qs, LDQ, qkv_h + static_cast<size_t>(r0) * QW, QW,\n"
             "                      nrt * 16, HDP);", ""),
        (SB, "      copy_rows_async(qs + RB * LDQ, LDQ, qkv_h + HDP, QW, a.n16, HDP);", ""),
        (SB, "      copy_rows_async(qs + (RB + a.n16) * LDQ, LDQ, qkv_h + 2 * HDP, QW,\n"
             "                      a.n16, HDP);", "")],
    "no-bias-reads": [(WA, "      float t = brow[j];", "      float t = 0.0f;")],
    "no-ln-gelu": [
        (WA, "    if constexpr (NORM) row_stats(v, C, mean, rstd);", ""),
        (SB, "        g[i] = c + i < a.hidden ? gelu_erf(u) : 0.0f;",
         "        g[i] = u;")],
    "no-stores": [
        (SB, "          dst[c] = ys[static_cast<size_t>(r) * a.ldy + c];",
         "          if (c < 0) dst[c] = ys[static_cast<size_t>(r) * a.ldy + c];")],
}
K7_VARIANTS = {name: [edits + [(SB, *K7_ONLY_C192)]] +
               ([K7_OLD[name]] if name in K7_OLD else [])
               for name, edits in K7_NEW.items()}

K7_TIME = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import _build, swin_attention as ska
from hdrvae_torch.models.swinir import block_weights

_build.library()
rng = np.random.default_rng(0)
cases = []
for name, h, w, ws, shift, extra in cs.K7_SHAPES:
    blk = cs._swin_block(rng, cs.SWIN_DIM, cs.SWIN_HEADS, ws)
    wts = block_weights(blk, cs.SWIN_HEADS, ws, torch.bfloat16)
    x = cs._bf16(rng, (1, h, w, cs.SWIN_DIM))
    e = cs._bf16(rng, (1, h, w, cs.SWIN_DIM), 0.5) if extra else None
    cases.append((f"{name} {h}x{w} ws {ws} shift {shift}", h * w, ws,
                  lambda x=x, wts=wts, ws=ws, shift=shift, e=e:
                  ska.swin_block_fused(x, wts, ws=ws, shift=shift, extra=e,
                                       precision=Precision.fast())))
for _ in range(2):
    total = 0.0
    for label, tokens, ws, fn in cases:
        t = cs.cuda_ms(fn, iters=10)
        total += t
        flops = cs._swin_flops(tokens, ws * ws)
        print(f"  K7 {label}: {t:.3f} ms ({flops / (t * 1e9):.1f} TFLOP/s)",
              flush=True)
    print(f"  K7 over K7_SHAPES: {total:.3f} ms", flush=True)
'''

K8_TIME = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hdrvae_torch.kernels import _build, ocab

_build.library()
q, k, v, bias = cs._k8_inputs(np.random.default_rng(0), cs.K8_SHAPE)
kw = dict(compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16)
for _ in range(2):
    t = cs.cuda_ms(lambda: ocab.ocab_attention(q, k, v, bias, **kw), iters=10)
    print(f"  K8 {list(cs.K8_SHAPE)}: {t:.3f} ms", flush=True)
'''

K3_TIME = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hdrvae_torch.kernels import _build, attention

_build.library()
q, k, v = (x.bfloat16() for x in cs._k3_inputs(np.random.default_rng(0)))
kv = cs._live_mask(128, cs.K3_LIVE)
for _ in range(2):
    t = cs.cuda_ms(lambda: attention.flash_attention_bf16(q, k, v), iters=10)
    tm = cs.cuda_ms(lambda: attention.flash_attention_bf16(q, k, v, kv),
                    iters=10)
    print(f"  N={cs.N_TOKENS} C={cs.C_ATTN}: unmasked {t:.3f} ms "
          f"({cs.ATTN_FLOPS / (t * 1e9):.1f} TFLOP/s), masked {tm:.3f} ms",
          flush=True)
'''

K3F_TIME = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hdrvae_torch.kernels import _build, attention

_build.library()
q, k, v = cs._k3_inputs(np.random.default_rng(0))
kv = cs._live_mask(128, cs.K3_LIVE)
for _ in range(2):
    t = cs.cuda_ms(lambda: attention.flash_attention_f32(q, k, v), iters=5)
    tm = cs.cuda_ms(lambda: attention.flash_attention_f32(q, k, v, kv),
                    iters=5)
    print(f"  N={cs.N_TOKENS} C={cs.C_ATTN}: unmasked {t:.3f} ms "
          f"({cs.ATTN_FLOPS / (t * 1e9):.1f} TFLOP/s), masked {tm:.3f} ms",
          flush=True)
'''

# K3's 3-pass mode, built from attention.cu alone (ONE_SOURCE)
K3P_TIME = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
''' + ONE_SOURCE.format(sources=("attention.cu",)) + r'''
from hdrvae_torch.kernels import attention
q, k, v = cs._k3_inputs(np.random.default_rng(0))
kv = cs._live_mask(128, cs.K3_LIVE)
flops = 3 * cs.ATTN_FLOPS
for _ in range(2):
    t = cs.cuda_ms(lambda: attention.flash_attention_3pass(q, k, v), iters=5)
    tm = cs.cuda_ms(lambda: attention.flash_attention_3pass(q, k, v, kv),
                    iters=5)
    print(f"  N={cs.N_TOKENS} C={cs.C_ATTN}: unmasked {t:.3f} ms "
          f"({flops / (t * 1e9):.1f} TFLOP/s), masked {tm:.3f} ms",
          flush=True)
'''

K6_TIME = r'''
import sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
from hdrvae_torch.kernels import _build, dense_conv

_build.library()
rng = np.random.default_rng(0)
dev_sum = wrap_sum = 0.0
for name, h, w, cins, cout, act, rs, f32 in cs.K6_SHAPES + cs.K6_EXTRA[:1]:
    xs = [cs._bf16(rng, (1, h, w, c), 0.5) for c in cins]
    kern = cs._bf16(rng, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5)
    bias = cs._uniform(rng, -0.1, 0.1, cout)
    kw = dict(act=act, out_dtype=torch.float32 if f32 else None)
    if rs is not None:
        kw.update(residual=cs._bf16(rng, (1, h, w, cout), 0.5), res_scale=rs)
    pw = dense_conv.prepare_weights(kern, bias, cins)

    def run():
        dense_conv.dense_conv3x3(xs, pw, **kw)

    wrap = cs.cuda_ms(run, iters=10, warmup=3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    dev = sum(e.device_time_total for e in prof.key_averages()
              if "dense_wgmma_kernel" in e.key) / 10 / 1e3
    if name != "conv_body":
        dev_sum, wrap_sum = dev_sum + dev, wrap_sum + wrap
    print(f"  {name:13s} device {dev:.3f} ms  wrapper {wrap:.3f} ms",
          flush=True)
print(f"  phase-3 sum   device {dev_sum:.3f} ms  wrapper {wrap_sum:.3f} ms",
      flush=True)
'''


# --time-k5: variant -> alternatives, each a list of (source, text,
# replacement), as for --time-k3-3pass; K5_OLD times PR 5's mma.sync kernel
# (8 x 16 tiles, weights through a cp.async ring) in an older tree (--tree)
UC = "upconv.cu"
K5_NEW = {
    "as-is": [],
    # the ring's weight stages are not copied (each stage's barrier still
    # completes; the slots keep stale bytes; the slab still loads)
    "no-weight-loads": [
        (UC, "              mbar_expect_tx(w_full(r.s), STAGE_BYTES);\n"
             "              for (int v = 0; v < 2; ++v)",
         "              mbar_arrive(w_full(r.s));\n"
             "              for (int v = 0; v < 0; ++v)"),
        (UC, "            mbar_expect_tx(w_full(r.s), NH * SLICE_BYTES);\n"
             "            for (int nh = 0; nh < NH; ++nh)",
         "            mbar_arrive(w_full(r.s));\n"
             "            for (int nh = 0; nh < 0; ++nh)")],
    # no up-conv wgmma (the feed, the band epilogue and conv1 run)
    "no-upconv-products": [
        (UC, "              wgmma_ss<64, 1>(up, a_desc(",
         "              if (ks < 0) wgmma_ss<64, 1>(up, a_desc(")],
    # no conv1 wgmma
    "no-conv1-products": [
        (UC, "            wgmma_ss<CO, 1>(\n                acc[mb],",
         "            if (ks < 0) wgmma_ss<CO, 1>(\n                acc[mb],")],
    # the band is not written (no bias, GroupNorm affine, SiLU or stores)
    "no-band-epilogue": [
        (UC, "        if (ri >= PH_ROWS || ci >= PH_COLS) continue;",
         "        if (ri >= 0) continue;")],
    # y is not stored (the statistics still run)
    "no-y-stores": [
        (UC, "              *reinterpret_cast<__nv_bfloat162*>(a.y + orow[mb][i] + n) = yb;\n",
         "")],
}
K5_OLD = {
    "as-is": [],
    # the ring's weight pieces are not copied (the slab still loads; the
    # buffers keep stale bytes)
    "no-weight-loads": [
        (UC, "      for (int e = tid; e < KP * per_row; e += NTHREADS) {",
         "      for (int e = tid; e < 0; e += NTHREADS) {")],
    # no up-conv mma.sync (the ldmatrix loads that fed them stay)
    "no-upconv-products": [
        (UC, "            mma_bf16_16816(acc_a[mt][2 * j], af, bfr[j]);\n"
             "            mma_bf16_16816(acc_a[mt][2 * j + 1], af, bfr[j] + 2);\n",
         "")],
    # no conv1 mma.sync (likewise)
    "no-conv1-products": [
        (UC, "            mma_bf16_16816(acc_b[r][2 * jj], af, bfr[jj]);\n"
             "            mma_bf16_16816(acc_b[r][2 * jj + 1], af, bfr[jj] + 2);\n",
         "")],
    # the band is not written (no bias, GroupNorm affine, SiLU or stores)
    "no-band-epilogue": [(UC, "      if (p == npa - 1) {", "      if (p < 0) {")],
    # y is not stored (the statistics still run)
    "no-y-stores": [
        (UC, "      y[((static_cast<size_t>(b) * H2 + oh) * W2 + ow) * COUT + co] = yb;\n",
         "")],
}
K5_VARIANTS = {name: [alt[name] for alt in (K5_NEW, K5_OLD) if name in alt]
               for name in dict.fromkeys([*K5_NEW, *K5_OLD])}

# K5 at chip_smoke.py's K5_SHAPES, built from K5_SOURCES alone: the
# kernel's device time (torch.profiler, mean of 5 launches after 2
# warm-ups) and the wrapper's (CUDA events, mean of 5), twice
K5_TIME = r'''
import sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
import chip_smoke as cs
''' + ONE_SOURCE.format(sources=K5_SOURCES) + r'''
from hdrvae_torch.kernels import conv3x3
rng = np.random.default_rng(5)
cin, cm, cout = cs.K5_CIN, cs.K5_CM, cs.K5_COUT
cases = []
for h, w in cs.K5_SHAPES:
    args = (cs._bf16(rng, (1, h, w, cin), 0.5),
            cs._bf16(rng, (3, 3, cin, cm), (9 * cin) ** -0.5),
            cs._uniform(rng, -0.1, 0.1, cm), cs._uniform(rng, 0.5, 1.5, (1, cm)),
            cs._uniform(rng, -0.5, 0.5, (1, cm)),
            cs._bf16(rng, (3, 3, cm, cout), (9 * cm) ** -0.5),
            cs._uniform(rng, -0.1, 0.1, cout))
    flops = 2 * h * w * 16 * cin * cm + 2 * (4 * h * w) * 9 * cm * cout
    cases.append((h, w, args, flops))
for _ in range(2):
    dev_sum = wrap_sum = 0.0
    for h, w, args, flops in cases:
        def run():
            conv3x3.upconv_gn_conv3x3(*args, emit_stats=True, num_groups=32)
        wrap = cs.cuda_ms(run, iters=5, warmup=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        dev = sum(e.device_time_total for e in prof.key_averages()
                  if "upconv" in e.key) / 5 / 1e3
        dev_sum, wrap_sum = dev_sum + dev, wrap_sum + wrap
        print(f"  {h}x{w}->{2 * h}x{2 * w}: device {dev:.3f} ms "
              f"({flops / (dev * 1e9):.1f} TFLOP/s)  wrapper {wrap:.3f} ms",
              flush=True)
    print(f"  K5_SHAPES sum: device {dev_sum:.3f} ms  wrapper "
          f"{wrap_sum:.3f} ms", flush=True)
'''

# --time-k4: variant -> alternatives, each a list of (source, text,
# replacement), as for --time-k5; K4_OLD times PR 2's kernel (a warp a row,
# scalar loads, a Welford step a value) in an older tree (--tree)
EP = "epilogue.cu"
K4_NEW = {
    "as-is": [],
    # every lane reads the map's first vectors (cached) instead of its own
    "no-loads": [(EP, "                           src + row * vpr + rl + tpr * sl);",
                  "                           src + rl + tpr * sl);")],
    # the collapsed rows are not stored (still staged)
    "no-stores": [
        (EP, "    if (lane < NV)", "    if (lane < 0)"),
        (EP, "for (int i = lane; i < nrows * 3; i += 32) dst[i] = stage[i];",
         "for (int i = lane; i < 0; i += 32) dst[i] = stage[i];")],
    # no per-element statistics or group maxes (K4 has no matrix
    # products: its per-element arithmetic stands in for them)
    "no-products": [
        (EP, """  st.mn = fminf(st.mn, tree_min<E>(v));
  st.mx = fmaxf(st.mx, tree_max<E>(v));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) gk[e] = keep_or_neg_inf(x[e], keep[k][e]);
    g[k] = fmaxf(g[k], tree_max<E>(gk));
  }""", ""),
        (EP, """    const float d = v[e] - st.K;
    st.s1[e & 1] += d;
    st.s2[e & 1] = fmaf(d, d, st.s2[e & 1]);""",
         "    st.s1[e & 1] += v[e];"),
        (EP, """    const float d0 = lo_f(w[i]) - st.K, d1 = hi_f(w[i]) - st.K;
    st.s1[0] += d0;
    st.s2[0] = fmaf(d0, d0, st.s2[0]);
    st.s1[1] += d1;
    st.s2[1] = fmaf(d1, d1, st.s2[1]);
    if (i > 0) {
      mn = min2(mn, w[i]);
      mx = max2(mx, w[i]);
    }""", "    st.s1[0] += lo_f(w[i]);"),
        (EP, """#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t m = (w[0] & keep[k][0]) | (0xff80ff80u & ~keep[k][0]);
#pragma unroll
    for (int i = 1; i < W; ++i)
      m = max2(m, (w[i] & keep[k][i]) | (0xff80ff80u & ~keep[k][i]));
    g[k] = fmaxf(g[k], fmaxf(lo_f(m), hi_f(m)));
  }
  st.n += 2 * W;""", "  st.n += 2 * W;")],
}
K4_OLD = {
    "as-is": [],
    "no-loads": [(EP, "      const float v = to_f32(p[c]);",
                  "      const float v = to_f32(pre[c & 7]);")],
    "no-stores": [(EP, "    if (lane < 3) store(collapsed + row * 3 + lane,",
                   "    if (lane < 0) store(collapsed + row * 3 + lane,")],
    "no-products": [
        (EP, """      m.n += 1.0f;
      const float d = v - m.mean;
      m.mean += d / m.n;
      m.m2 += d * (v - m.mean);
      m.mn = fminf(m.mn, v);
      m.mx = fmaxf(m.mx, v);
      if (c < b1)
        g0 = fmaxf(g0, v);
      else if (c < b2)
        g1 = fmaxf(g1, v);
      else if (c < b3)
        g2 = fmaxf(g2, v);""", "      m.mean += v;")],
}
K4_VARIANTS = {name: [alt[name] for alt in (K4_NEW, K4_OLD) if name in alt]
               for name in K4_NEW}

# K4 at chip_smoke.py's K4_SHAPE in float32 and bf16 (a post-SiLU map),
# built from epilogue.cu alone: the wrapper by CUDA events, mean of 10
# after 2 warm-ups, twice
K4_TIME = r"""
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
""" + ONE_SOURCE.format(sources=("epilogue.cu",)) + r"""
from hdrvae_torch.kernels import epilogue
g = torch.Generator(device="cuda").manual_seed(4)
x = torch.nn.functional.silu(
    torch.randn(cs.K4_SHAPE, generator=g, device="cuda") * 2.0)
maps = [x, x.bfloat16()]
for _ in range(2):
    total = 0.0
    for pre in maps:
        t = cs.cuda_ms(lambda: epilogue.collapse_and_stats_fused(pre),
                       iters=10)
        total += t
        gbs = pre.numel() * pre.element_size() / (t * 1e6)
        print(f"  K4 {list(cs.K4_SHAPE)} {pre.dtype}: {t:.3f} ms "
              f"({gbs:.0f} GB/s read)", flush=True)
    print(f"  K4 over both dtypes: {total:.3f} ms", flush=True)
"""

# --time-k9: variant -> alternatives, as for --time-k4; K9_OLD times PR 6's
# WMMA kernel (a block a window, head and row block, scores through shared
# memory) in an older tree (--tree)
SC = "swin_chain.cu"
K9_NEW = {
    "as-is": [],
    # the ring's q / k / v boxes are not copied (each slot's barrier still
    # completes; the slots keep stale bytes)
    "no-loads": [
        (SC, "    hopper::mbar_expect_tx(fb, SLOT);\n#pragma unroll\n"
             "    for (int j = 0; j < 3; ++j)",
         "    hopper::mbar_arrive(fb);\n#pragma unroll\n"
             "    for (int j = 0; j < 0; ++j)")],
    # the output rows are not stored (still staged)
    "no-stores": [
        (SC, "        hopper::tma_store_3d(&omap, out_s, h * HDP, 64 * rb, win);\n",
         "")],
    # no S or P V wgmma (the feed, the softmax, kept alive by an opaque use
    # of P, and the stores run)
    "no-products": [
        (SC, "          hopper::wgmma_ss<64, 0>(s[kt], dq + 2 * kk,",
         "          if (kk < 0) hopper::wgmma_ss<64, 0>(s[kt], dq + 2 * kk,"),
        (SC, "          hopper::wgmma_rs_n32<1>(o, pa[kt] + 4 * ks,\n"
             "                                  desc64(v_s + kt * ATOM) + ks * 64);",
         "          hopper::fence_operands<4>(pa[kt] + 4 * ks);   // P kept")],
    # P normalized as e times the reciprocal of l, as K7 does, instead of
    # the divide
    "reciprocal": [
        (SC, "auto div = [&](float e) { return fmaf(fmaf(-e * rl, l, e), rl, e * rl); };",
         "auto div = [&](float e) { return e * rl; };")],
}
K9_OLD = {
    "as-is": [],
    "no-loads": [
        (SC, "  copy_rows_async(qs, LDQ, src + static_cast<size_t>(r0) * QW, QW, nrt * 16,\n"
             "                  HDP);\n", ""),
        (SC, "  copy_rows_async(kv, LDQ, src + HDP, QW, n16, HDP);\n", ""),
        (SC, "  copy_rows_async(kv, LDQ, src + 2 * HDP, QW, n16, HDP);   // V over K\n",
         "")],
    "no-stores": [
        (SC, "      store_bf16x8(ob + static_cast<size_t>(r) * heads * HDP + c, v);\n",
         "")],
    "no-products": [
        (SC, "gemm_rows<true>(qs, LDQ, nrt, kv, LDQ, 2, n16 / 16,",
         "gemm_rows<true>(qs, LDQ, nrt, kv, LDQ, 0, n16 / 16,"),
        (SC, "                   n16 / 16, 2, [&](int rt, int ct, const Acc& acc) {",
         "                   0, 2, [&](int rt, int ct, const Acc& acc) {")],
}
K9_VARIANTS = {name: [alt[name] for alt in (K9_NEW, K9_OLD) if name in alt]
               for name in K9_NEW}

# K9 at chip_smoke.py's K7_SHAPES on K10's qkv, built from swin_chain.cu
# alone: CUDA events, mean of 10 after 2 warm-ups, twice
K9_TIME = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
""" + ONE_SOURCE.format(sources=("swin_chain.cu",)) + r"""
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import swin_attention as ska
from hdrvae_torch.models.swinir import block_weights
rng = np.random.default_rng(0)
cases = []
for name, h, w, ws, shift, extra in cs.K7_SHAPES:
    blk = cs._swin_block(rng, cs.SWIN_DIM, cs.SWIN_HEADS, ws)
    wts = block_weights(blk, cs.SWIN_HEADS, ws, torch.bfloat16)
    x = cs._bf16(rng, (1, h, w, cs.SWIN_DIM))
    qkv = ska.ln_qkv(x, wts, ws=ws, precision=Precision.fast())
    kw = dict(heads=cs.SWIN_HEADS, ws=ws, shift=shift,
              grid=(h // ws, w // ws))
    cases.append((f"{name} {h}x{w} ws {ws} shift {shift}",
                  lambda qkv=qkv, wts=wts, kw=kw:
                  ska.window_attention_core(qkv, wts.bias, **kw)))
for _ in range(2):
    total = 0.0
    for label, fn in cases:
        t = cs.cuda_ms(fn, iters=10)
        total += t
        print(f"  K9 {label}: {t:.3f} ms", flush=True)
    print(f"  K9 over K7_SHAPES: {total:.3f} ms", flush=True)
"""

# --time-k10 / --time-k11: variant -> alternatives, as for --time-k4 (the
# earlier kernels of an older tree: as-is only)
K10_VARIANTS = {
    "as-is": [[]],
    "no-stores": [[
        (SC, "            hopper::tma_store_3d(&qmap, stage_s + (3 * b + s) * ATOM,\n"
             "                                 h * 96 + s * HDP, tok0, win);", "{}")]],
    "no-products": [[
        (SC, "        hopper::wgmma_ss<96, 1>(f, dA + a_step(ks), db + ks * 64);",
         "        if (ks < 0) hopper::wgmma_ss<96, 1>(f, dA + a_step(ks), db + ks * 64);")]],
    "no-weight-loads": [[
        (SC, "    hopper::mbar_expect_tx(r.full(j), 3 * TB);\n#pragma unroll\n"
             "    for (int s = 0; s < 3; ++s)",
         "    hopper::mbar_arrive(r.full(j));\n#pragma unroll\n"
         "    for (int s = 0; s < 0; ++s)")]],
    # LN1's x rows not read (a constant)
    "no-x-loads": [[
        (SC, "      load_row(xw[i], a.x + (tok < n ? pix(a, win, tok) : 0), t, a.C);",
         "      for (int k = 0; k < NP; ++k) xw[i][k] = 0x3f003e80u + k;")]],
}
K11_VARIANTS = {
    "as-is": [[]],
    "no-stores": [[
        (SC, "          for (int ch = tid & 127; ch < per; ch += 128) dst[ch] = src[ch];",
         "          for (int ch = tid & 127; ch < 0; ch += 128) dst[ch] = src[ch];"),
        (SC, "          store_pair(a.y + px[i], 8 * k + 2 * t, a.C, o.x, o.y);",
         "          if (k < 0) store_pair(a.y + px[i], 8 * k + 2 * t, a.C, o.x, o.y);")]],
    "no-products": [[
        (SC, "          hopper::wgmma_ss<64, 1>(acc[jn], dO + ((h * ATOM + kk * 32) >> 4),",
         "          if (kk < 0) hopper::wgmma_ss<64, 1>(acc[jn], dO + ((h * ATOM + kk * 32) >> 4),"),
        (SC, "        hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);",
         "        if (ks < 0) hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);"),
        (SC, "          hopper::wgmma_rs_n64<1>(acc[jn], u + 4 * kk,",
         "          if (kk < 0) hopper::wgmma_rs_n64<1>(acc[jn], u + 4 * kk,")]],
    "no-weight-loads": [[
        (SC, "    hopper::mbar_expect_tx(fb, TB);\n    if (i < H) {",
         "    hopper::mbar_arrive(fb);\n    if (true) {\n    } else if (i < H) {")]],
    # the residual's x rows not read (constants)
    "no-x-loads": [[
        (SC, "      load_row(xw[i], a.x + px[i], t, a.C);",
         "      for (int k = 0; k < NP; ++k) xw[i][k] = 0x3f003e80u + k;")]],
    # no GELU (fc1 + b1 passes as it is)
    "no-gelu": [[
        (SC, "          u[2 * j + i] = pack_bf16(gelu_erf(h[4 * j + 2 * i] + bv.x),\n"
             "                                   gelu_erf(h[4 * j + 2 * i + 1] + bv.y));",
         "          u[2 * j + i] = pack_bf16(h[4 * j + 2 * i] + bv.x,\n"
         "                                   h[4 * j + 2 * i + 1] + bv.y);")]],
    # one warpgroup a block instead of two
    "one-warpgroup": [[
        (SC, "  if (!rows::plan(a, 2, reg, par, tb, ns, 2, smem) &&\n"
             "      !rows::plan(a, 1, reg, par, tb, ns, 2, smem))",
         "  if (!rows::plan(a, 1, reg, par, tb, ns, 2, smem))")]],
}

# K10 and K11 (K9 the control) at chip_smoke.py's K7_SHAPES, built from
# swin_chain.cu alone: CUDA events, mean of 10 after 2 warm-ups, twice
CHAIN_TIME = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
""" + ONE_SOURCE.format(sources=("swin_chain.cu",)) + r"""
from hdrvae_torch.core.config import Precision
from hdrvae_torch.kernels import swin_attention as ska
from hdrvae_torch.models.swinir import block_weights
fast = Precision.fast()
rng = np.random.default_rng(0)
cases = []
for name, h, w, ws, shift, extra in cs.K7_SHAPES:
    blk = cs._swin_block(rng, cs.SWIN_DIM, cs.SWIN_HEADS, ws)
    wts = block_weights(blk, cs.SWIN_HEADS, ws, torch.bfloat16)
    x = cs._bf16(rng, (1, h, w, cs.SWIN_DIM))
    e = cs._bf16(rng, (1, h, w, cs.SWIN_DIM), 0.5) if extra else None
    qkv = ska.ln_qkv(x, wts, ws=ws, precision=fast)
    kw = dict(heads=cs.SWIN_HEADS, ws=ws, shift=shift,
              grid=(h // ws, w // ws))
    o = ska.window_attention_core(qkv, wts.bias, **kw)
    cases.append((f"{name} {h}x{w} ws {ws} shift {shift}", {
        "K10": lambda x=x, wts=wts, ws=ws: ska.ln_qkv(x, wts, ws=ws,
                                                      precision=fast),
        "K9": lambda qkv=qkv, wts=wts, kw=kw: ska.window_attention_core(
            qkv, wts.bias, **kw),
        "K11": lambda o=o, x=x, wts=wts, ws=ws, e=e: ska.proj_mlp(
            o, x, wts, ws=ws, extra=e, precision=fast)}))
for _ in range(2):
    total = {"K10": 0.0, "K9": 0.0, "K11": 0.0}
    for label, fns in cases:
        for k, fn in fns.items():
            t = cs.cuda_ms(fn, iters=10)
            total[k] += t
            print(f"  {k} {label}: {t:.3f} ms", flush=True)
    for k, t in total.items():
        print(f"  {k} over K7_SHAPES: {t:.3f} ms", flush=True)
"""

# --time-k12: variant -> alternatives, as for --time-k4
FD = "f32_dot.cu"
K12_VARIANTS = {
    "as-is": [[]],
    "no-x-loads": [[
        (FD, "    hopper::mbar_expect_tx(bar, XB);\n"
             "    hopper::tma_load_2d(base + L::X + (c % NCH) * XB, &xmap, bar, c * BK, m0);",
         "    hopper::mbar_arrive(bar);")]],
    "no-w-loads": [[
        (FD, "    hopper::mbar_expect_tx(bar, L::NP * wrows * BK * 2);\n#pragma unroll\n"
             "    for (int p = 0; p < L::NP; ++p)",
         "    hopper::mbar_arrive(bar);\n#pragma unroll\n    for (int p = 0; p < 0; ++p)")]],
    "no-loads": [[
        (FD, "    hopper::mbar_expect_tx(bar, XB);\n"
             "    hopper::tma_load_2d(base + L::X + (c % NCH) * XB, &xmap, bar, c * BK, m0);",
         "    hopper::mbar_arrive(bar);"),
        (FD, "    hopper::mbar_expect_tx(bar, L::NP * wrows * BK * 2);\n#pragma unroll\n"
             "    for (int p = 0; p < L::NP; ++p)",
         "    hopper::mbar_arrive(bar);\n#pragma unroll\n    for (int p = 0; p < 0; ++p)")]],
    "no-split": [[
        (FD, "    for (int q = 0; q < 4; ++q) {\n      const int e = tid + NT * q;",
         "    for (int q = 0; q < 0; ++q) {\n      const int e = tid + NT * q;")]],
    "no-products": [[
        (FD, "    for (int ks = 0; ks < BK / 16; ++ks) {",
         "    for (int ks = 0; ks < 0; ++ks) {")]],
    "no-stores": [[
        (FD, "    for (int bx = 0; bx < BN / 32 && n0 + 32 * bx < N; ++bx)",
         "    for (int bx = 0; bx < 0; ++bx)")]],
    # the tensor-core kernel launched after the split as a plain launch
    "no-pdl": [[
        (FD, "  pdl[0].val.programmaticStreamSerializationAllowed = 1;",
         "  pdl[0].val.programmaticStreamSerializationAllowed = 0;")]],
    # highest: 16 outputs a thread along N (128 threads, one warp an SM
    # sub-partition), fewer shared loads an FFMA
    "ffma-tn16": [[
        (FD, "constexpr int TN = 8;        // outputs a thread along N (8 along M)",
         "constexpr int TN = 16;        // outputs a thread along N (8 along M)")]],
    # highest: 16-deep slices through four stages
    "ffma-bk16": [[
        (FD, "constexpr int BK = 32;              // k slice",
         "constexpr int BK = 16;              // k slice"),
        (FD, "constexpr int NS = 3;        // ring stages",
         "constexpr int NS = 4;        // ring stages")]],
    # highest: an eighth of the FFMAs (every shared load still feeds one)
    "ffma-eighth": [[
        (FD, "        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);",
         "        acc[i][i] = fmaf(av, bv[i], acc[i][i]);")]],
    # highest: no cp.async copies (the FFMAs run on stale slices)
    "ffma-no-loads": [[
        (FD, "    if (s < nk) load(smem, x, w, M, N, K, m0, n0, s);",
         "    if (s < 0) load(smem, x, w, M, N, K, m0, n0, s);"),
        (FD, "    if (kt + NS - 1 < nk) load(smem, x, w, M, N, K, m0, n0, kt + NS - 1);",
         "    if (kt < 0) load(smem, x, w, M, N, K, m0, n0, kt + NS - 1);")]],
}

# K12 through the probe's measurement, built from f32_dot.cu alone
K12_TIME = r"""
import importlib.util
import json
import sys
sys.path.insert(0, ".")
""" + ONE_SOURCE.format(sources=("f32_dot.cu",)) + r"""
spec = importlib.util.spec_from_file_location("probe", PROBE)
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
rows = probe.measure()
for mode, r in rows["modes"].items():
    parts = [f"{k} {r[k] * 1e3:.2f} us" for k in ("ms", "split_ms", "main_ms")
             if k in r]
    print(f"  K12 {mode}: " + ", ".join(parts)
          + f"; vs float64 {r['rel_vs_exact']:.3e}", flush=True)
for name, r in rows["library"].items():
    print(f"  {name}: {r['ms'] * 1e3:.2f} us", flush=True)
""".replace("PROBE", repr(os.path.join(REPO, "tools",
                                      "f32_dot_probe_torch.py")))

# the timing modes: flag -> (CUDA source, variants, timing script)
TIMINGS = {"--time-k6": ("dense_conv.cu", K6_VARIANTS, K6_TIME),
           "--time-k3": ("attention.cu", K3_VARIANTS, K3_TIME),
           "--time-k3-f32": ("attention.cu", K3F_VARIANTS, K3F_TIME),
           "--time-k3-3pass": (None, K3P_VARIANTS, K3P_TIME),
           "--time-k8": ("ocab.cu", K8_VARIANTS, K8_TIME),
           "--time-k7": (None, K7_VARIANTS, K7_TIME),
           "--time-k5": (None, K5_VARIANTS, K5_TIME),
           "--time-k4": (None, K4_VARIANTS, K4_TIME),
           "--time-k9": (None, K9_VARIANTS, K9_TIME),
           "--time-k10": (None, K10_VARIANTS, CHAIN_TIME),
           "--time-k11": (None, K11_VARIANTS, CHAIN_TIME),
           "--time-k12": (None, K12_VARIANTS, K12_TIME)}


@contextlib.contextmanager
def edited_copy(edits, root: str = REPO):
    """A temporary copy of ``hdrvae_torch/`` and ``chip_smoke.py`` of the
    tree at ``root`` with ``edits`` (CUDA source under csrc/, text,
    replacement) made: its directory, or None if a text is not in its
    source exactly once."""
    csrc = os.path.join(root, "hdrvae_torch", "csrc")
    srcs = {}
    for source, old, new in edits:
        if source not in srcs:
            srcs[source] = open(os.path.join(csrc, source)).read()
        if srcs[source].count(old) != 1:
            yield None
            return
        srcs[source] = srcs[source].replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, "hdrvae_torch"),
                        os.path.join(tmp, "hdrvae_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
        for source, src in srcs.items():
            with open(os.path.join(tmp, "hdrvae_torch", "csrc", source),
                      "w") as f:
                f.write(src)
        yield tmp


def _applies(edits, root: str) -> bool:
    """Whether every (source, text, replacement) of ``edits`` finds its
    text exactly once in the tree at ``root``."""
    csrc = os.path.join(root, "hdrvae_torch", "csrc")
    return all(open(os.path.join(csrc, source)).read().count(old) == 1
               for source, old, _ in edits)


def run_target(target: str) -> bool:
    """Every mutation of ``target``; True if each that must be caught
    was."""
    call, prefixes, mutations = TARGETS[target]
    ok = True
    for name, (source, text, broken, must_catch) in mutations.items():
        edits = (list(zip(text, broken)) if isinstance(text, tuple)
                 else [(text, broken)])
        with edited_copy([(source, o, n) for o, n in edits]) as tmp:
            if tmp is None:
                print(f"== {name}: {source} does not hold the mutated text "
                      "once", file=sys.stderr)
                return False
            build = (ONE_SOURCE.format(sources=ONE_SOURCE_TARGETS[target])
                     if target in ONE_SOURCE_TARGETS
                     else "chip_smoke.phase_build()")
            proc = subprocess.run(
                [sys.executable, "-c", CHECK.format(call=call, build=build)],
                cwd=tmp,
                capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(prefixes + ("CAUGHT", "SURVIVED"))]
        caught = proc.returncode == 0 and any(ln.startswith("CAUGHT")
                                              for ln in lines)
        print(f"== {target}, {name}: {'caught' if caught else 'not caught'}",
              *lines[-3:], sep="\n  ", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
        ok &= caught or not must_catch
    return ok


def time_variant(flag: str, variant: str, root: str = REPO) -> int:
    """One variant of ``flag``'s kernel in the tree at ``root`` timed; the
    subprocess's exit code."""
    source, variants, script = TIMINGS[flag]
    if source is None:   # alternatives of (source, text, replacement) edits
        edits = next((alt for alt in variants[variant]
                      if _applies(alt, root)), None)
    else:
        edits = [(source, o, n) for o, n in variants[variant]]
    with contextlib.ExitStack() as stack:
        tmp = None if edits is None else stack.enter_context(
            edited_copy(edits, root))
        if tmp is None:
            print(f"== {variant}: the kernel's sources do not hold the "
                  "edited text once", file=sys.stderr)
            return 1
        print(f"== {variant}", flush=True)
        proc = subprocess.run([sys.executable, "-c", script], cwd=tmp,
                              capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-2000:], file=sys.stderr)
    return proc.returncode


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    root = REPO
    if "--tree" in args:   # time the kernels of another tree
        i = args.index("--tree")
        root = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    timing = args[0] if args and args[0] in TIMINGS else None
    known = TIMINGS[timing][1] if timing else TARGETS
    names = args[1:] if timing else args
    if not names and timing and TIMINGS[timing][0] is None:
        # the variants the tree's sources hold (an older tree's kernel has
        # its own)
        names = [n for n, alts in known.items()
                 if any(_applies(alt, root) for alt in alts)]
    names = names or list(known)
    unknown = set(names) - set(known)
    if unknown:
        print(f"unknown {'variants' if timing else 'targets'} "
              f"{sorted(unknown)}; expected {list(known)}", file=sys.stderr)
        return 2
    if timing:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
        return max(time_variant(timing, n, root) for n in names)
    results = [run_target(t) for t in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
