#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

No other set-up: the CUDA kernels are built from ``hdrvae_torch/csrc`` by
``nvcc`` on first use.  Phases, each of which raises on failure:

1. device: the card's name and power limit, as the line nvidia-smi prints;
2. build: compile the kernels, print the build time and ptxas' register
   and spill report, and the count of HGMMA (wgmma) instructions in the
   SASS of K1/K2's, K5's, K6's, K3 bf16's, K3 3-pass's, K8's and K7's
   kernels
   (``cuobjdump --dump-sass``), which must not be 0, with the registers
   and spills of K3's (per instance), K5's, K8's and K7's kernels;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (K1-K4: a 1024^2 decode, and K1 and K2
   each at one ragged shape of an 832 x 1216 frame, logged apart and out
   of the rows' sums, K2 also timed as the launch alone; K1 and K2 with
   ``owned_rows`` (K2 in both modes) at the same decode shapes over three
   intervals cut at odd rows, y bit-equal to the unrestricted launch's,
   each interval's sums against the plain version's and the three adding
   up to the unrestricted sums, timed beside the unrestricted launch; K3
   in its three
   dot modes, the 3-pass one also against exact float32 and at 65,536
   tokens (the 2048^2 decode's), its split (``split_qkv``) bit-equal to
   the split's plain version, the 3-pass and
   bf16 ones on a ragged input with peaked scores, the bf16 one also at
   batch 2 and C = 64, and each mode's key_valid mask (the bucketed
   phase's live 121 x 100 of 128 x 128, and a 32 x 32 grid whose first
   256 keys are dead), timed beside the unmasked kernel and SDPA with the
   mask; K2 also with act="lrelu", logged apart; K6:
   one 512^2 tile of the full-width ESRGAN x4 net, each shape once in the
   row's sums, with weights prepared as the chain passes them (and the
   HWIO call bit-equal), conv_body and conv_first of unshuffle 2 and 4
   logged apart, and an estimate of K6's time in one tile forward (each
   shape's time alone times its 351 launches there) beside cuDNN's conv
   alone; K7: one 512^2 tile of SwinIR-M,
   unshifted and shifted, of HAT-M with its CAB residual, and a ragged
   128 x 120 tile, within two bf16 ulps of its largest output over the
   image and over its last window row and column; K7's SwinV2 body: one
   512^2 tile of Swin2SR-M, unshifted and shifted, a window-7 grid and
   the ragged tile, within 5e-2 * max(1, max|ref|); K8: HAT-M's
   OCAB on a 512^2 tile, also with a peaked bias, and a ragged 20 x 36
   shape, each within two bf16 ulps of its largest output; K2's
   stats_only mode, its sums bit-equal to K2's with y written, and K5:
   the 2048^2 decode's top-level junction and a ragged map, with cuDNN's
   two convs alone (the up-conv on the materialized 2x map, then conv1)
   as its library column; the staged
   Swin chain's K10, K9 and K11 at K7's v1 shapes, each on the previous
   kernel's output and each output in a block that held NaNs, with
   cuBLAS's products alone as K10's and K11's yardstick, the three on
   CHAIN_RAGGED's ragged windows (ws 7, 10, 12; padded rows zero), and
   the chain against K7 on the same inputs and weights; K12 at the
   probe's 8192 x 256 x 256 in its three precisions, each call launching
   w's split (``split_w``, bit-equal to its plain version) once in high
   and default and never in highest), with its
   tolerance, and both timed with CUDA events after a warm-up; beside
   them the least time the card could take (bound_ms: the function's
   operations over the peak rate of their type, or its bytes, each input
   read once and each output written once, over the memory rate,
   whichever is larger) and, where one PyTorch call
   computes the same function, that call's time (library_ms; the port
   never calls it); K8's bound also counts its exponentials, one a score,
   at the MUFU's rate;
4. decode: the full-width Flux.1 decoder (random weights from a numpy
   seed), written to a safetensors file and read back by ``load_decoder``
   bit for bit, on a [1, 128, 128, 16] latent through ``hdr_decode`` +
   ``decode_summary`` in the fast, parity and mixed tiers, three requests
   each (the first warms cuDNN up), each tier launching its own attention
   kernel (bf16, exact float32, 3-pass) and no other; fast is held against
   the unfused fast path (upstack "xla"), mixed against parity; one mixed
   decode with ``fast_head_levels=2`` (its head's attention the bf16
   kernel) held to parity at the fast tier's budget; then one fast and
   one parity decode with the fused epilogue (K4) held to the default
   path's; then the epilogue in all four modes on one decoder output;
4b. serve: the same decoder through a ``VAE`` handle and ``ServeEngine``:
   a fast engine (depth 2, bucket 64) takes six [1, 128, 128, 16]
   latents (at their bucket: the K1 / K2 / K3 chain; three with the fused
   epilogue, K4) and two [1, 121, 100, 16] ones (padded: K3 bf16 masked)
   from two client threads, a mixed engine two 1024^2 latents (K3 3-pass,
   ``split_qkv``), each response bit-equal to the direct ``hdr_decode`` +
   ``decode_summary`` of its latent on its route and the launches counted;
   the six fast requests at depth 1 and 2 (latency p50 / p95, MP/s); a
   512^2 request with a 2048^2 one submitted behind it, whose latency must
   stay under half the 2048^2 decode's device ms (its fetch does not wait
   for the next decode); the HTTP front end (32-bit and 16-bit EXR
   responses read back, ``/healthz`` naming the card); and
   ``export_linear`` of a served image as a 32-bit zip EXR with
   ``verify_save``, with its seconds;
4c. front end (its own limit, 60 s): ``cli decode --size 2048`` (fast,
   random weights from seed 0, a 16-bit PIZ EXR through the streamed
   export), the file bit-equal to the direct decode's float16 cast and the
   launches the direct decode's; the streamed export against the serial
   ``export_linear`` of the same frame, in turns, byte-identical; the
   1024^2 image in none, rle, zip, piz and pxr24 at 16 and 32 bits, each
   read back bit-exact, with its bytes and seconds; ``cli run`` of
   ``workflow_examples/hdr_decode_export.json`` at 1024^2 (a full-width
   ESRGAN x4 checkpoint from numpy seed 2) against the same three nodes
   called directly: the same EXR, the same launches, the upscale equal to
   ``hdr_upscale``'s; ``cli upscale --precision fast`` (K6) against the
   direct fast upscale;
5. bucketed decode: the same decoder on a [1, 121, 100, 16] latent (seed
   7) padded to its (128, 128) bucket (``BucketPolicy((64, 96, 128))``)
   through ``hdr_decode(pad_to=)`` in each tier, each launching its
   tier's attention kernel once with ``key_valid`` (and no fused chain),
   held to the unbucketed decode of the same latent on the same route
   (fast: upstack "xla"), its output [1, 968, 800, 3] and its input
   statistics those of the unpadded latent;
6. large frames: fast decodes at 2048^2 and 4096^2 with the whole-image
   and the streamed top level (``LOWMEM_MIN_PIXELS`` set in-process), the
   streamed one launching K5 and K2 stats_only once a request and the
   whole-image one neither, held to each other (and at 2048^2 to the
   unfused fast path); a mixed 2048^2 decode through the staged executor
   (its route forced by the test hook) held to the whole-image one; and
   one mixed request that ``hdr_decode`` routes to the staged executor by
   itself, at the smallest latent side whose frame reaches
   ``STAGED_MIN_PIXELS``, its mid attention one 3-pass launch; each with
   its time and peak memory;
7. slab-sharded decode: the port's launcher (``sharding/multihost.py``)
   starts two ranks on the one card (gloo), each decoding the 2048^2 latent
   with ``sharded_slab_decode`` (``tail_levels=2``) in the fast tier on the
   chain (K1 / K2 with ``owned_rows``, K3 bf16) and in the mixed tier on the
   layers (K3 3-pass); every rank's image the same, held to the
   large-frame phase's whole-image decode of its tier, each rank's device
   ms and peak printed (two ranks on one card: no multi-GPU speedup);
7b. tile grid across ranks (its own limit, TILED_BUDGET_S): the
   2048^2 latent through ``sharded_tiled_decode`` (tile 64, overlap 8, the
   fused epilogue), fast ``per_tile`` (the K1 / K2 / K3 bf16 chain and K4
   per tile) and ``global`` (a GroupNorm tape collected on rank 0 and
   broadcast; the layers with K3 bf16, and K4) on two gloo ranks sharing
   the card and on one NCCL rank, mixed ``global`` on the two ranks; every
   rank's image the same, one rank against two, each against the
   large-frame phase's whole-image decode of its tier (the seam error's
   mean and p99.9 inside TILED_SEAM's bands; global below per_tile), each
   rank's device ms beside the whole-image decode's and a profiled fast
   request's top-5 kernels per rank; the fast x4 ESRGAN and SwinIR-M
   ``sharded_hdr_upscale`` of the 1024^2 image on the two ranks bit-equal
   to ``hdr_upscale`` in this process (K6, K7); ``cli decode --tiled
   --mesh 2 --size 2048`` and ``cli upscale --sharded`` (one rank a card,
   its file bit-equal to ``hdr_upscale``'s float16) in phase 4c's style,
   with the ranks' launches from the CLI's log;
7c. serving across ranks (its own limit, SERVE_RANKS_BUDGET_S):
   ``ServeEngine(mesh=)`` on rank 0 of two gloo ranks sharing the card
   (``multihost.ServeCase``: two client threads; the other rank in
   ``serve.ranks.follow``), the full-width decoder: a fast engine without
   a bucket on four 2048^2 latents (the chain: K1 / K2 owned_rows, K3
   bf16), a fast engine with bucket 64 on two [1, 121, 100, 16] latents
   (pad_to: the layers, K3 bf16 masked), a mixed engine on two 1024^2
   latents (K3 3-pass, split_qkv); each response bit-equal to the same
   ranks' direct ``sharded_slab_decode`` of its latent (earlier in the
   same job) and within SLAB_FAST / SLAB_MIXED of the whole-image decode
   of its tier, each engine's launches checked on every rank; one fast
   2048^2 slab request profiled on each rank (kernel rows, top 5, all
   kernels' ms and the collectives' host ms against the request's); one
   NCCL rank serving two fast 2048^2 requests (the worker thread's
   collectives on NCCL); ``cli serve --sharded --mesh 2`` as a
   subprocess: a 2048^2 32-bit EXR response equal to the fast engine's
   image, ``/healthz`` with two devices, SIGTERM, exit 0 and no rank
   left; each engine's latency p50 / p95, MP/s and overhead over the
   direct slab call beside phase 4b's one-rank engine;
8. EXR: the parity image written as a 32-bit EXR and read back bit-exact;
9. upscale: the full-width ESRGAN x4 (RRDBNet, random weights from a numpy
   seed) through ``hdr_upscale`` on the parity image, 1024^2 -> 4096^2 in
   512^2 tiles (9 tiles x 2 passes): two fast requests and one parity
   request, the fused K6 chain held to the unfused fast layers on one
   tile, one tile forward measured (K6's 351 launches counted, their
   device time from ``torch.profiler``), and one fast request with
   small_blur and local_fix;
10. SwinIR, HAT and Swin2SR upscale: the full-width SwinIR-M x4, HAT-M x4
   and Swin2SR-M x4 (random weights from numpy seeds) through
   ``hdr_upscale`` on a 768^2 crop of the parity image (4 tiles x 2
   passes), one fast and one parity request each; the fast one must
   launch K7 (Swin2SR: its v2 body) once per block and K8 once per OCAB
   of every tile run, the parity one neither; the fused chain is held to
   the unfused fast layers on the first tile's raw output;
10b. Compact, SPAN and RealPLKSR upscale: the full-width Compact x4
   (``SRVGGConfig()``), SPAN x4 (``SPANConfig()``, official Conv3XC keys)
   and RealPLKSR x4 (``RealPLKSRConfig()``, PixelShuffle and DySample
   heads), random weights from numpy seeds, each written to a temporary
   .pth and loaded by ``load_upscale_model`` on the card, through
   ``hdr_upscale`` on a 512^2 crop of the parity image (1 tile x 2
   passes): two fast and two parity requests each (cold, warm), every
   output finite and of its shape, no hand-written kernel launched (they
   run on the layers); device ms, peak, the raw forward's activation
   bytes per input pixel and fast vs parity printed;
11. Swin chain: the body of the full-width SwinIR-M (seed 3) on one 512^2
   tile of the decoded image, walked twice, each block through the staged
   chain (K10 -> K9 -> K11, 36 launches each), then through K7 (36), each
   group's conv + residual after its blocks; the two bodies held to each
   other, and both walks timed;
12. f32 dot probe: ``tools/f32_dot_probe_torch.py``'s measurement, K12's
   main path: each precision's time (high and default also the split and
   the tensor-core kernel apart) and error against a float64 product,
   held to its class, beside ``torch.matmul`` in float32 (TF32 off and on)
   and bf16;
13. launch counts: K1, K2 and K3 bf16 ran in the fast decode, K1 and K2
   with owned_rows in the fast slab decode, K3's 3-pass
   mode in mixed (and ``split_qkv`` once a 3-pass launch, in no other
   tier), K3 f32 in parity, each of the three masked in its
   tier's bucketed decode, K4 in the fused-epilogue decodes, K5
   and K2 stats_only in the
   low-memory fast 2048^2 decode, K6 in the fast ESRGAN upscale, K7 in the
   fast SwinIR and HAT upscales, its v2 body in the fast Swin2SR upscale,
   K8 in the fast HAT upscale, K9-K11 in the Swin chain phase, K12 and
   its split in the probe; every kernel of the table ran (phases 7b and 7c
   check their ranks' counts themselves: K1 / K2 / K3 bf16 / K4 in the
   fast per_tile tiled decodes, K6 and K7 in the sharded upscales; K1 /
   K2 owned_rows and K3 in each served tier on every rank).

The last two lines of standard output are a JSON object describing each
kernel and the JSON result ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, the script exits
non-zero before printing a result.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
# them, HBM3
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12
# exponentials (ex2 on the SM's MUFU unit): 16 a clock an SM (sm_90), 132
# SMs, at the 1.83 GHz that the bf16 peak above implies (989e12 / (132 x
# 4096 operations a clock))
PEAK_EX2 = 16 * 132 * 1.83e9

# 1024^2 decode shapes (latent 128^2): (H, W, Cin, Cout, residual) of the
# ResNet conv2s, which carry every fused part (prologue, residual, stats)
K1_SHAPES = [(128, 128, 512, 512, "add"), (256, 256, 512, 512, "add"),
             (512, 512, 256, 256, "add"), (512, 512, 512, 256, "proj"),
             (1024, 1024, 256, 128, "proj"),
             (1024, 1024, 128, 128, "add")]
# (H, W, C) of the low-resolution input of each upsample conv
K2_SHAPES = [(128, 128, 512), (256, 256, 512), (512, 512, 256)]
# one ragged shape each from an 832 x 1216 Flux frame (latent 152 x 104,
# W x 8 = 832): widths 104 and 208 are no multiple of K1/K2's 64-pixel
# tile; checked and logged on their own, out of the rows' sums
K1_RAGGED = (152, 104, 512, 512, "add")
K2_RAGGED = (304, 208, 512)
# K2 with act="lrelu" (no decode path takes it), logged apart
K2_ACT = (256, 256, 512)
N_TOKENS, C_ATTN = 128 * 128, 512
ATTN_FLOPS = 4 * N_TOKENS * N_TOKENS * C_ATTN   # q k^T and p v, one pass
# K3's 3-pass mode on a second input: ragged N (100 x 100 = 10,000 tokens,
# no multiple of the 64 queries or 32 keys of a step) with q scaled by 8,
# so the scores have std ~8 and the softmax is peaked: there the order of
# the scale and the split (2^-16 of each score) reaches the output
K3_SHARP_HW, K3_SHARP_QSCALE = 100, 8.0
# K3's 3-pass mode also at the 2048^2 decode's mid attention: 256 x 256 =
# 65,536 tokens, C = C_ATTN
K3_LONG_HW = 256
# K3 bf16 also at batch 2, C = 64 and ragged N (33 x 47 = 1,551 tokens, no
# multiple of its 64-key steps): one 64-column box a consumer warpgroup, so
# the second multiplies a zero box; [B, H, W, C]
K3_BATCH2 = (2, 33, 47, 64)
# K6 at one 512^2 tile of the x4 net: (name, H, W, input widths, Cout,
# act, residual scale or None, float32 out)
K6_SHAPES = [("conv_first", 512, 512, (3,), 64, None, None, False)] + [
    (f"conv{i}", 512, 512, (64,) + (32,) * (i - 1), 32, "lrelu", None, False)
    for i in range(1, 5)] + [
    ("conv5", 512, 512, (64, 32, 32, 32, 32), 64, None, 0.2, False),
    ("conv_up1", 1024, 1024, (64,), 64, "lrelu", None, False),
    ("conv_up2", 2048, 2048, (64,), 64, "lrelu", None, False),
    ("conv_last", 2048, 2048, (64,), 3, None, None, True),
    ("conv5 ragged", 128, 120, (64, 32, 32, 32, 32), 64, None, 0.2, False)]
# more K6 shapes, checked and logged apart, out of the row's sums: the
# tile's conv_body, and conv_first of RealESRGAN x2 / x1 (unshuffle 2 and
# 4: 12 and 48 channels at the unshuffled tile)
K6_EXTRA = [("conv_body", 512, 512, (64,), 64, None, 1.0, False),
            ("conv_first x2", 256, 256, (12,), 64, None, None, False),
            ("conv_first x1", 128, 128, (48,), 64, None, None, False)]
# launches of each shape in one RRDBNetConfig() tile forward (351): 23
# RRDBs of three dense blocks, conv_hr at conv_up2's shape
K6_FORWARD = {"conv_first": 1, "conv1": 69, "conv2": 69, "conv3": 69,
              "conv4": 69, "conv5": 69, "conv_body": 1, "conv_up1": 1,
              "conv_up2": 2, "conv_last": 1}
K4_SHAPE = (1, 1024, 1024, 128)
# K4's other maps, checked in both dtypes and not timed: (shape, kind) of a
# ragged M (no multiple of a warp's 32-row chunk) whose |mean| >> std (1e3
# + unit spread: bf16's step there is 4, so the spread survives), a ragged
# row ramp whose largest values lie in the last
# rows (the last partial), C = 20 (its thirds inside 16- and 8-byte
# vectors) and C = 3 (the identity collapse, 2-byte bf16 vectors)
K4_EXTRA = [((1, 37, 53, 128), "offset"), ((1, 41, 47, 128), "ramp"),
            ((1, 33, 31, 20), "spread"), ((2, 9, 7, 3), "spread")]
# K7 at the full widths of SwinIR-M and HAT-M (C 180, 6 heads, hd 30):
# (name, H, W, window, shift, with HAT's extra residual)
SWIN_DIM, SWIN_HEADS = 180, 6
K7_SHAPES = [("SwinIR-M", 512, 512, 8, 0, False),
             ("SwinIR-M", 512, 512, 8, 4, False),
             ("HAT-M", 512, 512, 16, 8, True),
             ("ragged", 128, 120, 8, 4, False)]
# K7's SwinV2 body at Swin2SR-M's widths: its 512^2 tile, a window-7 grid
# (49 tokens padded to 64 rows; the JPEG-CAR family's window) and the
# ragged tile
K7_V2_SHAPES = [("Swin2SR-M", 512, 512, 8, 0, False),
                ("Swin2SR-M", 512, 512, 8, 4, False),
                ("window 7", 504, 504, 7, 3, False),
                ("ragged", 128, 120, 8, 4, False)]
# K8 at HAT-M's 512^2-tile OCAB: (windows, heads, queries, keys); a ragged
# shape whose token counts the wrapper pads to 16; the peaked input's bias
# scale (one key a row dominates: exp(-16 x the gap to the row's second
# largest bias) weighs the rest)
K8_SHAPE = (1024, 6, 256, 576)
K8_RAGGED = (64, 6, 20, 36)
K8_PEAK = 16.0
SWIN_BUDGET = 5e-2          # relative to max(1, max|ref|): K7, fused chains
SWIN_CROP = 768             # the SwinIR / HAT upscale input: 4 tiles a pass
ZOO_CROP = 512              # the conv families' upscale input: 1 tile a pass
K4_BUDGET = 1e-5            # relative, on mean and std
# The chain's kernels on windows whose rows are no multiple of 64, checked
# and not timed: (name, H, W, window, shift, with HAT's extra residual):
# ws 7 (49 tokens in 64 rows, window rows no 16-byte multiple), ws 10 (n16
# 112, two row blocks, the last ragged) and ws 12 (n16 144, three),
# shifted
CHAIN_RAGGED = [("window 7", 112, 98, 7, 3, True),
                ("window 10", 120, 150, 10, 5, False),
                ("window 12", 144, 96, 12, 6, True)]
FUSED_EPI_BUDGET = 1e-5     # image max-abs and summary relative

FRONTEND_BUDGET_S = 60.0    # phase 4c's own time limit
FRONTEND_DECODE_EDGE = 2048  # phase 4c: cli decode's --size
FRONTEND_RUN_EDGE = 1024     # phase 4c: cli run's --size
CONV_BUDGET = 5e-2          # the decoder chain's bf16 budget (y, max-abs)
STATS_BUDGET = 1e-3         # relative, on the emitted GroupNorm sums
# K1 / K2 owned_rows: three intervals' sums against the whole map's, the
# same float32 values summed in other groupings (a row dropped or counted
# twice moves them by ~1e-3 at these shapes)
OWNED_PARTITION = 1e-5
# the slab phase: ranks on the one card; slab vs whole-image budgets, fast
# rgb relative to max(1, max|ref|), mixed (rgb, conservative image) max-abs
SLAB_RANKS = 2
SLAB_FAST = 5e-2
SLAB_MIXED = (1e-4, 1e-3)
# the tiled phase: its own time limit (1.5x its 122.3 s on the card's
# first run, one H100 80GB HBM3 at 700 W), ranks sharing the card (and one
# NCCL rank), the tile grid in latent pixels (512-pixel tiles, a 64-pixel
# halo)
TILED_BUDGET_S = 180.0
TILED_RANKS = 2
TILED_TILE, TILED_OVERLAP = 64, 8
# the tiled decode's seam error against the whole-image decode of its tier
# (rgb, 2048^2, seed-made weights and latent): (mean, p99.9) as both card
# runs read them (H100 80GB HBM3, 700 W), each held inside [1/2, 2] x of
# its reading: a wrong stitch or tape replay moves it out
TILED_SEAM = {"fast per_tile": (6.5776e-3, 3.5156e-2),
              "fast global": (2.6611e-3, 1.5625e-2),
              "mixed global": (9.0786e-4, 1.4038e-2)}
TILED_SEAM_BAND = 2.0
# the served slab decode across ranks: its own time limit, ranks sharing
# the card
SERVE_RANKS_BUDGET_S = 120.0
SERVE_RANKS = 2
ATTN_BUDGET = {"parity": 1e-5, "mixed": 1e-4}
# K3's key_valid mode at K3's N = 16,384 (a 128 x 128 grid): the live
# region of the bucketed phase's latent, 121 x 100 of its 128 x 128 bucket;
# and a small grid whose first key steps are all dead in every mode (the
# first 256 keys of 32 x 32)
K3_LIVE = (121, 100)
K3_DEAD_HW, K3_DEAD_KEYS = 32, 256
# the bucketed phase: a [1, 121, 100, 16] latent (seed 7) snapped to its
# bucket by BucketPolicy(BUCKET_EDGES), decoded bucketed and unbucketed;
# rgb (and image) max-abs budgets per tier, the fast one relative to
# max(1, max|ref|)
BUCKET_LATENT, BUCKET_EDGES = (121, 100), (64, 96, 128)
BUCKET_BUDGET = {"parity": (1e-4, 1e-4), "mixed": (1e-4, 1e-3),
                 "fast": (5e-2, None)}
# K3's 3-pass kernel against its plain version, relative to max|ref|: both
# take the same bf16 products, so they differ by float32 sum order and by
# where P is split (the kernel against the running row max, the plain
# version against the final one), each p's hi + lo off by up to 2^-16 of p
K3_3PASS_REL = 2.0 ** -16

# K5 at the 2048^2 decode's junction and at a ragged map: (H, W) of the
# low-resolution x [1, H, W, 256] -> y [1, 2H, 2W, 128], middle width 256
K5_SHAPES = [(1024, 1024), (36, 60)]
K5_CIN, K5_CM, K5_COUT = 256, 256, 128
# K2 stats_only at the same junction: x [1, 1024, 1024, 256]
K2_STATS_SHAPE = (1024, 1024, 256)
# the large-frame phase: staged vs whole-image mixed budgets (rgb and the
# conservative image max-abs, the pre-map statistics relative)
STAGED_RGB, STAGED_CONS, STAGED_PRE = 1e-4, 1e-3, 1e-4
# the auto-routed staged 3968^2 mixed request when its mid attention ran
# the exact float32 kernel: device ms and peak GiB on one H100 80GB HBM3 at
# 700 W, as PERF.md records them; printed beside this run's
F32_AUTO_ROUTED = (13897.0, 13.500)
# K12 at the probe's shape (M, K, N): each precision against its plain
# version (float32 sums in another order), and its class against a
# float64 product, relative to max|exact|; bf16 passes a precision makes
K12_SHAPE = (8192, 256, 256)
K12_BUDGET = 1e-5
K12_CLASSES = {"highest": 1e-5, "high": 1e-4, "default": 2e-2}
K12_PASSES = {"highest": 1, "high": 3, "default": 1}


def bf16_ulp(t: torch.Tensor) -> float:
    """One bf16 ulp of the largest |value| of ``t``: the bf16 attention's
    bound.  The kernel rounds each probability to bf16 (2^-9 relative) for
    its product with v; those errors take both signs and average down over
    the N keys, so the output stays inside one ulp of its largest value."""
    return 2.0 ** (np.floor(np.log2(t.float().abs().max().item())) - 7)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def stats_err(got, ref, y) -> float:
    """Largest relative error of the emitted (sum, sumsq); the signed sum
    relative to the group's sum of |y| (a signed sum may cancel)."""
    g = ref[0].shape[-1]
    b, h, w, c = y.shape
    abs_sum = y.float().abs().reshape(b, h * w, g, c // g).sum(dim=(1, 3))
    e_sum = ((got[0] - ref[0]).abs() / abs_sum).max().item()
    e_sq = ((got[1] - ref[1]).abs() / ref[1].abs()).max().item()
    return max(e_sum, e_sq)


def flat_numbers(tree, prefix=""):
    """(dotted key, number) of every leaf of a nested summary dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_numbers(v, f"{prefix}{k}.")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield f"{prefix}{k}", float(v)


def summary_rel_err(got: dict, ref: dict) -> float:
    """Largest |got - ref| / max(|ref|, 1e-6) over the summary's
    numbers."""
    ref_n = dict(flat_numbers(ref))
    return max(abs(v - ref_n[k]) / max(abs(ref_n[k]), 1e-6)
               for k, v in flat_numbers(got))


def p999(d: torch.Tensor) -> float:
    """The 99.9th percentile of a tensor's values (kthvalue: quantile
    refuses tensors this large)."""
    flat = d.flatten().float()
    return flat.kthvalue(max(1, int(np.ceil(0.999 * flat.numel())))
                         ).values.item()


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


class Bound:
    """The least time the card could take for a kernel's work, summed over
    its shapes: per shape the larger of its operations over the peak rate
    of their type and its bytes over the memory rate.  Operations of two
    types (products and exponentials) run on different units, so the
    slower of the two sets the operations' time."""

    def __init__(self):
        self.ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, flops: float, nbytes_: float,
            peak: float = PEAK_BF16, exps: float = 0.0) -> dict:
        t_ops = max(1e3 * flops / peak, 1e3 * exps / PEAK_EX2)
        t_bytes = 1e3 * nbytes_ / HBM_BYTES_S
        self.ms += max(t_ops, t_bytes)
        self.ops_ms += t_ops
        self.bytes_ms += t_bytes
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def entry(self) -> dict:
        return {"bound_ms": self.ms, "bound_by": "operations"
                if self.ops_ms >= self.bytes_ms else "bytes"}


CONV_ALONE = "F.conv2d, bf16, channels_last (the conv alone)"


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            key_valid: torch.Tensor = None) -> float:
    """``F.scaled_dot_product_attention`` of the spatial attention's
    [1, h, w, C] q, k, v as one head of h w tokens; ``key_valid`` ([h, w]
    bool) as its boolean ``attn_mask`` over the keys."""
    q, k, v = (t.reshape(1, 1, -1, t.shape[-1]) for t in (q, k, v))
    mask = None if key_valid is None else key_valid.reshape(1, 1, 1, -1)
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters=3)


def conv_alone_ms(x: torch.Tensor, kern: torch.Tensor) -> float:
    """``F.conv2d`` of NHWC ``x`` with the HWIO ``kern`` (3x3, SAME) alone,
    bf16 and channels_last: the library's time for a kernel's conv."""
    xc = x.permute(0, 3, 1, 2)     # a contiguous NHWC tensor: channels_last
    wc = kern.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return cuda_ms(lambda: F.conv2d(xc, wc, padding=1))


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} memory "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.2f} "
        "GiB")
    return line


def phase_build() -> None:
    from hdrvae_torch.kernels import _build
    t0 = time.perf_counter()
    path, compiler_log = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(path, REPO)}")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())
    for name, kernel in (("K1/K2", "conv_wgmma_kernel"),
                         ("K5", "upconv_wgmma_kernel"),
                         ("K6", "dense_wgmma_kernel"),
                         ("K3 bf16", "flash_bf16_kernel"),
                         ("K3 3-pass", "flash_3pass_kernel"),
                         ("K8", "ocab_kernel"),
                         ("K7", "swin_block_kernel"),
                         ("K9", "attn_core_kernel"),
                         ("K10", "ln_qkv_kernel"),
                         ("K11", "proj_mlp_kernel")):
        n, funcs = hgmma_count(path, kernel)
        log(f"SASS: {n} HGMMA instructions in {name}'s {kernel} "
            f"({funcs} instances)")
        check(n > 0, f"{name}'s kernel issues no wgmma (no HGMMA in its "
              "SASS)")
    # K3 bf16's, f32's and 3-pass's registers and spills per C / 64
    # instance, K5's per Cout / 64, K8's, K7's per body and channel width,
    # K9's per key-tile count, K10's and K11's per channel width, K4's
    # per type and vector width, and any ptxas warning (a serialized wgmma
    # is one)
    for kernel in ("flash_bf16_kernel", "flash_f32_kernel",
                   "flash_3pass_kernel", "upconv_wgmma_kernel",
                   "ocab_kernel", "swin_block_kernel", "attn_core_kernel",
                   "ln_qkv_kernel", "proj_mlp_kernel",
                   "collapse_stats_kernel"):
        for inst, (regs, stores, loads) in ptxas_report(compiler_log,
                                                        kernel):
            log(f"ptxas: {inst}: {regs} registers, {stores} bytes spill "
                f"stores, {loads} bytes spill loads")
    for line in compiler_log.splitlines():
        if "warning" in line.lower() or "(C7" in line:
            log("  ptxas:", line.strip())


def ptxas_report(compiler_log: str, kernel: str) -> list:
    """[(instance, (registers, spill store bytes, spill load bytes))] of
    every instance of ``kernel`` in ``nvcc -Xptxas -v``'s log (empty when
    the library was reused, not built)."""
    rows, inst, spills = [], None, (0, 0)
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = m.group(1) if kernel in m.group(1) else None
            continue
        if inst is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            targs = re.findall(r"L[bi](\d+)E", inst)
            name = f"{kernel}<{', '.join(targs)}>" if targs else inst
            rows.append((name, (int(m.group(1)), *spills)))
            inst, spills = None, (0, 0)
    return rows


def hgmma_count(lib: str, kernel: str) -> tuple:
    """(HGMMA instructions, functions) in the SASS of every instance of
    ``kernel`` in the built library, from ``cuobjdump --dump-sass``."""
    import shutil
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    n, funcs, inside = 0, 0, False
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            funcs += inside
        elif inside and "HGMMA" in line:
            n += 1
    return n, funcs


def _bf16(rng, shape, scale=1.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).cuda().bfloat16()


def phase_kernels() -> list:
    from hdrvae_torch.kernels import attention
    rng = np.random.default_rng(0)
    entries = [_check_k1(rng), _check_k2(rng)]
    # K1 / K2 owned_rows: the bound and library time of the unrestricted
    # launch at the same shapes (the same work)
    for base, kind in zip(entries[:2], ("K1", "K2")):
        owned = _check_owned(np.random.default_rng(9), kind)
        owned.update({k: base[k] for k in ("bound_ms", "bound_by",
                                           "library_ms", "library_call")})
        entries.append(owned)

    # K3 ---------------------------------------------------------------
    q, k, v = _k3_inputs(rng)
    ref = attention.spatial_attention_reference(q, k, v)
    entries.append(_check_k3_f32(q, k, v, ref))
    entries += _check_k3_3pass(q, k, v, ref)
    entries.append(_check_k3_bf16(q, k, v))
    del q, k, v, ref
    torch.cuda.empty_cache()
    entries.append(_check_k4())
    entries.append(_check_k6(rng))
    entries.append(_check_k7(rng, K7_SHAPES))
    entries.append(_check_k7(rng, K7_V2_SHAPES, v2=True))
    entries.append(_check_k8(rng))
    rng5 = np.random.default_rng(5)
    entries.append(_check_k2_stats_only(rng5))
    entries.append(_check_k5(rng5))
    chain_entries, chain_ab = _check_chain(np.random.default_rng(6))
    entries += chain_entries
    entries += _check_k12()
    return entries, chain_ab


def _k1_inputs(rng, h, w, cin, cout, res):
    """K1's x, kernel, bias and keyword operands at one shape (GroupNorm
    prologue, statistics, an "add" or "proj" residual)."""
    dev = torch.device("cuda")
    x = _bf16(rng, (1, h, w, cin))
    kern = _bf16(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias = torch.from_numpy(rng.uniform(-0.1, 0.1, cout)
                            .astype(np.float32)).to(dev)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, (1, cin))
                             .astype(np.float32)).to(dev)
    beta = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, cin))
                            .astype(np.float32)).to(dev)
    kw = dict(gamma=gamma, beta=beta, emit_stats=True, num_groups=32)
    if res == "add":
        kw.update(residual=_bf16(rng, (1, h, w, cout), 0.5))
    else:
        kw.update(residual=x,
                  res_kernel=_bf16(rng, (cin, cout), cin ** -0.5))
    return x, kern, bias, kw


def _k1_case(rng, bnd, h, w, cin, cout, res):
    """K1 at one shape against its plain version, its bound added to
    ``bnd``: (log text, record)."""
    from hdrvae_torch.kernels import conv3x3
    x, kern, bias, kw = _k1_inputs(rng, h, w, cin, cout, res)
    gamma, beta = kw["gamma"], kw["beta"]
    y, s = conv3x3.fused_conv3x3(x, kern, bias, **kw)
    ry, rs = conv3x3.fused_conv3x3_reference(x, kern, bias, **kw)
    torch.cuda.synchronize()
    e = (y.float() - ry.float()).abs().max().item()
    es = stats_err(s, rs, ry)
    check(torch.isfinite(y.float()).all().item(), "K1 output not finite")
    check(e <= CONV_BUDGET, f"K1 {h}x{w} {cin}->{cout} {res}: "
          f"max-abs {e} > {CONV_BUDGET}")
    check(es <= STATS_BUDGET, f"K1 {h}x{w} stats rel err {es}")
    t = cuda_ms(lambda: conv3x3.fused_conv3x3(x, kern, bias, **kw))
    tp = cuda_ms(lambda: conv3x3.fused_conv3x3_reference(
        x, kern, bias, **kw))
    tl = conv_alone_ms(x, kern)
    flops = 2 * h * w * cin * cout * (9 + (res == "proj"))
    b = bnd.add(flops, nbytes(x, kern, bias, gamma, beta, y, *s,
                              None if res == "proj" else kw["residual"],
                              kw.get("res_kernel")))
    text = (f"{h}x{w} {cin}->{cout} {res}: max-abs {e:.3e} stats {es:.2e}  "
            f"kernel {t:.3f} ms ({flops / (t * 1e9):.1f} TFLOP/s)  plain "
            f"{tp:.3f} ms  conv alone {tl:.3f} ms  bound {b['bound_ms']:.3f}"
            f" ms ({b['bound_by']})")
    return text, {"shape": [h, w, cin, cout, res], "max_abs_err": e,
                  "stats_rel_err": es, "ms": t, "plain_ms": tp,
                  "library_ms": tl, "tflops": flops / (t * 1e9), **b}


def _check_k1(rng) -> dict:
    """K1 at the 1024^2 decode's six conv shapes (the row's sums) and at
    the ragged Flux shape (its own line, out of the sums)."""
    details, bnd = [], Bound()
    for shape in K1_SHAPES:
        text, rec = _k1_case(rng, bnd, *shape)
        log("K1 fused_conv3x3 " + text)
        details.append(rec)
    text, ragged = _k1_case(rng, Bound(), *K1_RAGGED)
    log("K1 fused_conv3x3 ragged (out of the sums) " + text)
    return {"name": "fused_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/conv3x3.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:333",
            "max_abs_err": max(d["max_abs_err"] for d in details),
            **_summed(details), **bnd.entry(), "library_call": CONV_ALONE,
            "shapes": details, "ragged": ragged}


def _k2_inputs(rng, h, w, c, act=None):
    """K2's x, kernel, bias and keyword operands at one shape."""
    x = _bf16(rng, (1, h, w, c), 0.5)
    kern = _bf16(rng, (3, 3, c, c), (9 * c) ** -0.5)
    bias = _uniform(rng, -0.1, 0.1, c)
    return x, kern, bias, dict(emit_stats=True, num_groups=32, act=act)


def _k2_case(rng, bnd, h, w, c, act=None):
    """K2 at one shape against its plain version, its bound added to
    ``bnd``: (log text, record).  Besides the wrapper's time (which
    collapses the kernel into phase kernels on every call) the launch
    alone, on phase kernels made beforehand."""
    from hdrvae_torch.kernels import _build, conv3x3
    x, kern, bias, kw = _k2_inputs(rng, h, w, c, act)
    y, s = conv3x3.upsample_conv3x3(x, kern, bias, **kw)
    ry, rs = conv3x3.upsample_conv3x3_reference(x, kern, bias, **kw)
    torch.cuda.synchronize()
    e = (y.float() - ry.float()).abs().max().item()
    es = stats_err(s, rs, ry)
    check(torch.isfinite(y.float()).all().item(), "K2 output not finite")
    check(e <= CONV_BUDGET, f"K2 {h}x{w} {c}: max-abs {e}")
    check(es <= STATS_BUDGET, f"K2 {h}x{w} stats rel err {es}")
    t = cuda_ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias, **kw))
    pk = conv3x3.phase_kernels(kern).contiguous()
    part = torch.empty(1, 4 * conv3x3.conv_tiles(h, w), 2, c,
                       device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    t_launch = cuda_ms(lambda: _build.check(lib.hdrvae_upsample_conv3x3(
        x.data_ptr(), pk.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr(), 1, h, w, c, c, int(act == "lrelu"), 0,
        conv3x3._ALL_ROWS, stream),
        "hdrvae_upsample_conv3x3"))
    tp = cuda_ms(lambda: conv3x3.upsample_conv3x3_reference(
        x, kern, bias, **kw))
    # the conv alone, on the upsampled map made beforehand
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    tl = conv_alone_ms(up, kern)
    del up
    # the phase-decomposed conv: four 2x2 taps per output pixel
    flops = 2 * (4 * h * w) * 4 * c * c
    b = bnd.add(flops, nbytes(x, kern, bias, y, *s))
    text = (f"{h}x{w}->{2 * h}x{2 * w} {c}: max-abs {e:.3e} stats "
            f"{es:.2e}  kernel {t:.3f} ms (the launch alone {t_launch:.3f} "
            f"ms, {flops / (t_launch * 1e9):.1f} TFLOP/s)  plain {tp:.3f} ms"
            f"  conv alone {tl:.3f} ms  bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']})")
    return text, {"shape": [h, w, c, c], "max_abs_err": e,
                  "stats_rel_err": es, "ms": t, "launch_ms": t_launch,
                  "plain_ms": tp, "library_ms": tl,
                  "tflops": flops / (t_launch * 1e9), **b}


def _check_k2(rng) -> dict:
    """K2 at the 1024^2 decode's three upsample convs (the row's sums) and
    at the ragged Flux shape (its own line, out of the sums)."""
    details, bnd = [], Bound()
    for shape in K2_SHAPES:
        text, rec = _k2_case(rng, bnd, *shape)
        log("K2 upsample_conv3x3 " + text)
        details.append(rec)
    text, ragged = _k2_case(rng, Bound(), *K2_RAGGED)
    log("K2 upsample_conv3x3 ragged (out of the sums) " + text)
    text, act = _k2_case(rng, Bound(), *K2_ACT, act="lrelu")
    log("K2 upsample_conv3x3 act=lrelu (out of the sums) " + text)
    return {"name": "upsample_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/conv3x3.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:653",
            "max_abs_err": max(d["max_abs_err"] for d in details),
            **_summed(details), **bnd.entry(),
            "launch_ms": sum(d["launch_ms"] for d in details),
            "library_call": CONV_ALONE + " (on the upsampled map)",
            "shapes": details, "ragged": ragged, "act": act}


def _owned_cuts(rows: int) -> list:
    """Three intervals that partition ``rows`` output rows, cut at odd rows:
    inside K1's 4-row tiles, and between K2's phase rows 2 i and 2 i + 1."""
    a, b = (rows // 3) | 1, (2 * rows // 3) | 1
    return [(0, a), (a, b), (b, rows)]


def _partition_err(parts, whole, y) -> float:
    """How far three intervals' (sum, sumsq) are from the whole map's: the
    signed sum relative to the group's sum of |y|, sumsq relative."""
    g = whole[0].shape[-1]
    b, h, w, c = y.shape
    abs_sum = y.float().abs().reshape(b, h * w, g, c // g).sum(dim=(1, 3))
    e_sum = ((sum(p[0] for p in parts) - whole[0]).abs() / abs_sum).max()
    e_sq = ((sum(p[1] for p in parts) - whole[1]).abs() / whole[1]).max()
    return max(e_sum.item(), e_sq.item())


def _check_owned(rng, kind: str) -> dict:
    """K1 or K2 (``kind``) with ``owned_rows`` at phase 3's decode shapes
    (K1_SHAPES, K2_SHAPES; K2 in both modes), over three intervals cut at
    odd output rows (``_owned_cuts``): y bit-equal to the unrestricted
    launch's, each interval's sums within STATS_BUDGET of the plain
    version's with the same owned_rows, the three intervals' sums adding
    up to the unrestricted sums within float32 reordering
    (OWNED_PARTITION), K2's stats_only sums bit-equal to its y mode's; the
    mode's time (the middle interval) beside the unrestricted launch's and
    the plain version's.  The caller adds the bound and the library time
    (the unrestricted entry's: the same work at the same shapes)."""
    from hdrvae_torch.kernels import conv3x3
    up = kind == "K2"
    fn = conv3x3.upsample_conv3x3 if up else conv3x3.fused_conv3x3
    plain = (conv3x3.upsample_conv3x3_reference if up
             else conv3x3.fused_conv3x3_reference)
    details = []
    for shape in (K2_SHAPES if up else K1_SHAPES):
        x, kern, bias, kw = (_k2_inputs(rng, *shape) if up
                             else _k1_inputs(rng, *shape))
        rows = 2 * shape[0] if up else shape[0]
        y, s = fn(x, kern, bias, **kw)
        parts, e_y, e_s = [], 0.0, 0.0
        for lo, hi in _owned_cuts(rows):
            yo, so = fn(x, kern, bias, owned_rows=(lo, hi), **kw)
            ry, rs = plain(x, kern, bias, owned_rows=(lo, hi), **kw)
            check(torch.equal(yo, y), f"{kind} owned_rows {(lo, hi)} at "
                  f"{shape}: y differs from the unrestricted launch's")
            if up:
                st = fn(x, kern, bias, owned_rows=(lo, hi), stats_only=True,
                        **kw)
                check(torch.equal(st[0], so[0]) and torch.equal(st[1], so[1]),
                      f"K2 stats_only owned_rows {(lo, hi)} at {shape}: "
                      "sums differ from the y mode's")
            e_y = max(e_y, (yo.float() - ry.float()).abs().max().item())
            e_s = max(e_s, stats_err(so, rs, ry[:, lo:hi]))
            parts.append(so)
            del ry
        e_p = _partition_err(parts, s, y)
        check(e_s <= STATS_BUDGET, f"{kind} owned_rows at {shape}: stats "
              f"rel err {e_s} > {STATS_BUDGET}")
        check(e_p <= OWNED_PARTITION, f"{kind} owned_rows at {shape}: three "
              f"intervals' sums off the whole map's by {e_p} > "
              f"{OWNED_PARTITION}")
        mid = _owned_cuts(rows)[1]
        t = cuda_ms(lambda: fn(x, kern, bias, owned_rows=mid, **kw))
        t_all = cuda_ms(lambda: fn(x, kern, bias, **kw))
        tp = cuda_ms(lambda: plain(x, kern, bias, owned_rows=mid, **kw))
        log(f"{kind} owned_rows {shape}: cuts {_owned_cuts(rows)} y "
            f"bit-equal to the unrestricted launch; max-abs vs plain "
            f"{e_y:.3e}  stats {e_s:.2e}  partition {e_p:.2e}  kernel "
            f"{t:.3f} ms (unrestricted {t_all:.3f} ms)  plain {tp:.3f} ms")
        details.append({"shape": list(shape), "max_abs_err": e_y,
                        "stats_rel_err": e_s, "partition_rel_err": e_p,
                        "ms": t, "unrestricted_ms": t_all, "plain_ms": tp})
        del x, y, s, parts
    torch.cuda.empty_cache()
    name = "upsample_conv3x3" if up else "fused_conv3x3"
    line = (":653 (owned_rows, :692, :738-739)" if up
            else ":333 (owned_rows, :368-372, :437-438)")
    return {"name": name + "_owned_rows", "route": "cuda",
            "source": "hdrvae_torch/csrc/conv3x3.cu",
            "replaces": "hdrvae/kernels/conv3x3.py" + line,
            "max_abs_err": max(d["max_abs_err"] for d in details),
            "stats_rel_err": max(d["stats_rel_err"] for d in details),
            "partition_rel_err": max(d["partition_rel_err"]
                                     for d in details),
            **{k: sum(d[k] for d in details)
               for k in ("ms", "unrestricted_ms", "plain_ms")},
            "shapes": details}


def _summed(details) -> dict:
    """The row's times: each summed over its shapes."""
    return {k: sum(d[k] for d in details)
            for k in ("ms", "plain_ms", "library_ms")}


def _uniform(rng, lo, hi, shape) -> torch.Tensor:
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
        np.float32)).cuda()


def _k3_inputs(rng, hw: int = int(N_TOKENS ** 0.5), qscale: float = 1.0):
    """K3's float32 q, k, v [1, hw, hw, C_ATTN] ~ N(0, 1) on the card,
    q times ``qscale``."""
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, hw, hw, C_ATTN)).astype(np.float32)).cuda() for _ in range(3))
    return q * qscale, k, v


def _live_mask(hw: int, live: tuple) -> torch.Tensor:
    """[hw, hw] bool on the card: True on the first live[0] rows and
    live[1] columns."""
    rows = torch.arange(hw, device="cuda") < live[0]
    cols = torch.arange(hw, device="cuda") < live[1]
    return rows[:, None] & cols[None, :]


def _check_k3_masked(fn, plain, q, k, v, bar, t_unmasked: float) -> dict:
    """K3's key_valid mode of one dot mode: the kernel ``fn`` against its
    plain version with the same mask, within ``bar(ref)`` (the mode's
    unmasked budget), at K3's inputs with the bucketed phase's live region
    and on a small grid whose first K3_DEAD_KEYS keys are dead (finite and
    within the bar); the masked kernel's time beside the unmasked one's,
    and SDPA with the mask as its boolean attn_mask."""
    hw = q.shape[1]
    kv = _live_mask(hw, K3_LIVE)
    got = fn(q, k, v, kv)
    ref = plain(q, k, v, kv)
    torch.cuda.synchronize()
    e, b = (got - ref).abs().max().item(), bar(ref)
    check(torch.isfinite(got).all().item() and e <= b,
          f"K3 {fn.__name__} key_valid live {K3_LIVE}: max-abs {e} > {b}")
    del got, ref
    rng = np.random.default_rng(8)
    qs, ks, vs = (torch.from_numpy(rng.standard_normal(
        (1, K3_DEAD_HW, K3_DEAD_HW, C_ATTN)).astype(np.float32)).cuda()
        .to(q.dtype) for _ in range(3))
    dead = torch.ones(K3_DEAD_HW * K3_DEAD_HW, dtype=torch.bool,
                      device="cuda")
    dead[:K3_DEAD_KEYS] = False
    dead = dead.reshape(K3_DEAD_HW, K3_DEAD_HW)
    got = fn(qs, ks, vs, dead)
    ref = plain(qs, ks, vs, dead)
    torch.cuda.synchronize()
    e_dead, b_dead = (got - ref).abs().max().item(), bar(ref)
    check(torch.isfinite(got).all().item() and e_dead <= b_dead,
          f"K3 {fn.__name__} key_valid, first {K3_DEAD_KEYS} keys dead: "
          f"max-abs {e_dead} > {b_dead} or not finite")
    del qs, ks, vs, got, ref
    t = cuda_ms(lambda: fn(q, k, v, kv), iters=3)
    tl = sdpa_ms(q, k, v, kv)
    log(f"K3 {fn.__name__} key_valid live {K3_LIVE[0]} x {K3_LIVE[1]} of "
        f"{hw} x {hw}: max-abs {e:.3e} (<= {b:.3e}); first {K3_DEAD_KEYS} of "
        f"{K3_DEAD_HW ** 2} keys dead: {e_dead:.3e} (<= {b_dead:.3e})  "
        f"masked {t:.3f} ms  unmasked {t_unmasked:.3f} ms  SDPA with the "
        f"mask {tl:.3f} ms")
    return {"live": list(K3_LIVE), "n": hw * hw, "max_abs_err": e,
            "err_budget": b,
            "first_keys_dead": {"n": K3_DEAD_HW ** 2, "dead": K3_DEAD_KEYS,
                                "max_abs_err": e_dead,
                                "err_budget": b_dead},
            "ms": t, "unmasked_ms": t_unmasked, "library_ms": tl,
            "library_call": "F.scaled_dot_product_attention, boolean "
                            f"attn_mask, {str(q.dtype)[6:]}"}


def _k3_edge_inputs() -> list:
    """(label, [q, k, v], q's scale) of K3's edge inputs on the card,
    float32: the ragged, peaked one (K3_SHARP_HW^2 tokens, q x
    K3_SHARP_QSCALE) and K3_BATCH2."""
    sharp = _k3_inputs(np.random.default_rng(7), K3_SHARP_HW,
                       K3_SHARP_QSCALE)
    rng = np.random.default_rng(9)
    batch2 = [torch.from_numpy(rng.standard_normal(K3_BATCH2).astype(
        np.float32)).cuda() for _ in range(3)]
    return [("ragged_peaked", list(sharp), K3_SHARP_QSCALE),
            ("batch2_c64", batch2, 1.0)]


def _k3_f32_guarded(q, k, v) -> tuple:
    """K3 f32's C entry on [B, H, W, C] float32 q, k, v, writing into a
    buffer one 64-query block longer than the output, its tail NaN: (the
    output, whether the tail is untouched).  Rows past N are never
    stored; a kernel that stores them would overwrite the next batch
    element's first rows, or memory past the output."""
    from hdrvae_torch.kernels import _build
    b, h, w, c = q.shape
    n = b * h * w * c
    buf = torch.full((n + 64 * c,), float("nan"), device=q.device)
    fn = _build.library().hdrvae_flash_attention_f32
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                    buf.data_ptr(), b, h * w, c, float(c ** -0.5),
                    torch.cuda.current_stream().cuda_stream),
                 "flash_attention_f32")
    torch.cuda.synchronize()
    return buf[:n].view(b, h, w, c), bool(buf[n:].isnan().all().item())


def _check_k3_f32(q, k, v, ref=None) -> dict:
    """K3's exact float32 mode (the parity tier) within
    ATTN_BUDGET["parity"] of the plain version: through the parity
    dispatch at K3's inputs (``ref`` their plain output), on the ragged,
    peaked input and on K3_BATCH2, each also into a buffer whose tail past
    the last row must stay untouched; then its key_valid records.  Times
    the kernel (and its TFLOP/s), its plain version and SDPA float32 at
    K3's inputs."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import attention
    bar = ATTN_BUDGET["parity"]
    if ref is None:
        ref = attention.spatial_attention_reference(q, k, v)
    got = attention.spatial_attention(q, k, v, precision=Precision.parity())
    torch.cuda.synchronize()
    e = (got - ref).abs().max().item()
    check(torch.isfinite(got).all().item() and e <= bar,
          f"K3 parity: max-abs {e} > {bar}")
    del got
    records = {}
    for label, (qs, ks, vs), qscale in _k3_edge_inputs():
        got = attention.flash_attention_f32(qs, ks, vs)
        r = attention.spatial_attention_reference(qs, ks, vs)
        torch.cuda.synchronize()
        ex = (got - r).abs().max().item()
        check(torch.isfinite(got).all().item() and ex <= bar,
              f"K3 parity {label} {list(qs.shape)}: max-abs {ex} > {bar} or "
              "not finite")
        # the same through a buffer with a NaN tail past the last row
        got, tail = _k3_f32_guarded(qs, ks, vs)
        eg = (got - r).abs().max().item()
        check(tail and eg <= bar, f"K3 parity {label}: rows past N stored "
              f"(tail untouched: {tail}) or max-abs {eg} > {bar}")
        records[label] = {"shape": list(qs.shape), "qscale": qscale,
                          "max_abs_err": ex, "err_budget": bar,
                          "tail_untouched": tail}
        del qs, ks, vs, got, r
    torch.cuda.empty_cache()
    t = cuda_ms(lambda: attention.flash_attention_f32(q, k, v), iters=3)
    tp = cuda_ms(lambda: attention.spatial_attention_reference(q, k, v),
                 iters=3)
    tl = sdpa_ms(q, k, v)
    # q k^T and p v; exact float32 runs outside the tensor cores
    b = Bound().add(ATTN_FLOPS, 4 * nbytes(q), PEAK_F32)
    tflops = ATTN_FLOPS / (t * 1e9)
    log(f"K3 flash_attention_f32 N={N_TOKENS} C={C_ATTN}: parity max-abs "
        f"{e:.3e} (<= {bar}); ragged N={K3_SHARP_HW ** 2} q x "
        f"{K3_SHARP_QSCALE}: {records['ragged_peaked']['max_abs_err']:.3e}; "
        f"{list(K3_BATCH2)}: {records['batch2_c64']['max_abs_err']:.3e}  "
        f"kernel {t:.3f} ms ({tflops:.1f} TFLOP/s)  plain {tp:.3f} ms  SDPA "
        f"{tl:.3f} ms  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    masked = _check_k3_masked(
        attention.flash_attention_f32, attention.spatial_attention_reference,
        q, k, v, lambda r: bar, t)
    return {"name": "flash_attention_f32", "route": "cuda",
            "source": "hdrvae_torch/csrc/attention.cu",
            "replaces": "hdrvae/kernels/attention.py:210",
            "max_abs_err": e, "err_budget": bar, **records, "ms": t,
            "tflops": tflops, "plain_ms": tp, **b, "library_ms": tl,
            "library_call": "F.scaled_dot_product_attention, float32",
            "tiers": ["parity"], "key_valid": masked}


def _check_k3_bf16(q, k, v) -> dict:
    """K3's bf16 mode (the fast tier) within one bf16 ulp of the largest
    output of the exact plain version on the same bf16 values: at K3's
    inputs (float32 q, k, v, rounded here), on the 3-pass check's ragged,
    peaked input (K3_SHARP_HW^2 tokens, q x K3_SHARP_QSCALE) and on
    K3_BATCH2; then its key_valid records.  Times the kernel (and its
    TFLOP/s), its plain version and SDPA bf16 at K3's inputs."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import attention
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attention.spatial_attention(qb, kb, vb, precision=Precision.fast())
    ref = attention.spatial_attention_reference(qb, kb, vb)
    torch.cuda.synchronize()
    e = (got - ref).abs().max().item()
    bound = bf16_ulp(ref)
    check(torch.isfinite(got).all().item() and e <= bound,
          f"K3 fast: max-abs {e} > {bound}")
    del got, ref
    records = {}
    for label, inputs, qscale in _k3_edge_inputs():
        qs, ks, vs = (x.bfloat16() for x in inputs)
        got = attention.flash_attention_bf16(qs, ks, vs)
        r = attention.spatial_attention_reference(qs, ks, vs)
        torch.cuda.synchronize()
        ex, bx = (got - r).abs().max().item(), bf16_ulp(r)
        check(torch.isfinite(got).all().item() and ex <= bx,
              f"K3 fast {label} {list(qs.shape)}: max-abs {ex} > {bx} or "
              "not finite")
        records[label] = {"shape": list(qs.shape), "qscale": qscale,
                          "max_abs_err": ex, "err_budget": bx}
        del qs, ks, vs, got, r
    torch.cuda.empty_cache()
    t = cuda_ms(lambda: attention.flash_attention_bf16(qb, kb, vb), iters=3)
    tp = cuda_ms(lambda: attention.spatial_attention_reference(qb, kb, vb),
                 iters=3)
    tl = sdpa_ms(qb, kb, vb)
    # q, k, v in bf16 read once, the float32 output (q's size) written once
    b = Bound().add(ATTN_FLOPS, 3 * nbytes(qb) + nbytes(q))
    tflops = ATTN_FLOPS / (t * 1e9)
    log(f"K3 flash_attention_bf16 N={N_TOKENS} C={C_ATTN}: max-abs {e:.3e} "
        f"(budget {bound:.3e}); ragged N={K3_SHARP_HW ** 2} q x "
        f"{K3_SHARP_QSCALE}: {records['ragged_peaked']['max_abs_err']:.3e} "
        f"(<= {records['ragged_peaked']['err_budget']:.3e}); "
        f"{list(K3_BATCH2)}: {records['batch2_c64']['max_abs_err']:.3e} "
        f"(<= {records['batch2_c64']['err_budget']:.3e})  kernel {t:.3f} ms "
        f"({tflops:.1f} TFLOP/s)  plain {tp:.3f} ms  SDPA {tl:.3f} ms  bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    masked = _check_k3_masked(
        attention.flash_attention_bf16, attention.spatial_attention_reference,
        qb, kb, vb, bf16_ulp, t)
    return {"name": "flash_attention_bf16", "route": "cuda",
            "source": "hdrvae_torch/csrc/attention.cu",
            "replaces": "hdrvae/kernels/attention.py:210",
            "max_abs_err": e, "err_budget": bound, **records, "ms": t,
            "tflops": tflops, "plain_ms": tp, **b, "library_ms": tl,
            "library_call": "F.scaled_dot_product_attention, bf16",
            "tiers": ["fast"], "key_valid": masked}


def _plain_3pass_rows(q, k, v, rows: int = 4096) -> tuple:
    """(3-pass, exact float32) attention of [1, h, w, C] q, k, v, the
    arithmetic of spatial_attention_3pass_reference and of
    spatial_attention_reference a block of ``rows`` queries at a time:
    their whole scores at K3_LONG_HW^2 tokens would take 16 GiB each."""
    from hdrvae_torch.core.config import Precision, fp32_contractions
    from hdrvae_torch.kernels import attention
    b, h, w, c = q.shape
    n = h * w
    qs = q.reshape(b, n, c) * c ** -0.5
    kt = k.reshape(b, n, c).transpose(1, 2)
    vf = v.reshape(b, n, c)
    out3, exact = torch.empty_like(vf), torch.empty_like(vf)
    for r in range(0, n, rows):
        s = attention._dot3(qs[:, r:r + rows], kt)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out3[:, r:r + rows] = (attention._dot3(p, vf)
                               / p.sum(dim=-1, keepdim=True))
        with fp32_contractions(Precision.parity()):
            p = torch.softmax(qs[:, r:r + rows] @ kt, dim=-1)
            exact[:, r:r + rows] = p @ vf
        del s, p
    return out3.reshape(q.shape), exact.reshape(q.shape)


def _check_split_qkv(q, k, v) -> dict:
    """The 3-pass kernel's split (split_qkv) bit-equal to its plain
    version at K3's inputs and on the ragged, peaked input; timed at K3's
    inputs (its bound: q, k, v read once, the six bf16 parts written)."""
    from hdrvae_torch.kernels import attention
    qs, ks, vs = _k3_inputs(np.random.default_rng(7), K3_SHARP_HW,
                            K3_SHARP_QSCALE)
    err = 0.0
    for label, args in (("K3's inputs", (q, k, v)),
                        (f"ragged N={K3_SHARP_HW ** 2} q x {K3_SHARP_QSCALE}",
                         (qs, ks, vs))):
        got = attention.split_qkv(*args)
        want = attention.split_qkv_reference(*args)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"split_qkv {label}: shape "
              f"{tuple(got.shape)}, want {tuple(want.shape)}")
        e = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"split_qkv {label}: not bit-equal to "
              f"its plain version ({e} apart)")
        err = max(err, e)
        del got, want
    del qs, ks, vs
    t = cuda_ms(lambda: attention.split_qkv(q, k, v), iters=10)
    tp = cuda_ms(lambda: attention.split_qkv_reference(q, k, v), iters=3)
    b = Bound().add(0, 3 * nbytes(q) + 6 * q.numel() * 2)
    log(f"split_qkv N={N_TOKENS} C={C_ATTN}: bit-equal to its plain version "
        f"(and on the ragged, peaked input)  kernel {t:.3f} ms  plain "
        f"{tp:.3f} ms  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    return {"name": "split_qkv", "route": "cuda",
            "source": "hdrvae_torch/csrc/attention.cu",
            "replaces": "hdrvae/kernels/attention.py:50 (_dot3's split, "
                        "in K3's HIGH body :131)",
            "max_abs_err": err, "err_budget": 0.0, "ms": t, "plain_ms": tp,
            **b, "library_ms": None, "tiers": ["mixed"]}


def _check_k3_3pass(q, k, v, ref=None) -> list:
    """K3's 3-pass mode (the mixed tier) at K3's inputs: its split
    (``_check_split_qkv``) bit-equal to the split's plain version; the
    kernel within ATTN_BUDGET["mixed"] of the exact plain version ``ref``
    and within K3_3PASS_REL * max|ref3| of its own plain version ref3; the
    same against its plain version on the ragged, peaked input; then at
    K3_LONG_HW^2 tokens (the 2048^2 decode's mid attention, its plain
    versions a block of rows at a time).  Times the kernel, its plain
    version and SDPA float32 at both sizes.  Returns the kernel's record
    and the split's."""
    from hdrvae_torch.kernels import attention
    split_entry = _check_split_qkv(q, k, v)
    if ref is None:
        ref = attention.spatial_attention_reference(q, k, v)
    got = attention.flash_attention_3pass(q, k, v)
    ref3 = attention.spatial_attention_3pass_reference(q, k, v)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), "K3 3-pass: output not finite")
    e_exact = (got - ref).abs().max().item()
    e = (got - ref3).abs().max().item()
    bar = K3_3PASS_REL * ref3.abs().max().item()
    check(e <= bar and e_exact <= ATTN_BUDGET["mixed"],
          f"K3 3-pass: max-abs {e} against its plain version (<= {bar}), "
          f"{e_exact} against exact float32 (<= {ATTN_BUDGET['mixed']})")
    del got, ref3
    torch.cuda.empty_cache()
    qs, ks, vs = _k3_inputs(np.random.default_rng(7), K3_SHARP_HW,
                            K3_SHARP_QSCALE)
    got = attention.flash_attention_3pass(qs, ks, vs)
    ref3 = attention.spatial_attention_3pass_reference(qs, ks, vs)
    torch.cuda.synchronize()
    e_sharp = (got - ref3).abs().max().item()
    bar_sharp = K3_3PASS_REL * ref3.abs().max().item()
    check(e_sharp <= bar_sharp, f"K3 3-pass ragged N = {K3_SHARP_HW ** 2}, "
          f"q x {K3_SHARP_QSCALE}: max-abs {e_sharp} against its plain "
          f"version > {bar_sharp}")
    del qs, ks, vs, got, ref3
    torch.cuda.empty_cache()
    t = cuda_ms(lambda: attention.flash_attention_3pass(q, k, v), iters=3)
    tp = cuda_ms(lambda: attention.spatial_attention_3pass_reference(q, k, v),
                 iters=3)
    tl = sdpa_ms(q, k, v)
    masked = _check_k3_masked(
        attention.flash_attention_3pass,
        attention.spatial_attention_3pass_reference, q, k, v,
        lambda r: K3_3PASS_REL * r.abs().max().item(), t)
    # three bf16 passes of q k^T and of p v on the tensor cores
    b = Bound().add(3 * ATTN_FLOPS, 4 * nbytes(q), PEAK_BF16)
    log(f"K3 flash_attention_3pass N={N_TOKENS} C={C_ATTN}: max-abs "
        f"{e_exact:.3e} vs exact (<= {ATTN_BUDGET['mixed']}), {e:.3e} vs "
        f"plain 3-pass (<= {bar:.3e}); ragged N={K3_SHARP_HW ** 2} q x "
        f"{K3_SHARP_QSCALE}: {e_sharp:.3e} vs plain (<= {bar_sharp:.3e})  "
        f"kernel {t:.3f} ms ({3 * ATTN_FLOPS / (t * 1e9):.1f} TFLOP/s)  "
        f"plain {tp:.3f} ms  SDPA {tl:.3f} ms  bound {b['bound_ms']:.3f} ms "
        f"({b['bound_by']})")
    long = _check_k3_3pass_long()
    return [{"name": "flash_attention_3pass", "route": "cuda",
             "source": "hdrvae_torch/csrc/attention.cu",
             "replaces": "hdrvae/kernels/attention.py:210 (HIGH: _dot3, :43)",
             "max_abs_err": e, "err_budget": bar,
             "max_abs_err_vs_exact": e_exact,
             "ragged_peaked": {"n": K3_SHARP_HW ** 2,
                               "qscale": K3_SHARP_QSCALE,
                               "max_abs_err": e_sharp,
                               "err_budget": bar_sharp},
             "ms": t, "tflops": 3 * ATTN_FLOPS / (t * 1e9), "plain_ms": tp,
             **b, "library_ms": tl,
             "library_call": "F.scaled_dot_product_attention, float32",
             "tiers": ["mixed"], "key_valid": masked, "long": long},
            split_entry]


def _check_k3_3pass_long() -> dict:
    """K3's 3-pass mode at K3_LONG_HW^2 tokens, C = C_ATTN (the 2048^2
    decode's mid attention, 1,024 key steps of accumulation): within
    K3_3PASS_REL * max|ref3| of its plain version and ATTN_BUDGET["mixed"]
    of exact float32 (both a block of rows at a time), timed beside SDPA
    float32 (None where SDPA runs out of memory)."""
    from hdrvae_torch.kernels import attention
    q, k, v = _k3_inputs(np.random.default_rng(10), K3_LONG_HW)
    n = K3_LONG_HW ** 2
    got = attention.flash_attention_3pass(q, k, v)
    ref3, exact = _plain_3pass_rows(q, k, v)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"K3 3-pass N = {n}: output not "
          "finite")
    e = (got - ref3).abs().max().item()
    bar = K3_3PASS_REL * ref3.abs().max().item()
    e_exact = (got - exact).abs().max().item()
    check(e <= bar and e_exact <= ATTN_BUDGET["mixed"],
          f"K3 3-pass N = {n}: max-abs {e} against its plain version (<= "
          f"{bar}), {e_exact} against exact float32 (<= "
          f"{ATTN_BUDGET['mixed']})")
    del got, ref3, exact
    torch.cuda.empty_cache()
    t = cuda_ms(lambda: attention.flash_attention_3pass(q, k, v), iters=3)
    try:
        tl = sdpa_ms(q, k, v)
    except torch.OutOfMemoryError:
        tl = None
    torch.cuda.empty_cache()
    flops = 3 * 4 * n * n * C_ATTN
    b = Bound().add(flops, 4 * nbytes(q), PEAK_BF16)
    log(f"K3 flash_attention_3pass N={n} C={C_ATTN}: max-abs {e:.3e} vs "
        f"plain 3-pass (<= {bar:.3e}), {e_exact:.3e} vs exact (<= "
        f"{ATTN_BUDGET['mixed']})  kernel {t:.3f} ms "
        f"({flops / (t * 1e9):.1f} TFLOP/s)  SDPA {tl} ms  bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    return {"n": n, "max_abs_err": e, "err_budget": bar,
            "max_abs_err_vs_exact": e_exact, "ms": t,
            "tflops": flops / (t * 1e9), **b, "library_ms": tl}


def _check_k2_stats_only(rng) -> dict:
    """K2's stats_only mode at the 2048^2 junction: its sums bit-equal to
    those of the same launch with y written, and within STATS_BUDGET of
    the plain version."""
    from hdrvae_torch.kernels import conv3x3
    h, w, c = K2_STATS_SHAPE
    x = _bf16(rng, (1, h, w, c), 0.5)
    kern = _bf16(rng, (3, 3, c, c), (9 * c) ** -0.5)
    bias = _uniform(rng, -0.1, 0.1, c)
    kw = dict(emit_stats=True, num_groups=32)
    y, s = conv3x3.upsample_conv3x3(x, kern, bias, **kw)
    so = conv3x3.upsample_conv3x3(x, kern, bias, stats_only=True, **kw)
    rs = conv3x3.upsample_conv3x3_reference(x, kern, bias, stats_only=True,
                                            **kw)
    torch.cuda.synchronize()
    check(torch.equal(so[0], s[0]) and torch.equal(so[1], s[1]),
          "K2 stats_only: sums differ from the launch that writes y")
    es = stats_err(so, rs, y)
    check(es <= STATS_BUDGET, f"K2 stats_only: stats rel err {es}")
    t = cuda_ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias,
                                                 stats_only=True, **kw))
    t_y = cuda_ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias, **kw))
    tp = cuda_ms(lambda: conv3x3.upsample_conv3x3_reference(
        x, kern, bias, stats_only=True, **kw), iters=2, warmup=1)
    del y
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    tl = conv_alone_ms(up, kern)
    del up
    flops = 2 * (4 * h * w) * 4 * c * c
    b = Bound().add(flops, nbytes(x, kern, bias, *so))
    log(f"K2 upsample_conv3x3 stats_only {h}x{w}->{2 * h}x{2 * w} {c}: sums "
        f"bit-equal to K2's with y written; stats {es:.2e}  kernel {t:.3f} "
        f"ms (with y written {t_y:.3f} ms)  plain {tp:.3f} ms  conv alone "
        f"{tl:.3f} ms  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    del x
    torch.cuda.empty_cache()
    return {"name": "upsample_conv3x3_stats_only", "route": "cuda",
            "source": "hdrvae_torch/csrc/conv3x3.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:653 (stats_only, :666)",
            "max_abs_err": 0.0, "stats_rel_err": es, "ms": t,
            "ms_with_y": t_y, "plain_ms": tp, **b, "library_ms": tl,
            "library_call": CONV_ALONE + " (on the upsampled map)",
            "shape": [h, w, c, c]}


def _check_k5(rng) -> dict:
    """K5 against its plain version at the 2048^2 decode's junction and at
    a ragged map whose output width is no multiple of the 64-pixel work
    item; y max-abs within CONV_BUDGET, the statistics within
    STATS_BUDGET.  Its library column: the two cuDNN convs alone (the
    up-conv on the materialized 2x map, and conv1), which the port never
    calls."""
    from hdrvae_torch.kernels import conv3x3
    cin, cm, cout = K5_CIN, K5_CM, K5_COUT
    details, bnd = [], Bound()
    err = err_s = 0.0
    for h, w in K5_SHAPES:
        x = _bf16(rng, (1, h, w, cin), 0.5)
        args = (x, _bf16(rng, (3, 3, cin, cm), (9 * cin) ** -0.5),
                _uniform(rng, -0.1, 0.1, cm),
                _uniform(rng, 0.5, 1.5, (1, cm)),
                _uniform(rng, -0.5, 0.5, (1, cm)),
                _bf16(rng, (3, 3, cm, cout), (9 * cm) ** -0.5),
                _uniform(rng, -0.1, 0.1, cout))
        kw = dict(emit_stats=True, num_groups=32)
        y, s = conv3x3.upconv_gn_conv3x3(*args, **kw)
        ry, rs = conv3x3.upconv_gn_conv3x3_reference(*args, **kw)
        torch.cuda.synchronize()
        check(y.shape == (1, 2 * h, 2 * w, cout) and y.dtype == ry.dtype,
              f"K5 {h}x{w}: {y.dtype} {tuple(y.shape)}")
        check(torch.isfinite(y.float()).all().item(),
              f"K5 {h}x{w}: output not finite")
        e = (y.float() - ry.float()).abs().max().item()
        es = stats_err(s, rs, ry)
        check(e <= CONV_BUDGET, f"K5 {h}x{w}: max-abs {e} > {CONV_BUDGET}")
        check(es <= STATS_BUDGET, f"K5 {h}x{w}: stats rel err {es}")
        nb = nbytes(*args, y, *s)
        del ry, rs, y, s
        t = cuda_ms(lambda: conv3x3.upconv_gn_conv3x3(*args, **kw))
        tp = cuda_ms(lambda: conv3x3.upconv_gn_conv3x3_reference(
            *args, **kw), iters=2, warmup=1)
        up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        tl = conv_alone_ms(up, args[1])
        del up
        band = _bf16(rng, (1, 2 * h, 2 * w, cm), 0.5)
        tl += conv_alone_ms(band, args[5])
        del band
        # the phase-decomposed up-conv (16 taps over the low-resolution
        # map) and conv1 (9 taps at the doubled resolution)
        flops = 2 * h * w * 16 * cin * cm + 2 * (4 * h * w) * 9 * cm * cout
        b = bnd.add(flops, nb)
        log(f"K5 upconv_gn_conv3x3 {h}x{w}->{2 * h}x{2 * w} {cin}->{cm}->"
            f"{cout}: max-abs {e:.3e} stats {es:.2e}  kernel {t:.3f} ms "
            f"({flops / (t * 1e9):.1f} TFLOP/s)  plain {tp:.3f} ms  cuDNN's "
            f"two convs alone {tl:.3f} ms  bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}; kernel {t / b['bound_ms']:.1f}x it)")
        details.append({"shape": [h, w, cin, cm, cout], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp,
                        "library_ms": tl, "tflops": flops / (t * 1e9), **b})
        err, err_s = max(err, e), max(err_s, es)
        del x, args
        torch.cuda.empty_cache()
    return {"name": "upconv_gn_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/upconv.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:1059",
            "max_abs_err": err, "stats_rel_err": err_s, **_summed(details),
            **bnd.entry(),
            "library_call": CONV_ALONE + " twice: the up-conv on the "
                            "upsampled map, then conv1",
            "shapes": details}


def _k4_compare(pre: torch.Tensor, label: str) -> tuple:
    """K4 against its plain version on ``pre``: the collapse bit-exact,
    min and max exact, mean and std within K4_BUDGET relative.  Returns
    (collapsed, stats, max-abs over both, {mean, std: relative error})."""
    from hdrvae_torch.kernels import epilogue
    col, st = epilogue.collapse_and_stats_fused(pre)
    rcol, rst = epilogue.collapse_and_stats_reference(pre)
    torch.cuda.synchronize()
    check(torch.equal(col, rcol), f"K4 {label}: collapse not bit-exact")
    e_abs = max((col.float() - rcol.float()).abs().max().item(),
                *(abs(st[k].item() - rst[k].item()) for k in st))
    for key in ("min", "max"):
        check(st[key].item() == rst[key].item(),
              f"K4 {label}: {key} {st[key].item()} != {rst[key].item()}")
    rel = {key: abs(st[key].item() - rst[key].item())
           / max(abs(rst[key].item()), 1e-30) for key in ("mean", "std")}
    for key, e in rel.items():
        check(e <= K4_BUDGET, f"K4 {label}: {key} rel err {e}")
    return col, st, e_abs, rel


def _k4_extra_map(shape: tuple, kind: str, g) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device="cuda")
    if kind == "offset":
        return x + 1e3
    if kind == "ramp":   # + 0.01 per row of [M, C]
        rows = torch.arange(x.numel() // shape[-1], device="cuda")
        return x + 0.01 * rows.reshape(*shape[:-1], 1)
    return x * 2.0


def _check_k4() -> dict:
    from hdrvae_torch.kernels import epilogue
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(K4_SHAPE, generator=g, device="cuda") * 2.0
    details, k_ms, p_ms, err, rel_err = [], 0.0, 0.0, 0.0, 0.0
    bnd = Bound()
    for shape, kind in K4_EXTRA:
        m = _k4_extra_map(shape, kind, g)
        for dtype in (torch.float32, torch.bfloat16):
            _, _, e_abs, rel = _k4_compare(m.to(dtype),
                                           f"{kind} {list(shape)} {dtype}")
            log(f"K4 collapse_and_stats {kind} {list(shape)} {dtype}: "
                f"collapse bit-exact, min/max exact, mean rel "
                f"{rel['mean']:.2e} std rel {rel['std']:.2e}")
            err, rel_err = max(err, e_abs), max(rel_err, *rel.values())
    for dtype in (torch.float32, torch.bfloat16):
        pre = torch.nn.functional.silu(x).to(dtype)   # a post-SiLU map
        col, st, e_abs, rel = _k4_compare(pre, str(dtype))
        t = cuda_ms(lambda: epilogue.collapse_and_stats_fused(pre))
        tp = cuda_ms(lambda: epilogue.collapse_and_stats_reference(pre))
        gbs = pre.numel() * pre.element_size() / (t * 1e6)
        # a max over 128 channels and five statistics per pixel
        b = bnd.add(pre.numel() + 5 * col.numel(),
                    nbytes(pre, col, *st.values()), PEAK_F32)
        log(f"K4 collapse_and_stats {list(K4_SHAPE)} {dtype}: collapse "
            f"bit-exact, min/max exact, mean rel {rel['mean']:.2e} std rel "
            f"{rel['std']:.2e}  kernel {t:.3f} ms ({gbs:.0f} GB/s read)  "
            f"plain {tp:.3f} ms  bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']})")
        details.append({"dtype": str(dtype), "max_abs_err": e_abs,
                        "mean_rel_err": rel["mean"],
                        "std_rel_err": rel["std"], "ms": t, "plain_ms": tp,
                        **b})
        k_ms, p_ms = k_ms + t, p_ms + tp
        err, rel_err = max(err, e_abs), max(rel_err, *rel.values())
        del pre, col
    del x
    torch.cuda.empty_cache()
    # max_abs_err: over the collapsed maps and the four statistics
    return {"name": "collapse_and_stats_fused", "route": "cuda",
            "source": "hdrvae_torch/csrc/epilogue.cu",
            "replaces": "hdrvae/kernels/epilogue.py:93", "max_abs_err": err,
            "stats_rel_err": rel_err, "ms": k_ms, "plain_ms": p_ms,
            **bnd.entry(), "library_ms": None,
            "library_call": "none: no one PyTorch call computes the collapse "
                            "and its statistics",
            "shapes": details}


def _k6_case(rng, bnd, name, h, w, cins, cout, act, rs, f32):
    """K6 at one shape against its plain version, its bound added to
    ``bnd``: (log text, record).  Timed with weights prepared beforehand,
    as the chain passes them; the HWIO call (prepared on the fly) must
    give the same y."""
    from hdrvae_torch.kernels import dense_conv
    xs = [_bf16(rng, (1, h, w, c), 0.5) for c in cins]
    kern = _bf16(rng, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5)
    bias = _uniform(rng, -0.1, 0.1, cout)
    kw = dict(act=act, out_dtype=torch.float32 if f32 else None)
    if rs is not None:
        kw.update(residual=_bf16(rng, (1, h, w, cout), 0.5), res_scale=rs)
    pw = dense_conv.prepare_weights(kern, bias, cins)
    y = dense_conv.dense_conv3x3(xs, pw, **kw)
    ry = dense_conv.dense_conv3x3_reference(xs, kern, bias, **kw)
    yh = dense_conv.dense_conv3x3(xs, kern, bias, **kw)
    torch.cuda.synchronize()
    check(y.dtype == ry.dtype and y.shape == ry.shape,
          f"K6 {name}: {y.dtype} {tuple(y.shape)}")
    check(torch.isfinite(y.float()).all().item(),
          f"K6 {name}: output not finite")
    check(torch.equal(y, yh), f"K6 {name}: HWIO call differs")
    e = (y.float() - ry.float()).abs().max().item()
    check(e <= CONV_BUDGET, f"K6 {name} {h}x{w}: max-abs {e} > "
          f"{CONV_BUDGET}")
    t = cuda_ms(lambda: dense_conv.dense_conv3x3(xs, pw, **kw))
    tp = cuda_ms(lambda: dense_conv.dense_conv3x3_reference(
        xs, kern, bias, **kw))
    # the conv alone, on the concatenated input made beforehand
    cat = torch.cat(xs, dim=-1)
    tl = conv_alone_ms(cat, kern)
    del cat
    flops = 2 * h * w * 9 * sum(cins) * cout
    tflops = flops / (t * 1e9)
    moved = nbytes(*xs, kern, bias, y, kw.get("residual"))
    b = bnd.add(flops, moved)
    text = (f"{name} {h}x{w} {'+'.join(map(str, cins))}->{cout}: max-abs "
            f"{e:.3e}  kernel {t:.3f} ms ({tflops:.1f} TFLOP/s)  plain "
            f"{tp:.3f} ms  conv alone {tl:.3f} ms  bound {b['bound_ms']:.3f}"
            f" ms ({b['bound_by']})")
    return text, {"shape": [name, h, w, list(cins), cout], "max_abs_err": e,
                  "ms": t, "plain_ms": tp, "tflops": tflops,
                  "library_ms": tl, "flops": flops,
                  "ops_ms": 1e3 * flops / PEAK_BF16,
                  "bytes_ms": 1e3 * moved / HBM_BYTES_S, **b}


def _check_k6(rng) -> dict:
    """K6 at one 512^2 tile's shapes of the ESRGAN x4 net (the row's sums,
    each shape once), more shapes logged apart, and an estimate of K6's
    time in one RRDBNetConfig() tile forward, launch-weighted."""
    details, extra, bnd = [], [], Bound()
    for shape in K6_SHAPES:
        text, rec = _k6_case(rng, bnd, *shape)
        log("K6 dense_conv3x3 " + text)
        details.append(rec)
        torch.cuda.empty_cache()
    for shape in K6_EXTRA:
        text, rec = _k6_case(rng, Bound(), *shape)
        log("K6 dense_conv3x3 (out of the sums) " + text)
        extra.append(rec)
        torch.cuda.empty_cache()
    # an estimate of K6 in one tile forward: each shape's time alone times
    # its launches there (phase_upscale measures a forward itself)
    recs = {d["shape"][0]: d for d in details + extra}
    est = {k: sum(n * recs[name][k] for name, n in K6_FORWARD.items())
           for k in ("ms", "library_ms", "flops", "bound_ms", "ops_ms",
                     "bytes_ms")}
    log(f"K6 dense_conv3x3 one RRDBNetConfig() 512^2 tile forward, estimate "
        f"(each shape's time alone x its launches there, "
        f"{sum(K6_FORWARD.values())} in all): kernel {est['ms']:.3f} ms "
        f"({est['flops'] / (est['ms'] * 1e9):.1f} TFLOP/s)  conv alone "
        f"{est['library_ms']:.3f} ms  bound {est['bound_ms']:.3f} ms "
        f"(summed over the launches; operations {est['ops_ms']:.3f}, bytes "
        f"{est['bytes_ms']:.3f})")
    return {"name": "dense_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/dense_conv.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:1306",
            "max_abs_err": max(d["max_abs_err"] for d in details),
            **_summed(details), **bnd.entry(),
            "library_call": CONV_ALONE + " (on the concatenated inputs)",
            "shapes": details, "extra": extra}


def _swin_block(rng, dim: int, heads: int, ws: int, v2: bool = False):
    """A Swin block (SwinIR-M / HAT-M widths), or with ``v2`` a SwinV2 one
    (Swin2SR-M), on the card with weights from numpy: linears N(0,
    1/fan_in), biases, LayerNorm affines and the bias table or position MLP
    non-trivial; v2's logit scales from 10 to 150, past the clamp at 100."""
    from hdrvae_torch.models.swin2sr import CPB_HIDDEN, Swin2Block
    from hdrvae_torch.models.swinir import SwinBlock
    blk = (Swin2Block if v2 else SwinBlock)(dim, heads, ws, 2.0)
    sd = {}
    for k, v in blk.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("logit_scale"):
            a = np.log(np.linspace(10.0, 150.0, heads)).reshape(shape)
        elif k.startswith("attn.cpb_mlp.0"):
            a = rng.standard_normal(shape)
        elif k.startswith("attn.cpb_mlp.2"):
            a = rng.standard_normal(shape) * CPB_HIDDEN ** -0.5
        elif k.startswith("norm") and k.endswith("weight"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("weight"):
            a = rng.standard_normal(shape) * shape[1] ** -0.5
        else:
            a = rng.standard_normal(shape) * 0.5
        sd[k] = torch.from_numpy(a.astype(np.float32))
    blk.load_state_dict(sd)
    return blk.requires_grad_(False).cuda()


def _swin_flops(tokens: int, n: int, c: int = SWIN_DIM) -> int:
    """A Swin block's operations at width c, MLP 2c: qkv, scores and
    values, proj, MLP."""
    return 2 * tokens * (c * 3 * c + 2 * n * c + c * c + 2 * c * 2 * c)


def _check_k7(rng, shapes, v2: bool = False) -> dict:
    """K7 (or its SwinV2 body) against its plain version at the 512^2 tile
    shapes of its models, a window-7 grid (v2) and a ragged 128 x 120 tile
    (15 windows across), with the max-abs over the whole image and over
    the last window row and column, where the shifted grid's masks act."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import swin_attention as ska
    from hdrvae_torch.models.swin2sr import block_weights_v2
    from hdrvae_torch.models.swinir import block_weights
    fast = Precision.fast()
    name_k = "K7 swin_block_fused" + (" v2" if v2 else "")
    details, k_ms, p_ms, err, err_edge = [], 0.0, 0.0, 0.0, 0.0
    bnd = Bound()
    for name, h, w, ws, shift, extra in shapes:
        blk = _swin_block(rng, SWIN_DIM, SWIN_HEADS, ws, v2)
        wts = (block_weights_v2 if v2 else block_weights)(
            blk, SWIN_HEADS, ws, torch.bfloat16)
        x = _bf16(rng, (1, h, w, SWIN_DIM))
        # extra at the scale of x: a dropped or misplaced residual shows
        e_in = _bf16(rng, (1, h, w, SWIN_DIM), 0.5) if extra else None
        kw = dict(ws=ws, shift=shift, extra=e_in, precision=fast)
        # a NaN-filled block of y's size goes back to the allocator just
        # before the call, which then most likely hands it to y: a window
        # the kernel never stores shows
        torch.full_like(x, float("nan"))
        y = ska.swin_block_fused(x, wts, **kw)
        ry = ska.swin_block_fused_reference(x, wts, **kw)
        torch.cuda.synchronize()
        check(y.dtype == ry.dtype and y.shape == ry.shape,
              f"{name_k} {name}: {y.dtype} {tuple(y.shape)}")
        check(torch.isfinite(y.float()).all().item(),
              f"{name_k} {name}: output not finite")
        d = (y.float() - ry.float()).abs()
        e = d.max().item()
        e_last = max(d[:, -ws:].max().item(), d[:, :, -ws:].max().item())
        # v1 rounds where its plain version does: two bf16 ulps of the
        # largest output (the card tests' bound); v2's scales up to 100
        # amplify a q rounding difference (SWIN_BUDGET)
        bound = (SWIN_BUDGET * max(1.0, ry.float().abs().max().item())
                 if v2 else 2 * bf16_ulp(ry))
        check(e <= bound, f"{name_k} {name}: max-abs {e} > {bound}")
        check(e_last <= bound,
              f"{name_k} {name}: last window row/col max-abs {e_last} > "
              f"{bound}")
        t = cuda_ms(lambda: ska.swin_block_fused(x, wts, **kw))
        tp = cuda_ms(lambda: ska.swin_block_fused_reference(x, wts, **kw),
                     iters=2, warmup=1)
        flops = _swin_flops(h * w, ws * ws)
        b = bnd.add(flops, nbytes(x, e_in, y, *(
            f for f in wts if isinstance(f, torch.Tensor))))
        log(f"{name_k} {name} {h}x{w} ws {ws} shift {shift}"
            f"{' +extra' if extra else ''}: max-abs {e:.3e} (last window "
            f"row/col {e_last:.3e}, budget {bound:.3e})  kernel {t:.3f} ms "
            f"({flops / (t * 1e9):.1f} TFLOP/s)  plain {tp:.3f} ms  bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}; kernel "
            f"{t / b['bound_ms']:.1f}x it)")
        details.append({"shape": [name, h, w, SWIN_DIM, ws, shift,
                                  bool(extra)],
                        "max_abs_err": e, "max_abs_err_last_row_col": e_last,
                        "err_budget": bound, "ms": t, "plain_ms": tp,
                        "tflops": flops / (t * 1e9), **b})
        k_ms, p_ms = k_ms + t, p_ms + tp
        err, err_edge = max(err, e), max(err_edge, e_last)
        del x, e_in, y, ry, d, wts, blk
        torch.cuda.empty_cache()
    return {"name": "swin_block_fused_v2" if v2 else "swin_block_fused",
            "route": "cuda", "source": "hdrvae_torch/csrc/swin_block.cu",
            # v2: the post_norm / cosine branches of the kernel body
            "replaces": "hdrvae/kernels/swin_attention.py:501" if v2
            else "hdrvae/kernels/swin_attention.py:672",
            "max_abs_err": err, "max_abs_err_last_row_col": err_edge,
            "ms": k_ms, "plain_ms": p_ms, **bnd.entry(), "library_ms": None,
            "library_call": "none: no one PyTorch call computes a whole "
                            "Swin block", "shapes": details}


def _k8_inputs(rng, shape, peak: float = 1.0):
    """q (scaled by 30^-1/2), k, v [nwb, heads, n, 32] bf16 with the head
    dim 30 zero-padded to 32, and a standard normal bias [heads, nq, nk]
    times ``peak``."""
    nwb, heads, nq, nk = shape

    def qkv(n, scale):
        t = _bf16(rng, (nwb, heads, n, 32), scale)
        t[..., 30:] = 0
        return t
    q, k, v = qkv(nq, 30 ** -0.5), qkv(nk, 1.0), qkv(nk, 1.0)
    bias = torch.from_numpy(rng.standard_normal((heads, nq, nk))
                            .astype(np.float32) * peak).cuda()
    return q, k, v, bias


def _check_k8(rng) -> dict:
    """K8 against its plain version at HAT-M's 512^2-tile OCAB shape (1024
    windows, 6 heads, 256 queries against 576 keys, head dim 30 padded to
    32 with zeros), on the same shape with a peaked bias (one key a row
    dominates, where the kernel's rounding of the unnormalized P differs
    most from the plain version's normalized one) and at a ragged shape
    (20 queries, 36 keys: padded to 16 around the launch), each within two
    bf16 ulps of its largest output; at HAT-M's shape also through the C
    entry into a NaN-filled buffer, which must come out bit-equal."""
    from hdrvae_torch.kernels import ocab
    nwb, heads, nq, nk = K8_SHAPE
    kw = dict(compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16)
    errs = {}
    for name, shape, peak in (("peaked", K8_SHAPE, K8_PEAK),
                              ("ragged", K8_RAGGED, 1.0),
                              ("main", K8_SHAPE, 1.0)):
        q, k, v, bias = _k8_inputs(rng, shape, peak)
        o = ocab.ocab_attention(q, k, v, bias, **kw)
        ro = ocab.ocab_attention_reference(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        check(o.dtype == ro.dtype and o.shape == ro.shape,
              f"K8 {name}: {o.dtype} {tuple(o.shape)}")
        e = (o.float() - ro.float()).abs().max().item()
        bound = 2 * bf16_ulp(ro)
        check(e <= bound, f"K8 {name} {list(shape)}: max-abs {e} > {bound} "
              "(two bf16 ulps of the largest output)")
        errs[name] = (e, bound)
        log(f"K8 ocab_attention {name} {list(shape)}: max-abs {e:.3e} "
            f"(budget {bound:.3e})")
        if name != "main":
            del q, k, v, bias, o, ro
    e, bound = errs["main"]
    # through the C entry into a NaN-filled buffer: every output element
    # written, bit-equal to the wrapper's output
    from hdrvae_torch.kernels import _build
    filled = torch.full_like(o, float("nan"))
    _build.check(_build.library().hdrvae_ocab_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        filled.data_ptr(), nwb, heads, nq, nk,
        torch.cuda.current_stream().cuda_stream), "hdrvae_ocab_attention")
    torch.cuda.synchronize()
    check(torch.equal(filled, o), "K8: the C entry's output into a "
          "NaN-filled buffer is not the wrapper's (an element not written)")
    del filled
    t = cuda_ms(lambda: ocab.ocab_attention(q, k, v, bias, **kw))
    tp = cuda_ms(lambda: ocab.ocab_attention_reference(q, k, v, bias, **kw),
                 iters=2, warmup=1)
    # the bias as SDPA's additive mask, in the queries' dtype (q carries
    # the softmax scale already)
    mask = bias.to(q.dtype)
    tl = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0))
    del mask
    flops, exps = 4 * nwb * heads * nq * nk * 32, nwb * heads * nq * nk
    b = Bound().add(flops, nbytes(q, k, v, bias, o), exps=exps)
    log(f"K8 ocab_attention {list(K8_SHAPE)}: kernel {t:.3f} ms "
        f"({flops / (t * 1e9):.1f} TFLOP/s, {exps / (t * 1e9):.3f} T "
        f"exponentials/s)  plain {tp:.3f} ms  SDPA {tl:.3f} ms  bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}: products "
        f"{1e3 * flops / PEAK_BF16:.3f}, exponentials "
        f"{1e3 * exps / PEAK_EX2:.3f}, bytes "
        f"{1e3 * nbytes(q, k, v, bias, o) / HBM_BYTES_S:.3f})")
    del q, k, v, bias, o, ro
    torch.cuda.empty_cache()
    return {"name": "ocab_attention", "route": "cuda",
            "source": "hdrvae_torch/csrc/ocab.cu",
            "replaces": "hdrvae/kernels/ocab.py:95", "max_abs_err": e,
            "err_budget": bound,
            "max_abs_err_peaked": errs["peaked"][0],
            "max_abs_err_ragged": errs["ragged"][0],
            "ms": t, "plain_ms": tp, **b, "library_ms": tl,
            "library_call": "F.scaled_dot_product_attention, bf16, the bias "
                            "as a bf16 attn_mask",
            "shape": list(K8_SHAPE)}


def _window_edge_err(d: torch.Tensor, grid: tuple) -> float:
    """Max of a per-window error d [nwin, ...] (one image) over the windows
    of the last window row and column, where a shifted grid's masks act."""
    e = d.reshape(*grid, -1).amax(dim=-1)
    return max(e[-1].max().item(), e[:, -1].max().item())


def _window_mask(bias: torch.Tensor, ws: int, shift: int,
                 grid: tuple) -> torch.Tensor:
    """The position bias [heads, n, n] plus the band masks of a shifted
    grid of windows, per window [nwin, heads, n, n] in bf16: SDPA's
    additive mask for the attention core."""
    from hdrvae_torch.kernels.swin_attention import band_masks
    mask = bias.expand(*grid, *bias.shape).clone()
    if shift:
        mrow, mcol = (m.to(bias.device) for m in band_masks(ws, shift))
        mask[-1] += mrow
        mask[:, -1] += mcol
    return mask.reshape(-1, *bias.shape).to(torch.bfloat16)


def _nan_block(shape) -> None:
    """A NaN-filled bf16 block of ``shape`` goes back to the allocator, which
    then most likely hands it to the next tensor of that size: rows or
    windows a kernel never stores show as NaN."""
    torch.full(shape, float("nan"), device="cuda", dtype=torch.bfloat16)


def _check_chain_ragged(rng) -> dict:
    """The chain's kernels against their plain versions (not timed) on
    CHAIN_RAGGED's windows, whose rows are no multiple of 64, each kernel
    on the previous one's output and each output in a block that held NaNs:
    within SWIN_BUDGET, and the padded rows n .. n16 of qkv and o exactly
    zero.  Returns each kernel's largest max-abs."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import swin_attention as ska
    from hdrvae_torch.models.swinir import block_weights
    fast = Precision.fast()
    err = {"swin_ln_qkv": 0.0, "swin_attn_core": 0.0, "swin_proj_mlp": 0.0}
    for name, h, w, ws, shift, extra in CHAIN_RAGGED:
        blk = _swin_block(rng, SWIN_DIM, SWIN_HEADS, ws)
        wts = block_weights(blk, SWIN_HEADS, ws, torch.bfloat16)
        x = _bf16(rng, (1, h, w, SWIN_DIM))
        e_in = _bf16(rng, (1, h, w, SWIN_DIM), 0.5) if extra else None
        n, n16 = ws * ws, -(-ws * ws // 16) * 16
        nwin = (h // ws) * (w // ws)
        kc = dict(heads=SWIN_HEADS, ws=ws, shift=shift,
                  grid=(h // ws, w // ws))
        _nan_block((nwin, n16, SWIN_HEADS * 96))
        qkv = ska.ln_qkv(x, wts, ws=ws, precision=fast)
        o = ska.window_attention_core(qkv, wts.bias, **kc)
        _nan_block(tuple(x.shape))
        y = ska.proj_mlp(o, x, wts, ws=ws, extra=e_in, precision=fast)
        refs = {"swin_ln_qkv": ska.ln_qkv_reference(x, wts, ws=ws,
                                                    precision=fast),
                "swin_attn_core": ska.window_attention_core_reference(
                    qkv, wts.bias, **kc),
                "swin_proj_mlp": ska.proj_mlp_reference(
                    o, x, wts, ws=ws, extra=e_in, precision=fast)}
        torch.cuda.synchronize()
        for key, got in zip(err, (qkv, o, y)):
            ref = refs[key]
            check(got.shape == ref.shape
                  and torch.isfinite(got.float()).all().item(),
                  f"{key} {name}: {tuple(got.shape)} or not finite")
            e = (got.float() - ref.float()).abs().max().item()
            bound = SWIN_BUDGET * max(1.0, ref.float().abs().max().item())
            check(e <= bound, f"{key} {name}: max-abs {e} > {bound}")
            if key != "swin_proj_mlp":   # none at n16 = n
                pad = got[:, n:].float().abs().sum().item()
                check(pad == 0.0, f"{key} {name}: padded rows {pad}")
            log(f"{key} {name} {h}x{w} ws {ws} shift {shift}"
                f"{' +extra' if extra else ''}: max-abs {e:.3e} (budget "
                f"{bound:.3e})" + ("" if key == "swin_proj_mlp" else
                                   f", padded rows {n16 - n} zero"))
            err[key] = max(err[key], e)
        del x, e_in, qkv, o, y, refs, wts, blk
    return err


def _check_chain(rng, with_k7: bool = True) -> tuple:
    """The staged Swin chain at K7's v1 shapes: K10, K9 and K11 each against
    its plain version on the same input, each kernel's input the previous
    kernel's output, with the max-abs over the last window row and column
    apart, each output in a block that held NaNs; all three also on
    CHAIN_RAGGED's windows; then (``with_k7``) the chain against K7 on the
    same inputs and weights, with both times.  K10's and K11's yardstick
    is cuBLAS's products alone (bf16 ``torch.matmul``: qkv; proj, fc1 and
    fc2), no one PyTorch call computing either.  Returns the three
    kernels' entries and the A/B records."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import swin_attention as ska
    from hdrvae_torch.models.swinir import block_weights
    fast = Precision.fast()
    keys = ("swin_ln_qkv", "swin_attn_core", "swin_proj_mlp")
    acc = {k: {"details": [], "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "yardstick_ms": 0.0, "flops": 0.0, "err": 0.0, "edge": 0.0,
               "bound": Bound()} for k in keys}
    ab = []
    c = SWIN_DIM
    for name, h, w, ws, shift, extra in K7_SHAPES:
        blk = _swin_block(rng, c, SWIN_HEADS, ws)
        wts = block_weights(blk, SWIN_HEADS, ws, torch.bfloat16)
        x = _bf16(rng, (1, h, w, c))
        e_in = _bf16(rng, (1, h, w, c), 0.5) if extra else None
        grid, n, tokens = (h // ws, w // ws), ws * ws, h * w
        kc = dict(heads=SWIN_HEADS, ws=ws, shift=shift, grid=grid)
        _nan_block((grid[0] * grid[1], -(-n // 16) * 16, SWIN_HEADS * 96))
        qkv = ska.ln_qkv(x, wts, ws=ws, precision=fast)
        o = ska.window_attention_core(qkv, wts.bias, **kc)
        _nan_block(tuple(x.shape))
        y = ska.proj_mlp(o, x, wts, ws=ws, extra=e_in, precision=fast)
        # cuBLAS's products alone on operands of the kernels' padded
        # widths: K10's x Wqkv; K11's o Wp, y2 W1, GELU W2
        cp, hp = wts.w1.shape
        rows_t = _bf16(rng, (tokens, cp))
        hid = _bf16(rng, (tokens, hp))
        o2 = o.reshape(-1, o.shape[-1])
        yardsticks = {
            "swin_ln_qkv": lambda: torch.matmul(rows_t, wts.wq),
            "swin_proj_mlp": lambda: (torch.matmul(o2, wts.wp),
                                      torch.matmul(rows_t, wts.w1),
                                      torch.matmul(hid, wts.w2))}
        kernels = {
            "swin_ln_qkv": lambda: ska.ln_qkv(x, wts, ws=ws, precision=fast),
            "swin_attn_core": lambda: ska.window_attention_core(
                qkv, wts.bias, **kc),
            "swin_proj_mlp": lambda: ska.proj_mlp(o, x, wts, ws=ws,
                                                  extra=e_in,
                                                  precision=fast)}
        plains = {
            "swin_ln_qkv": lambda: ska.ln_qkv_reference(x, wts, ws=ws,
                                                        precision=fast),
            "swin_attn_core": lambda: ska.window_attention_core_reference(
                qkv, wts.bias, **kc),
            "swin_proj_mlp": lambda: ska.proj_mlp_reference(
                o, x, wts, ws=ws, extra=e_in, precision=fast)}
        work = {   # (operations, bytes[, peak, exponentials]): each input
                   # read once, output once
            "swin_ln_qkv": (2 * tokens * c * 3 * c, nbytes(
                x, qkv, wts.wq, wts.bq, wts.g1, wts.be1)),
            "swin_attn_core": (4 * tokens * n * c, nbytes(qkv, wts.bias, o),
                               PEAK_BF16, tokens * n * SWIN_HEADS),
            "swin_proj_mlp": (2 * tokens * (c * c + 2 * c * 2 * c), nbytes(
                o, x, e_in, y, wts.wp, wts.bp, wts.g2, wts.be2, wts.w1,
                wts.b1, wts.w2, wts.b2))}
        for key, got in zip(keys, (qkv, o, y)):
            ref = plains[key]()
            torch.cuda.synchronize()
            check(got.dtype == ref.dtype and got.shape == ref.shape,
                  f"{key} {name}: {got.dtype} {tuple(got.shape)}")
            check(torch.isfinite(got.float()).all().item(),
                  f"{key} {name}: output not finite")
            d = (got.float() - ref.float()).abs()
            e = d.max().item()
            e_last = (max(d[:, -ws:].max().item(), d[:, :, -ws:].max().item())
                      if key == "swin_proj_mlp" else _window_edge_err(d, grid))
            bound = SWIN_BUDGET * max(1.0, ref.float().abs().max().item())
            check(e <= bound, f"{key} {name}: max-abs {e} > {bound}")
            del ref, d
            t = cuda_ms(kernels[key])
            tp = cuda_ms(plains[key], iters=2, warmup=1)
            tl = ty = None
            if key in yardsticks:
                ty = cuda_ms(yardsticks[key])
            if key == "swin_attn_core":
                # SDPA on q, k, v [nwin, heads, n, 32] copied out of the
                # slot layout, the bias and masks as its bf16 mask
                q, k, v = (qkv[:, :n].reshape(-1, n, SWIN_HEADS, 3, 32)
                           [:, :, :, j].transpose(1, 2).contiguous()
                           for j in range(3))
                mask = _window_mask(wts.bias, ws, shift, grid)
                tl = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=1.0))
                del q, k, v, mask
            b = acc[key]["bound"].add(*work[key])
            tflops = work[key][0] / (t * 1e9)
            log(f"{key} {name} {h}x{w} ws {ws} shift {shift}"
                f"{' +extra' if extra else ''}: max-abs {e:.3e} (last window "
                f"row/col {e_last:.3e}, budget {bound:.3e})  kernel {t:.3f} "
                f"ms ({tflops:.1f} TFLOP/s)  plain {tp:.3f} ms"
                + (f"  SDPA {tl:.3f} ms" if tl is not None else "")
                + (f"  cuBLAS products {ty:.3f} ms" if ty is not None else "")
                + f"  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
            acc[key]["details"].append({
                "shape": [name, h, w, c, ws, shift, bool(extra)],
                "max_abs_err": e, "max_abs_err_last_row_col": e_last,
                "err_budget": bound, "ms": t, "plain_ms": tp,
                "tflops": tflops, "library_ms": tl, "yardstick_ms": ty, **b})
            a = acc[key]
            a["ms"] += t
            a["plain_ms"] += tp
            a["library_ms"] += tl or 0.0
            a["yardstick_ms"] += ty or 0.0
            a["flops"] += work[key][0]
            a["err"], a["edge"] = max(a["err"], e), max(a["edge"], e_last)
        del qkv, o, y, rows_t, hid, o2, yardsticks
        if not with_k7:
            continue
        # the chain against K7, same inputs and weights
        kw = dict(ws=ws, shift=shift, extra=e_in, precision=fast)
        yc = ska.swin_block_chain(x, wts, **kw)
        y7 = ska.swin_block_fused(x, wts, **kw)
        torch.cuda.synchronize()
        e = (yc.float() - y7.float()).abs().max().item()
        bound = SWIN_BUDGET * max(1.0, y7.float().abs().max().item())
        check(e <= bound, f"chain vs K7 {name}: max-abs {e} > {bound}")
        t_chain = cuda_ms(lambda: ska.swin_block_chain(x, wts, **kw))
        t_k7 = cuda_ms(lambda: ska.swin_block_fused(x, wts, **kw))
        t_sum = sum(acc[k]["details"][-1]["ms"] for k in keys)
        log(f"chain vs K7 {name} {h}x{w} ws {ws} shift {shift}: max-abs "
            f"{e:.3e} (budget {bound:.3e}, bit-equal "
            f"{bool(torch.equal(yc, y7))})  K10 + K9 + K11 {t_sum:.3f} ms "
            f"(chain call {t_chain:.3f} ms)  K7 {t_k7:.3f} ms")
        ab.append({"shape": [name, h, w, c, ws, shift, bool(extra)],
                   "max_abs_err": e, "err_budget": bound,
                   "bit_equal": bool(torch.equal(yc, y7)),
                   "kernels_sum_ms": t_sum, "chain_ms": t_chain,
                   "k7_ms": t_k7})
        del x, e_in, yc, y7, wts, blk
        torch.cuda.empty_cache()
    for key, e in _check_chain_ragged(rng).items():
        acc[key]["err_ragged"] = e
    replaces = {"swin_ln_qkv": 359, "swin_attn_core": 187,
                "swin_proj_mlp": 411}
    entries = []
    for key in keys:
        a = acc[key]
        core = key == "swin_attn_core"
        entries.append({
            "name": key, "route": "cuda",
            "source": "hdrvae_torch/csrc/swin_chain.cu",
            "replaces": f"hdrvae/kernels/swin_attention.py:{replaces[key]}",
            "max_abs_err": max(a["err"], a.get("err_ragged", 0.0)),
            "max_abs_err_last_row_col": a["edge"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], **a["bound"].entry(),
            "tflops": a["flops"] / (a["ms"] * 1e9),
            "library_ms": a["library_ms"] if core else None,
            "library_call": "F.scaled_dot_product_attention, bf16, the bias "
                            "and masks as a bf16 attn_mask" if core else
                            "none: no one PyTorch call computes it",
            **({} if core else {
                "yardstick_ms": a["yardstick_ms"],
                "yardstick_call": "cuBLAS's products alone, bf16 "
                                  "torch.matmul at the padded widths: " +
                                  ("x Wqkv" if key == "swin_ln_qkv" else
                                   "o Wp, y2 W1, GELU W2")}),
            "shapes": a["details"]})
    return entries, ab


@functools.cache
def _probe():
    """``tools/f32_dot_probe_torch.py``, loaded from the checkout."""
    spec = importlib.util.spec_from_file_location(
        "f32_dot_probe_torch", os.path.join(REPO, "tools",
                                            "f32_dot_probe_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_k12() -> list:
    """K12 at the probe's shape in its three precisions, each against its
    plain version on the probe's operands within K12_BUDGET * max|ref|;
    w's split (``split_w``) bit-equal to its plain version in both part
    counts, and launched once a tensor-core call (highest: never).  Their
    times come from the probe's run (``phase_f32_probe``)."""
    from hdrvae_torch.kernels import f32_dot
    m, k, n = K12_SHAPE
    x, w = _probe().operands(m, k, n)
    details, err, bnd = [], 0.0, Bound()
    for mode in f32_dot.PRECISIONS:
        before = (f32_dot.f32_dot.launches, f32_dot.split_w.launches)
        y = f32_dot.f32_dot(x, w, precision=mode)
        check((f32_dot.f32_dot.launches - before[0],
               f32_dot.split_w.launches - before[1])
              == (1, int(mode != "highest")),
              f"K12 {mode}: launches of f32_dot / split_w in one call "
              f"{f32_dot.f32_dot.launches - before[0]} / "
              f"{f32_dot.split_w.launches - before[1]}")
        ref = f32_dot.f32_dot_reference(x, w, precision=mode)
        torch.cuda.synchronize()
        check(torch.isfinite(y).all().item(), f"K12 {mode}: not finite")
        e = (y - ref).abs().max().item()
        bound = K12_BUDGET * ref.abs().max().item()
        check(e <= bound, f"K12 {mode}: max-abs {e} > {bound}")
        # FFMA outside the tensor cores; bf16 passes on them
        b = bnd.add(2 * m * n * k * K12_PASSES[mode], nbytes(x, w, y),
                    PEAK_F32 if mode == "highest" else PEAK_BF16)
        log(f"K12 f32_dot {mode} {m}x{k}x{n}: max-abs vs plain {e:.3e} "
            f"(budget {bound:.3e})  bound {b['bound_ms'] * 1e3:.2f} us "
            f"({b['bound_by']})")
        details.append({"precision": mode, "shape": [m, k, n],
                        "max_abs_err": e, "err_budget": bound, **b})
        err = max(err, e)
    split_bnd = Bound()
    for lo in (True, False):
        got = f32_dot.split_w(w, lo=lo)
        torch.cuda.synchronize()
        check(torch.equal(got, f32_dot.split_w_reference(w, lo=lo)),
              f"split_w lo={lo}: not bit-equal to its plain version")
        split_bnd.add(0, nbytes(w, got))
    split_ms = sum(cuda_ms(lambda lo=lo: f32_dot.split_w(w, lo=lo),
                           iters=10) for lo in (True, False))
    split_plain = sum(cuda_ms(lambda lo=lo: f32_dot.split_w_reference(
        w, lo=lo), iters=3) for lo in (True, False))
    log(f"split_w {k}x{n} (hi + lo, then hi): bit-equal to its plain "
        f"version  kernel {split_ms * 1e3:.2f} us  plain "
        f"{split_plain * 1e3:.2f} us  bound "
        f"{split_bnd.ms * 1e3:.2f} us (bytes)")
    return [{"name": "f32_dot", "route": "cuda",
             "source": "hdrvae_torch/csrc/f32_dot.cu",
             "replaces": "tools/perf/pallas_f32_dot_probe.py:45",
             "max_abs_err": err, **bnd.entry(),
             "library_call": "torch.matmul, float32, TF32 off, once a "
                             "precision (per precision in shapes: highest "
                             "that call, high none, default bf16 matmul "
                             "of pre-cast operands)", "shapes": details},
            {"name": "split_w", "route": "cuda",
             "source": "hdrvae_torch/csrc/f32_dot.cu",
             "replaces": "tools/perf/pallas_f32_dot_probe.py:39 (_kernel's "
                         "dot at DEFAULT / HIGH: w's bf16 parts)",
             "max_abs_err": 0.0, "err_budget": 0.0, "ms": split_ms,
             "plain_ms": split_plain, **split_bnd.entry(),
             "library_ms": None}]


def _wrappers() -> dict:
    """The kernel wrappers, by name; each counts its own launches."""
    from hdrvae_torch.kernels import (attention, conv3x3, dense_conv,
                                      epilogue, f32_dot, ocab,
                                      swin_attention)
    return {fn.__name__: fn for fn in (
        conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
        conv3x3.upconv_gn_conv3x3,
        attention.flash_attention_bf16, attention.flash_attention_3pass,
        attention.flash_attention_f32, attention.split_qkv,
        epilogue.collapse_and_stats_fused, dense_conv.dense_conv3x3,
        swin_attention.swin_block_fused, ocab.ocab_attention,
        swin_attention.ln_qkv, swin_attention.window_attention_core,
        swin_attention.proj_mlp, f32_dot.f32_dot, f32_dot.split_w)}


def _counts() -> dict:
    """Every counter; K2's stats_only launches and K3's masked ones under
    their own names."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        if hasattr(fn, "launches_masked"):
            counts[name + "_masked"] = fn.launches_masked
    counts["upsample_conv3x3_stats_only"] = \
        _wrappers()["upsample_conv3x3"].stats_only_launches
    return counts


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_masked"):
            fn.launches_masked = 0
    _wrappers()["upsample_conv3x3"].stats_only_launches = 0


def _unfused_fast():
    """The fast tier on the layers (upstack "xla"): what the fused fast
    chain is held to."""
    import dataclasses

    from hdrvae_torch.core.config import Precision
    return dataclasses.replace(Precision.fast(), upstack="xla")


def phase_decode():
    from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                          Precision)
    from hdrvae_torch.decode.pipeline import (decode_summary, hdr_decode,
                                              hdr_epilogue)
    from safetensors.torch import save_file

    from hdrvae_torch.models.decoder import decoder_apply
    from hdrvae_torch.models.params import init_decoder, load_decoder

    cfg = DecoderConfig()
    t0 = time.perf_counter()
    seeded = init_decoder(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in seeded.parameters())
    log(f"decoder: {n_params} parameters, weights from numpy seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    # the decode starts from a checkpoint file, as a user's does: the seeded
    # decoder under the ldm "decoder." prefix, read back by load_decoder
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ae.safetensors")
        save_file({"decoder." + k: t.cpu().contiguous()
                   for k, t in seeded.state_dict().items()}, path)
        size = os.path.getsize(path)
        dec = load_decoder(path)
    want, got = seeded.state_dict(), dec.state_dict()
    check(dec.cfg == cfg and set(got) == set(want)
          and all(torch.equal(got[k], want[k]) for k in want),
          "load_decoder: the loaded decoder is not bit-equal to the one "
          "written")
    check(next(dec.parameters()).is_cuda, "load_decoder: not on the card")
    log(f"load_decoder: {size} bytes of safetensors written and loaded in "
        f"{time.perf_counter() - t0:.1f} s; config inferred, weights "
        "bit-equal")
    del seeded, want, got
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 128, 128, cfg.z_channels)).astype(np.float32)).cuda()
    hcfg = HDRDecodeConfig(hdr_mode="conservative")
    tiers = {"fast": Precision.fast(), "parity": Precision.parity(),
             "mixed": Precision.mixed()}

    _reset_counts()
    results, summaries, per_tier, times = {}, {}, {}, {}
    for name, prec in tiers.items():
        before = _counts()
        walls = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start.record()
            res = hdr_decode(dec, z, hcfg, prec)
            end.record()
            summary = decode_summary(res)    # the one host fetch
            torch.cuda.synchronize()
            walls.append((start.elapsed_time(end),
                          1e3 * (time.perf_counter() - h0)))
        after = _counts()
        per_tier[name] = {k: after[k] - before[k] for k in after}
        results[name] = res
        summaries[name] = summary
        times[name] = walls
        check(tuple(res.image.shape) == (1, 1024, 1024, 3),
              f"{name}: image shape {tuple(res.image.shape)}")
        check(torch.isfinite(res.image).all().item()
              and torch.isfinite(res.standard).all().item(),
              f"{name}: non-finite output")
        log(f"decode[{name}] device ms per request "
            f"{[round(d, 3) for d, _ in walls]}, host wall ms "
            f"{[round(h, 3) for _, h in walls]}; launches {per_tier[name]}")
        log(f"decode[{name}] summary {json.dumps(summary, sort_keys=True)}")
    decode_counts = _counts()

    # each tier's mid attention: fast the bf16 kernel, mixed the 3-pass one,
    # parity the exact float32 one, and no other
    attn = ("flash_attention_bf16", "flash_attention_3pass",
            "flash_attention_f32")
    for name, want in (("fast", attn[0]), ("mixed", attn[1]),
                       ("parity", attn[2])):
        for kname in attn:
            ran = per_tier[name][kname]
            check(ran > 0 if kname == want else ran == 0,
                  f"{name} decode launched {kname} {ran} times")

    # fast tier: the fused chain vs the port's unfused fast path (the
    # layers' own ops, upstack "xla"), the way the JAX chain was held to
    # its XLA layers
    unfused = decoder_apply(dec, z, precision=_unfused_fast())
    e_fast = (results["fast"].standard - unfused.rgb).abs().max().item()
    check(e_fast <= CONV_BUDGET,
          f"fast fused vs unfused rgb max-abs {e_fast} > {CONV_BUDGET}")
    e_rgb = (results["mixed"].standard
             - results["parity"].standard).abs().max().item()
    e_cons = (results["mixed"].image
              - results["parity"].image).abs().max().item()
    check(e_rgb <= 3e-4, f"mixed vs parity rgb max-abs {e_rgb} > 3e-4")
    check(e_cons <= 1e-3,
          f"mixed vs parity conservative max-abs {e_cons} > 1e-3")
    log(f"fast fused vs unfused rgb max-abs {e_fast:.3e} (<= {CONV_BUDGET});"
        f" mixed vs parity rgb {e_rgb:.3e} (<= 3e-4), conservative "
        f"{e_cons:.3e} (<= 1e-3)")
    del unfused

    # the mixed tier with its low-resolution half in the fast tier's bf16:
    # the head's mid attention is the bf16 kernel's, on the layers
    head2 = Precision.mixed(fast_head_levels=2)
    before = _counts()
    res, summary, dev_ms, wall_ms, peak = _decode_request(dec, z, hcfg, head2)
    ran = {kname: _counts()[kname] - before[kname] for kname in attn}
    check(ran == {attn[0]: 1, attn[1]: 0, attn[2]: 0},
          f"mixed fast_head_levels=2 decode: attention launches {ran}, want "
          "one flash_attention_bf16")
    check(torch.isfinite(res.image).all().item(),
          "mixed fast_head_levels=2: non-finite output")
    e_head = (res.standard - results["parity"].standard).abs().max().item()
    check(e_head <= CONV_BUDGET, f"mixed fast_head_levels=2 vs parity rgb "
          f"max-abs {e_head} > {CONV_BUDGET}")
    times["mixed fast_head_levels=2"] = [(dev_ms, wall_ms)]
    log(f"decode[mixed fast_head_levels=2] device ms {dev_ms:.3f}, host wall "
        f"ms {wall_ms:.3f}, peak {peak:.3f} GiB; vs parity rgb max-abs "
        f"{e_head:.3e} (<= {CONV_BUDGET}); attention launches {ran}")
    del res

    # the fused epilogue (K4) in the fast and parity tiers, held to the
    # default path's image and summary
    fused_cfg = HDRDecodeConfig(hdr_mode="conservative",
                                use_fused_epilogue=True)
    _reset_counts()
    for name in ("fast", "parity"):
        res = hdr_decode(dec, z, fused_cfg, tiers[name])
        summary = decode_summary(res)
        e_img = (res.image - results[name].image).abs().max().item()
        e_sum = summary_rel_err(summary, summaries[name])
        check(e_img <= FUSED_EPI_BUDGET,
              f"fused epilogue {name}: image max-abs {e_img}")
        check(e_sum <= FUSED_EPI_BUDGET,
              f"fused epilogue {name}: summary rel err {e_sum}")
        log(f"decode[{name}, fused epilogue] image max-abs {e_img:.3e}, "
            f"summary rel {e_sum:.3e} vs the default path (<= "
            f"{FUSED_EPI_BUDGET})")
    epi_counts = _counts()
    del res

    out = decoder_apply(dec, z, precision=tiers["parity"])
    for mode in ("conservative", "exposure", "adaptive_recovery",
                 "mathematical_recovery"):
        image, fallback, analysis = hdr_epilogue(
            out.rgb, out.pre_conv_out, HDRDecodeConfig(hdr_mode=mode))
        check(torch.isfinite(image).all().item(), f"{mode}: non-finite")
        log(f"epilogue[{mode}] max {image.max().item():.6g} hdr_pixels "
            f"{int((image > 1).sum().item())} fallback "
            f"{bool(fallback.item())} norm "
            f"{int(analysis.norm_kind.item())}")
    return (results["parity"].image, decode_counts, per_tier, times,
            epi_counts, dec)


def _decode_request(dec, z, hcfg, prec, **kw):
    """One hdr_decode (``kw``: its bucketing) with its summary fetched:
    (result, summary, device ms, host wall ms, peak GiB of allocated
    memory)."""
    from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    res = hdr_decode(dec, z, hcfg, prec, **kw)
    end.record()
    summary = decode_summary(res)
    torch.cuda.synchronize()
    return (res, summary, start.elapsed_time(end),
            1e3 * (time.perf_counter() - h0),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _served_run(engine, latents, cfgs, threads: int = 1) -> tuple:
    """Submit each latent (with its config) to ``engine`` from ``threads``
    client threads, each taking every threads-th request in order; wait
    for all.  Returns (responses in request order, wall s from the first
    submit to the last result)."""
    import threading
    futs = [None] * len(latents)

    def client(k):
        for i in range(k, len(latents), threads):
            futs[i] = engine.submit(latents[i], cfgs[i])

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client, args=(k,))
               for k in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(120)
        check(not t.is_alive(), "serve: a client thread hung")
    responses = [f.result(300) for f in futs]
    return responses, time.perf_counter() - t0


def _latency_record(responses, wall_s: float) -> dict:
    lat = sorted(r.latency_s for r in responses)
    mp = sum(r.image.shape[0] * r.image.shape[1] * r.image.shape[2]
             for r in responses) / 1e6
    return {"latency_p50_s": lat[min(len(lat) - 1, len(lat) // 2)],
            "latency_p95_s": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "wall_s": wall_s, "mp_per_s": mp / wall_s,
            "requests": len(responses)}


def _same_response(label, resp, ref, summary) -> None:
    """A served response against the direct decode of its latent on the
    same route: the image bit-equal, the summary equal."""
    want = ref.image.cpu().numpy()
    check(resp.image.shape == want.shape and np.array_equal(resp.image, want),
          f"serve[{label}]: image not bit-equal to the direct decode (max "
          f"abs {np.abs(resp.image - want).max()})")
    check(json.dumps(resp.summary, sort_keys=True)
          == json.dumps(summary, sort_keys=True),
          f"serve[{label}]: summary differs from the direct decode's")


def phase_serve(dec, card: str) -> dict:
    """The served decode on the full-width decoder through a ``VAE``
    handle: a fast ``ServeEngine`` (depth 2, bucket 64) taking 1024^2
    latents at their bucket (the K1 / K2 / K3 chain) and 968 x 800 ones
    padded to it (K3 bf16 masked) from two client threads, some with the
    fused epilogue (K4); then a mixed engine (K3 3-pass, split_qkv); each
    response bit-equal to the direct decode of its latent on its route.
    The six fast requests at depth 1 and at depth 2 (latency p50 / p95,
    MP/s); a 512^2 request's latency against a 2048^2 request launched
    behind it; the HTTP front end's EXR responses and /healthz; and
    export_linear + verify_save of a served 1024^2 image.  Returns the
    phase's record."""
    import threading

    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.core.config import (ExportConfig, HDRDecodeConfig,
                                          Precision)
    from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
    from hdrvae_torch.io.exr import read_exr
    from hdrvae_torch.io.export import export_linear, verify_save
    from hdrvae_torch.serve.engine import ServeEngine
    from hdrvae_torch.serve.http import make_server

    t_phase = time.perf_counter()
    zc = dec.cfg.z_channels
    cons = HDRDecodeConfig(hdr_mode="conservative")
    epi = HDRDecodeConfig(hdr_mode="conservative", use_fused_epilogue=True)

    def latent(seed, h, w):
        return np.random.default_rng(seed).standard_normal(
            (1, h, w, zc)).astype(np.float32)

    def direct(z, cfg, prec, pad_to=None):
        res = hdr_decode(dec, torch.from_numpy(z).cuda(), cfg, prec,
                         pad_to=pad_to)
        return res, decode_summary(res)

    record = {"card": card}
    at = [latent(100 + i, 128, 128) for i in range(6)]
    off = [latent(110 + i, *BUCKET_LATENT) for i in range(2)]
    fast = VAE(decoder=dec, precision=Precision.fast())

    # the fast engine: six requests at their bucket (every other one with
    # the fused epilogue) and two off it, from two client threads
    with ServeEngine(fast, depth=2, bucket=64) as engine:
        engine.warmup([(128, 128), BUCKET_LATENT])
        lats = at + off
        cfgs = [epi if i % 2 else cons for i in range(6)] + [cons, cons]
        _reset_counts()
        responses, _ = _served_run(engine, lats, cfgs, threads=2)
        served = _counts()
        stats = engine.stats()
    for i, resp in enumerate(responses):
        check(resp.padded_hw == (128, 128),
              f"serve[fast {i}]: padded_hw {resp.padded_hw}")
    _reset_counts()
    refs = [direct(z, cfgs[i], fast.precision) for i, z in enumerate(at)]
    one = _counts()
    refs += [direct(z, cons, fast.precision, pad_to=(128, 128)) for z in off]
    for i, (resp, (ref, summary)) in enumerate(zip(responses, refs)):
        _same_response(f"fast {i}", resp, ref, summary)
    want = refs[0][0].image[0].cpu().numpy()     # at[0], conservative
    # the launches: the at-bucket requests ran the chain, as the direct
    # decodes did; the bucketed ones K3 bf16 masked and no chain
    for name in ("fused_conv3x3", "upsample_conv3x3"):
        check(served[name] == one[name] > 0, f"serve: {name} launched "
              f"{served[name]} times over the requests, the six direct "
              f"decodes at their bucket {one[name]}")
    check(served["flash_attention_bf16"] == 8
          and served["flash_attention_bf16_masked"] == 2,
          f"serve: K3 bf16 {served['flash_attention_bf16']} launches, "
          f"{served['flash_attention_bf16_masked']} masked, want 8 / 2")
    check(served["collapse_and_stats_fused"] == 3,
          f"serve: K4 {served['collapse_and_stats_fused']} launches, want 3")
    record["fast_launches"] = {k: v for k, v in served.items() if v}
    log(f"serve[fast] 8 responses (6 at bucket, 3 with K4; 2 at 121 x 100 "
        f"padded) bit-equal to the direct decodes; launches "
        f"{record['fast_launches']}; engine stats {stats}")
    del responses, refs

    # the six requests at depth 1 against depth 2, in one burst each
    with ServeEngine(fast, depth=1, bucket=64) as engine:
        engine.warmup([(128, 128)])
        burst1, wall1 = _served_run(engine, at, [cons] * 6)
    with ServeEngine(fast, depth=2, bucket=64) as engine:
        engine.warmup([(128, 128)])
        burst2, wall2 = _served_run(engine, at, [cons] * 6)
    record["depth1"] = _latency_record(burst1, wall1)
    record["depth2"] = _latency_record(burst2, wall2)
    for d in ("depth1", "depth2"):
        r = record[d]
        log(f"serve[fast 1024^2 x6, {d}] latency p50 "
            f"{1e3 * r['latency_p50_s']:.3f} ms, p95 "
            f"{1e3 * r['latency_p95_s']:.3f} ms, {r['mp_per_s']:.3f} MP/s "
            f"(wall {1e3 * r['wall_s']:.3f} ms); {card}")
    image = burst2[0].image
    check(np.array_equal(image[0], want),
          "serve: the depth-2 burst's first image is not the direct decode's")
    del burst1, burst2

    # stream order: a 512^2 request, then a 2048^2 one launched behind it;
    # the first one's fetch must not wait for the second one's kernels
    small, big = latent(120, 64, 64), latent(121, 256, 256)
    for _ in range(2):      # the second one warm
        _, _, big_ms, _, _ = _decode_request(
            dec, torch.from_numpy(big).cuda(), cons, fast.precision)
    with ServeEngine(fast, depth=2, bucket=64) as engine:
        engine.warmup([(64, 64), (256, 256)])
        order = []
        dispatch, finalize = engine._dispatch, engine._finalize

        def logged_dispatch(z, cfg, fetch_dtype=None):
            order.append(("dispatch", z.shape[1]))
            return dispatch(z, cfg, fetch_dtype)

        def logged_finalize(entry):
            order.append(("finalize", entry[1].padded_hw[0]))
            return finalize(entry)
        engine._dispatch, engine._finalize = logged_dispatch, logged_finalize
        f_small, f_big = engine.submit(small), engine.submit(big)
        r_small, r_big = f_small.result(300), f_big.result(300)
    check(order[:3] == [("dispatch", 64), ("dispatch", 256),
                        ("finalize", 64)],
          f"serve stream order: the worker ran {order}, want the 2048^2 "
          "request launched before the 512^2 one's fetch")
    check(1e3 * r_small.latency_s < 0.5 * big_ms,
          f"serve stream order: the 512^2 request took "
          f"{1e3 * r_small.latency_s:.3f} ms, not under half the 2048^2 "
          f"decode's {big_ms:.3f} device ms: its fetch waited")
    record["stream_order"] = {"small_latency_ms": 1e3 * r_small.latency_s,
                              "big_latency_ms": 1e3 * r_big.latency_s,
                              "big_device_ms": big_ms}
    log(f"serve[stream order] 512^2 latency {1e3 * r_small.latency_s:.3f} "
        f"ms with a 2048^2 request ({big_ms:.3f} device ms) launched behind "
        f"it, which took {1e3 * r_big.latency_s:.3f} ms")
    del r_small, r_big

    # the mixed engine, after the fast one: two 1024^2 requests
    mixed = VAE(decoder=dec, precision=Precision.mixed())
    with ServeEngine(mixed, depth=2, bucket=64) as engine:
        engine.warmup([(128, 128)])
        _reset_counts()
        responses, wall_m = _served_run(engine, at[:2], [cons, cons])
        served = _counts()
    for i, resp in enumerate(responses):
        ref, summary = direct(at[i], cons, mixed.precision)
        _same_response(f"mixed {i}", resp, ref, summary)
    check(served["flash_attention_3pass"] == served["split_qkv"] == 2
          and served["flash_attention_bf16"] == 0
          and served["flash_attention_f32"] == 0,
          f"serve[mixed]: attention launches {served}, want two 3-pass "
          "and two split_qkv")
    record["mixed"] = _latency_record(responses, wall_m)
    log(f"serve[mixed] 2 responses bit-equal to the direct decodes; "
        f"3-pass {served['flash_attention_3pass']}, split_qkv "
        f"{served['split_qkv']}; latency p50 "
        f"{1e3 * record['mixed']['latency_p50_s']:.3f} ms")
    del responses

    # HTTP: 32-bit and 16-bit EXR responses and /healthz
    import http.client
    import io
    with ServeEngine(fast, depth=2, bucket=64) as engine:
        srv = make_server(engine, host="127.0.0.1", port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            def post(path, body=None, method="POST"):
                conn = http.client.HTTPConnection(
                    "127.0.0.1", srv.server_address[1], timeout=300)
                try:
                    conn.request(method, path, body=body)
                    r = conn.getresponse()
                    return r.status, r.read()
                finally:
                    conn.close()
            buf = io.BytesIO()
            np.save(buf, at[0])
            body = buf.getvalue()
            with tempfile.TemporaryDirectory() as d:
                got = {}
                for depth in ("32bit", "16bit"):
                    status, data = post(
                        f"/v1/decode?format=exr&mode=conservative&"
                        f"bit_depth={depth}&compression=zip", body)
                    check(status == 200, f"serve http {depth}: {status} "
                          f"{data[:200]}")
                    path = os.path.join(d, depth + ".exr")
                    with open(path, "wb") as f:
                        f.write(data)
                    got[depth] = read_exr(path)
            check(np.array_equal(got["32bit"], want),
                  "serve http: the 32-bit EXR is not the engine's image")
            check(np.array_equal(got["16bit"], want.astype(np.float16)
                                 .astype(np.float32)),
                  "serve http: the 16-bit EXR is not its float16 cast")
            status, data = post("/healthz", method="GET")
            health = json.loads(data)
            check(status == 200 and health["backend"] == "cuda"
                  and health["device"] == torch.cuda.get_device_name(0),
                  f"serve http: /healthz {status} {health}")
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(30)
    log(f"serve[http] 32-bit and 16-bit zip EXR responses read back equal "
        f"to the image and its float16 cast; /healthz {health}")

    # decode -> 32-bit EXR + verify at card width
    with tempfile.TemporaryDirectory() as d:
        cfg = ExportConfig(filename_prefix="served", output_path=d,
                           bit_depth="32bit", compression="zip")
        t0 = time.perf_counter()
        res = export_linear(image, cfg)
        t_export = time.perf_counter() - t0
        check(res.error is None and res.verified,
              f"serve export: {res.error}")
        t0 = time.perf_counter()
        stats = verify_save(res.last)
        t_verify = time.perf_counter() - t0
        check(np.array_equal(read_exr(res.last), image[0]),
              "serve export: the EXR does not read back bit-exact")
        check(stats == {**res.verify_stats, "size_mb": stats["size_mb"]},
              "serve export: verify_save disagrees with the export's")
    record["export"] = {"write_s": t_export - t_verify, "verify_s": t_verify,
                        "export_linear_s": t_export,
                        "size_mb": stats["size_mb"]}
    log(f"serve[export] 1024^2 32-bit zip EXR: export_linear {t_export:.3f}"
        f" s (write {t_export - t_verify:.3f} s, verify_save "
        f"{t_verify:.3f} s), {stats['size_mb']:.3f} MB, read back bit-exact")
    record["phase_s"] = time.perf_counter() - t_phase
    log(f"serve phase {record['phase_s']:.1f} s; {card}")
    return record


def _bits(a: np.ndarray) -> np.ndarray:
    """float32 values as their bit patterns (NaN-safe equality)."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _cli(argv) -> tuple:
    """``hdrvae_torch.cli.main.main(argv)`` in this process: (its JSON
    stdout lines, wall s).  The CLI turns INFO logging on; it goes back to
    WARNING after."""
    import contextlib
    import io
    import logging

    from hdrvae_torch.cli import main as cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logging.getLogger().setLevel(logging.WARNING)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return ([json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")], wall)


def _timed_export(fn, *args, **kw) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    wall = time.perf_counter() - t0
    check(res.error is None and res.verified,
          f"{fn.__name__}: {res.error}")
    return res, wall


def phase_frontend(dec, image: torch.Tensor, card: str) -> dict:
    """The front end on the card (4c): ``cli decode`` at 2048^2 (fast, a
    16-bit PIZ EXR through the streamed export) against the direct decode
    of the same weights and latent; every compression at both depths on
    the 1024^2 image; ``cli run`` of the example workflow (HDRVAEDecode ->
    HDRUpscaleWithModel with a full-width ESRGAN x4 -> LinearEXRExport)
    against the same three nodes called directly; ``cli upscale
    --precision fast`` against the direct fast upscale.  Returns the
    phase's record."""
    from hdrvae_torch.api.nodes import (HDRUpscaleWithModel, HDRVAEDecode,
                                        LinearEXRExport)
    from hdrvae_torch.api.vae import VAE
    from hdrvae_torch.core.config import (ExportConfig, HDRDecodeConfig,
                                          Precision, UpscaleConfig)
    from hdrvae_torch.decode.pipeline import hdr_decode
    from hdrvae_torch.io import exr, native_build
    from hdrvae_torch.io.export import export_linear
    from hdrvae_torch.io.pipeline import export_frame_streamed
    from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet
    from hdrvae_torch.models.zoo import load_upscale_model
    from hdrvae_torch.upscale.pipeline import hdr_upscale

    t_phase = time.perf_counter()
    record = {"card": card}
    lib = native_build.load_native()
    check(lib is not None and lib._name == str(
        native_build.library_path()) and str(native_build.library_path())
        .startswith(os.path.join(REPO, "hdrvae_torch", "build")),
        f"the EXR codec was not built from the checkout: {lib}")
    env = {k: os.environ.get(k) for k in ("HDRVAE_OUTPUT_DIR",
                                          "HDRVAE_MODELS_DIR")}
    with tempfile.TemporaryDirectory() as out_dir, \
            tempfile.TemporaryDirectory() as models_dir:
        os.environ["HDRVAE_OUTPUT_DIR"] = out_dir
        os.environ["HDRVAE_MODELS_DIR"] = models_dir
        try:
            # (a) cli decode at full width, streamed to a 16-bit PIZ EXR
            _reset_counts()
            lines, wall_cli = _cli(["decode", "--size",
                                    str(FRONTEND_DECODE_EDGE),
                                    "--precision", "fast", "--bit-depth",
                                    "16bit", "--compression", "piz",
                                    "--prefix", "cli"])
            cli_counts = _counts()
            path = lines[-1]["filepath"]
            edge = FRONTEND_DECODE_EDGE // dec.cfg.spatial_scale
            z = np.random.default_rng(0).standard_normal(
                (1, edge, edge, dec.cfg.z_channels)).astype(np.float32)
            _reset_counts()
            direct = hdr_decode(dec, torch.from_numpy(z).cuda(),
                                HDRDecodeConfig(), Precision.fast()).image[0]
            direct_counts = _counts()
            check(cli_counts == direct_counts,
                  f"cli decode launches {cli_counts} != the direct "
                  f"decode's {direct_counts}")
            for name in ("fused_conv3x3", "upsample_conv3x3",
                         "flash_attention_bf16"):
                check(cli_counts[name] > 0, f"cli decode never ran {name}")
            got = exr.read_exr(path)
            want = direct.half().float().cpu().numpy()
            check(np.array_equal(_bits(got), _bits(want)),
                  "cli decode: the PIZ EXR is not the direct decode's "
                  "float16 cast")
            check(np.array_equal(_bits(want), _bits(
                direct.cpu().numpy().astype(np.float16).astype(np.float32))),
                "the card's float16 cast differs from numpy's")
            check(exr.read_exr_header(open(path, "rb").read())[0][
                "compression"] == "piz", "cli decode: not a PIZ file")
            launched = {k: v for k, v in cli_counts.items() if v}
            log(f"frontend[cli decode] 2048^2 fast -> 16-bit piz EXR in "
                f"{wall_cli:.3f} s (weights from seed 0 included), read back "
                f"bit-equal to the direct decode's float16 cast; launches "
                f"{launched} = the direct decode's; {card}")
            # the streamed export against the serial one, in turns
            cfg16 = ExportConfig(filename_prefix="t", output_path="",
                                 bit_depth="16bit", compression="piz")
            turns = {"serial": [], "streamed": []}
            files = {}
            for kind in ("serial", "streamed", "streamed", "serial"):
                fn = (export_linear if kind == "serial"
                      else export_frame_streamed)
                res, wall = _timed_export(
                    fn, direct, cfg16,
                    default_output_dir=os.path.join(out_dir, kind))
                turns[kind].append(wall)
                with open(res.last, "rb") as f:
                    files[kind] = f.read()
            check(files["serial"] == files["streamed"],
                  "streamed and serial exports differ")
            with open(path, "rb") as f:
                check(f.read() == files["serial"],
                      "cli decode's file is not the serial export's")
            record["cli_decode"] = {"wall_s": wall_cli,
                                    "launches": launched,
                                    "export_s": turns}
            log(f"frontend[export] 2048^2 16-bit piz of a card frame, "
                f"export_linear vs export_frame_streamed (with verify_save)"
                f": serial {[round(t, 4) for t in turns['serial']]} s, "
                f"streamed {[round(t, 4) for t in turns['streamed']]} s, "
                f"byte-identical; {card}")

            # (b) every compression at both depths on the 1024^2 image
            img = image[0].float().cpu().numpy()
            rows = []
            for comp in ("none", "rle", "zip", "piz", "pxr24"):
                for ptype in ("half", "float"):
                    p = os.path.join(out_dir, f"c_{comp}_{ptype}.exr")
                    t0 = time.perf_counter()
                    exr.write_exr(p, image[0], pixel_type=ptype,
                                  compression=comp)
                    t_write = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    back = exr.read_exr(p)
                    t_read = time.perf_counter() - t0
                    if ptype == "half":
                        want = img.astype(np.float16).astype(np.float32)
                    elif comp == "pxr24":
                        want = exr.float24_to_float(
                            exr.float_to_float24(img))
                    else:
                        want = img
                    check(np.array_equal(_bits(back), _bits(want)),
                          f"{comp} {ptype}: not read back bit-exact")
                    rows.append({"compression": comp, "pixel_type": ptype,
                                 "bytes": os.path.getsize(p),
                                 "write_s": t_write, "read_s": t_read})
                    log(f"frontend[exr] 1024^2 {comp:5s} {ptype:5s} "
                        f"{os.path.getsize(p):9d} bytes, write "
                        f"{t_write:.4f} s, read {t_read:.4f} s, bit-exact")
            record["compressions"] = rows

            # (c) cli run of the example workflow, then its nodes directly
            mdir = os.path.join(models_dir, "upscale_models")
            os.makedirs(mdir)
            ckpt = os.path.join(mdir, "RealESRGAN_x4plus.pth")
            torch.save(init_rrdbnet(RRDBNetConfig(), seed=2,
                                    device="cpu").state_dict(), ckpt)
            _reset_counts()
            lines, wall_run = _cli([
                "run", os.path.join(REPO, "workflow_examples",
                                    "hdr_decode_export.json"),
                "--size", str(FRONTEND_RUN_EDGE)])
            run_counts = _counts()
            run_path = lines[-1]["outputs"][0]
            with open(os.path.join(REPO, "workflow_examples",
                                   "hdr_decode_export.json")) as f:
                widgets = json.load(f)["nodes"][2]["widgets_values"]
            vae = VAE(decoder=dec)   # seed 0, the JAX node's parity tier
            edge = FRONTEND_RUN_EDGE // dec.cfg.spatial_scale
            z = np.random.default_rng(0).standard_normal(
                (1, edge, edge, dec.cfg.z_channels)).astype(np.float32)
            _reset_counts()
            t0 = time.perf_counter()
            (decoded,) = HDRVAEDecode().simple_hdr_decode(
                {"samples": z}, vae, "mathematical_recovery", 1.0)
            (up,) = HDRUpscaleWithModel().upscale(
                decoded, "RealESRGAN_x4plus.pth", False, False, "bislerp")
            (node_path,) = LinearEXRExport().export_linear_exr(up,
                                                               **widgets)
            wall_nodes = time.perf_counter() - t0
            node_counts = _counts()
            check(run_counts == node_counts,
                  f"cli run launches {run_counts} != the nodes' "
                  f"{node_counts}")
            check(run_counts["flash_attention_f32"] > 0,
                  "cli run: the parity decode never ran K3 f32")
            check(node_path != run_path and node_path.endswith(
                "_v002.exr"), f"nodes wrote {node_path}")
            with open(run_path, "rb") as fa, open(node_path, "rb") as fb:
                check(fa.read() == fb.read(),
                      "cli run's EXR differs from the nodes' one")
            net, _, arch = load_upscale_model(ckpt, device="cuda")
            ref = hdr_upscale(net, decoded.cuda(), UpscaleConfig(),
                              architecture=arch).image.cpu()
            check(torch.equal(up, ref), "the upscale node's image is not "
                  "hdr_upscale's of the decoded image")
            check(tuple(up.shape) == (1, 4 * FRONTEND_RUN_EDGE,
                                      4 * FRONTEND_RUN_EDGE, 3),
                  f"upscaled shape {tuple(up.shape)}")
            launched = {k: v for k, v in run_counts.items() if v}
            record["cli_run"] = {"wall_s": wall_run,
                                 "nodes_wall_s": wall_nodes,
                                 "launches": launched}
            log(f"frontend[cli run] hdr_decode_export.json at 1024^2 "
                f"(parity decode, ESRGAN x4 parity, 32-bit zip 4096^2 "
                f"EXR) {wall_run:.3f} s; the three nodes directly "
                f"{wall_nodes:.3f} s: the same file, the upscale equal to "
                f"hdr_upscale's; launches {launched} in both; {card}")

            # (c') cli upscale in the fast tier: the K6 chain
            src = os.path.join(out_dir, "decoded.npy")
            np.save(src, img)
            _reset_counts()
            lines, wall_up = _cli(["upscale", "--image", src, "--model",
                                   ckpt, "--precision", "fast",
                                   "--prefix", "fastup"])
            up_counts = _counts()
            _reset_counts()
            ref = hdr_upscale(net, torch.from_numpy(img)[None].cuda(),
                              UpscaleConfig(), architecture=arch,
                              precision=Precision.fast()).image[0]
            direct_counts = _counts()
            check(up_counts == direct_counts and
                  up_counts["dense_conv3x3"] > 0,
                  f"cli upscale launches {up_counts} vs the direct fast "
                  f"upscale's {direct_counts}")
            got = exr.read_exr(lines[-1]["filepath"])
            check(np.array_equal(_bits(got), _bits(ref.cpu().numpy())),
                  "cli upscale's EXR is not the direct fast upscale")
            launched = {k: v for k, v in up_counts.items() if v}
            record["cli_upscale"] = {"wall_s": wall_up,
                                     "launches": launched}
            log(f"frontend[cli upscale] ESRGAN x4 fast 1024^2 -> 4096^2 "
                f"32-bit zip EXR {wall_up:.3f} s, equal to the direct "
                f"fast upscale; launches {launched}; {card}")
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    HDRUpscaleWithModel._MODEL_CACHE.clear()
    del net, vae
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    check(record["phase_s"] <= FRONTEND_BUDGET_S,
          f"front-end phase {record['phase_s']:.1f} s > "
          f"{FRONTEND_BUDGET_S} s")
    log(f"front-end phase {record['phase_s']:.1f} s; {card}")
    return record


def phase_bucketed(dec):
    """The shape-bucketed decode on the full-width decoder: a [1, 121, 100,
    16] latent (seed 7) snapped to its bucket by ``BucketPolicy``, decoded
    through ``hdr_decode(pad_to=)`` in each tier and held to the
    unbucketed decode of the same latent on the same route (fast: the
    layers, upstack "xla", the route a bucketed decode takes).  Each
    bucketed decode must run its tier's attention kernel masked and, in
    the fast tier, no fused chain.  Returns (the masked attention launches
    per tier, the records)."""
    from hdrvae_torch.core.config import HDRDecodeConfig, Precision
    from hdrvae_torch.decode.buckets import BucketPolicy
    h, w = BUCKET_LATENT
    z = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, h, w, dec.cfg.z_channels)).astype(np.float32)).cuda()
    pad_to = BucketPolicy(BUCKET_EDGES).snap_hw(h, w)
    s = dec.cfg.spatial_scale
    cons = HDRDecodeConfig(hdr_mode="conservative", keep_standard=True)
    tiers = {"parity": (Precision.parity(), "flash_attention_f32"),
             "mixed": (Precision.mixed(), "flash_attention_3pass"),
             "fast": (Precision.fast(), "flash_attention_bf16")}
    masked, records = {}, {}
    for name, (prec, kernel) in tiers.items():
        ref_prec = _unfused_fast() if name == "fast" else prec
        _reset_counts()
        ref, ref_sum, ref_ms, _, ref_peak = _decode_request(dec, z, cons,
                                                            ref_prec)
        unb = _counts()
        _reset_counts()
        res, summary, dev_ms, wall_ms, peak = _decode_request(
            dec, z, cons, prec, pad_to=pad_to)
        counts = _counts()
        masked[name] = counts[kernel + "_masked"]
        for r in (ref, res):
            check(tuple(r.image.shape) == (1, h * s, w * s, 3)
                  and tuple(r.standard.shape) == (1, h * s, w * s, 3),
                  f"bucketed {name}: image shape {tuple(r.image.shape)}")
            check(torch.isfinite(r.image).all().item()
                  and torch.isfinite(r.standard).all().item(),
                  f"bucketed {name}: non-finite output")
        check(summary["input"] == ref_sum["input"],
              f"bucketed {name}: input stats {summary['input']} != "
              f"unbucketed {ref_sum['input']}")
        check(counts[kernel] == counts[kernel + "_masked"] == 1
              and unb[kernel + "_masked"] == 0,
              f"bucketed {name}: {kernel} launched {counts[kernel]} times, "
              f"{counts[kernel + '_masked']} masked (unbucketed "
              f"{unb[kernel + '_masked']}), want 1 / 1 (0)")
        check(counts["fused_conv3x3"] == 0,
              f"bucketed {name} ran the fused chain: {counts}")
        e_rgb = (res.standard - ref.standard).abs().max().item()
        e_img = (res.image - ref.image).abs().max().item()
        b_rgb, b_img = BUCKET_BUDGET[name]
        if name == "fast":
            b_rgb *= max(1.0, ref.standard.abs().max().item())
        check(e_rgb <= b_rgb, f"bucketed {name} vs unbucketed rgb max-abs "
              f"{e_rgb} > {b_rgb}")
        check(b_img is None or e_img <= b_img, f"bucketed {name} vs "
              f"unbucketed conservative max-abs {e_img} > {b_img}")
        records[name] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                         "peak_gib": peak, "unbucketed_device_ms": ref_ms,
                         "unbucketed_peak_gib": ref_peak,
                         "rgb_vs_unbucketed": e_rgb,
                         "image_vs_unbucketed": e_img,
                         "launches": {k: v for k, v in counts.items() if v}}
        log(f"bucketed[{name}] latent {h} x {w} -> {pad_to}: device ms "
            f"{dev_ms:.3f} (unbucketed {ref_ms:.3f}), host wall ms "
            f"{wall_ms:.3f}, peak {peak:.3f} GiB (unbucketed "
            f"{ref_peak:.3f}); vs unbucketed rgb max-abs {e_rgb:.3e} (<= "
            f"{b_rgb:.3e}), conservative {e_img:.3e}"
            + (f" (<= {b_img})" if b_img is not None else "")
            + f"; launches {records[name]['launches']}")
        del ref, res
        torch.cuda.empty_cache()
    return masked, records


def _latent(side: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, side, side, 16)).astype(np.float32)).cuda()


def phase_large_frames(dec):
    """The large-frame routes of hdr_decode on the full-width decoder:
    the fast tier's streamed top level (K2 stats_only + K5) and the mixed
    tier's staged executor, each held to the whole-image decode, with
    their times and peaks.  Returns (the low-memory 2048^2 request's
    launch counts, the records, the whole-image fast and mixed 2048^2
    results on the host: the slab phase's references)."""
    from hdrvae_torch.core.config import HDRDecodeConfig, Precision
    from hdrvae_torch.decode import pipeline, staged
    from hdrvae_torch.models import fused_tail
    from hdrvae_torch.models.decoder import decoder_apply
    cons = HDRDecodeConfig(hdr_mode="conservative")
    fast, mixed = Precision.fast(), Precision.mixed()
    records, refs = {}, {}
    lowmem_min = fused_tail.LOWMEM_MIN_PIXELS

    def run(label, z, prec, n=1):
        """n requests; the last one's result, counts, times and peak."""
        for _ in range(n):
            res = None      # no earlier result in this request's peak
            _reset_counts()
            res, summary, dev_ms, wall_ms, peak = _decode_request(
                dec, z, cons, prec)
        counts = _counts()
        check(tuple(res.image.shape) == (1, 8 * z.shape[1], 8 * z.shape[2],
                                         3), f"{label}: image shape "
              f"{tuple(res.image.shape)}")
        check(torch.isfinite(res.image).all().item()
              and torch.isfinite(res.standard).all().item(),
              f"{label}: non-finite output")
        records[label] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                          "peak_gib": peak}
        log(f"large[{label}] device ms {dev_ms:.3f}, host wall ms "
            f"{wall_ms:.3f}, peak {peak:.3f} GiB; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        return res, counts

    def host(res):
        """The standard and HDR images and the pre statistics on the host,
        so that no result of one route stays in the next one's peak."""
        return (res.standard.cpu(), res.image.cpu(),
                {k: v.item() for k, v in res.stats["pre"].items()})

    try:
        for side in (256, 512):
            z = _latent(side)
            px = f"{8 * side}^2"
            fused_tail.LOWMEM_MIN_PIXELS = 1 << 62
            res, cw = run(f"fast {px} whole-image", z, fast, 2)
            whole = host(res)
            del res
            check(cw["upconv_gn_conv3x3"] == 0
                  and cw["upsample_conv3x3_stats_only"] == 0,
                  f"whole-image fast {px} ran the streamed top level: {cw}")
            fused_tail.LOWMEM_MIN_PIXELS = 1
            res, cl = run(f"fast {px} low-memory", z, fast, 2)
            low = host(res)
            del res
            check(cl["upconv_gn_conv3x3"] == 1
                  and cl["upsample_conv3x3_stats_only"] == 1,
                  f"low-memory fast {px}: K5 / K2 stats_only launched "
                  f"{cl['upconv_gn_conv3x3']} / "
                  f"{cl['upsample_conv3x3_stats_only']} times, want 1 / 1")
            e = (low[0] - whole[0]).abs().max().item()
            check(e <= CONV_BUDGET, f"fast {px} low-memory vs whole-image "
                  f"rgb max-abs {e} > {CONV_BUDGET}")
            records[f"fast {px} low-memory"]["rgb_vs_whole"] = e
            if side == 256:
                main_counts = cl
                refs["fast"] = whole
                unfused = decoder_apply(dec, z,
                                        precision=_unfused_fast()).rgb.cpu()
                e_u = (low[0] - unfused).abs().max().item()
                check(e_u <= CONV_BUDGET, f"fast {px} low-memory vs unfused "
                      f"rgb max-abs {e_u} > {CONV_BUDGET}")
                records[f"fast {px} low-memory"]["rgb_vs_unfused"] = e_u
                del unfused
            log(f"large[fast {px}] low-memory vs whole-image rgb max-abs "
                f"{e:.3e} (<= {CONV_BUDGET})")
            del whole, low, z
            torch.cuda.empty_cache()
    finally:
        fused_tail.LOWMEM_MIN_PIXELS = lowmem_min

    # the mixed tier at 2048^2: staged (routed by the test hook) against
    # whole-image
    z = _latent(256)
    try:
        pipeline._STAGED_MIN_PIXELS_OVERRIDE = 1 << 62
        whole = refs["mixed"] = host(run("mixed 2048^2 whole-image", z,
                                         mixed)[0])
        pipeline._STAGED_MIN_PIXELS_OVERRIDE = 1
        st = host(run("mixed 2048^2 staged", z, mixed)[0])
    finally:
        pipeline._STAGED_MIN_PIXELS_OVERRIDE = None
    e_rgb = (st[0] - whole[0]).abs().max().item()
    e_cons = (st[1] - whole[1]).abs().max().item()
    e_pre = max(abs(st[2][k] - whole[2][k]) / max(abs(whole[2][k]), 1e-6)
                for k in whole[2])
    check(e_rgb <= STAGED_RGB, f"staged vs whole-image mixed rgb max-abs "
          f"{e_rgb} > {STAGED_RGB}")
    check(e_cons <= STAGED_CONS, f"staged vs whole-image mixed conservative "
          f"max-abs {e_cons} > {STAGED_CONS}")
    check(e_pre <= STAGED_PRE, f"staged vs whole-image mixed pre statistics "
          f"rel {e_pre} > {STAGED_PRE}")
    records["mixed 2048^2 staged"].update(
        rgb_vs_whole=e_rgb, conservative_vs_whole=e_cons,
        pre_stats_rel_vs_whole=e_pre)
    log(f"large[mixed 2048^2] staged vs whole-image rgb max-abs {e_rgb:.3e} "
        f"(<= {STAGED_RGB}), conservative {e_cons:.3e} (<= {STAGED_CONS}), "
        f"pre statistics rel {e_pre:.3e} (<= {STAGED_PRE})")
    del whole, st, z
    torch.cuda.empty_cache()

    # one request hdr_decode routes by itself: the smallest latent side (a
    # multiple of 8) whose output reaches STAGED_MIN_PIXELS
    side = 8
    while (8 * side) ** 2 < staged.STAGED_MIN_PIXELS:
        side += 8
    calls = []
    real = staged.staged_hdr_decode
    staged.staged_hdr_decode = lambda *a, **k: calls.append(1) or real(*a,
                                                                        **k)
    label = f"mixed {8 * side}^2 auto-routed"
    try:
        ca = run(label, _latent(side), mixed)[1]
    finally:
        staged.staged_hdr_decode = real
    check(calls == [1], f"a mixed {8 * side}^2 decode was not routed to the "
          "staged executor")
    # its mid attention (N = side^2 tokens) is the mixed tier's 3-pass one
    check(ca["flash_attention_3pass"] == 1 and ca["flash_attention_f32"] == 0,
          f"{label}: flash_attention_3pass / _f32 launched "
          f"{ca['flash_attention_3pass']} / {ca['flash_attention_f32']} "
          "times, want 1 / 0")
    r = records[label]
    log(f"large[{label}] mid attention over N = {side * side} tokens: "
        f"device ms {r['device_ms']:.3f}, peak {r['peak_gib']:.3f} GiB "
        f"(with the exact float32 attention, as PERF.md records it: "
        f"{F32_AUTO_ROUTED[0]} ms, {F32_AUTO_ROUTED[1]} GiB)")
    torch.cuda.empty_cache()
    return main_counts, records, refs


def phase_slab(dec, refs):
    """The slab-sharded decode across SLAB_RANKS ranks on the one card
    (gloo: NCCL takes no two ranks on one device), started by the port's
    launcher: ``sharded_slab_decode`` of the 2048^2 latent of the
    large-frame phase with ``tail_levels=2``, fast on the chain (K1 / K2
    with owned_rows, K3 bf16) and mixed on the layers (K3 3-pass), two
    requests each, the second timed and counted on every rank; every rank's
    image the same, held to the whole-image decode of its tier (``refs``).
    Returns (the fast request's launch counts summed over the ranks, the
    records)."""
    from hdrvae_torch.core.config import HDRDecodeConfig, Precision
    from hdrvae_torch.sharding import multihost
    cons = HDRDecodeConfig(hdr_mode="conservative")
    z = _latent(256).cpu()
    cases = [multihost.SlabCase(tier, "flux", z, cons, prec, tail_levels=2,
                                requests=2)
             for tier, prec in (("fast", Precision.fast()),
                                ("mixed", Precision.mixed()))]
    sd = {k: v.cpu() for k, v in dec.state_dict().items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.RankGroup(SLAB_RANKS, {"flux": (dec.cfg, sd)}, cases,
                                device="cuda").wait(timeout=300)
    log(f"slab: {SLAB_RANKS} ranks ({ranks[0][0]['backend']}, "
        f"{[r[0]['device'] for r in ranks]}) started, decoded and returned "
        f"in {time.perf_counter() - t0:.1f} s")
    records, summed = {}, {}
    for i, case in enumerate(cases):
        recs = [r[i] for r in ranks]
        got = recs[0]
        check(all(torch.equal(r["image"], got["image"])
                  and torch.equal(r["standard"], got["standard"])
                  for r in recs), f"slab {case.name}: ranks disagree")
        check(torch.isfinite(got["image"]).all().item()
              and tuple(got["image"].shape) == (1, 2048, 2048, 3),
              f"slab {case.name}: image {tuple(got['image'].shape)}, "
              "non-finite or of the wrong shape")
        std, img, pre = refs[case.name]
        e_rgb = (got["standard"] - std).abs().max().item()
        e_img = (got["image"] - img).abs().max().item()
        e_pre = max(abs(got["summary"]["pre"][k] - pre[k])
                    / max(abs(pre[k]), 1e-6) for k in pre)
        if case.name == "fast":
            bar = SLAB_FAST * max(1.0, std.abs().max().item())
            check(e_rgb <= bar, f"slab fast vs whole-image rgb max-abs "
                  f"{e_rgb} > {bar}")
        else:
            check(e_rgb <= SLAB_MIXED[0] and e_img <= SLAB_MIXED[1],
                  f"slab mixed vs whole-image rgb {e_rgb} (<= "
                  f"{SLAB_MIXED[0]}), conservative {e_img} (<= "
                  f"{SLAB_MIXED[1]})")
        counts = {}
        for r in recs:
            for k, v in r["counts"].items():
                counts[k] = counts.get(k, 0) + v
        summed[case.name] = counts
        records[case.name] = {
            "rgb_vs_whole": e_rgb, "conservative_vs_whole": e_img,
            "pre_stats_rel_vs_whole": e_pre,
            "device_ms": [r["device_ms"] for r in recs],
            "wall_ms": [r["wall_ms"] for r in recs],
            "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in recs],
            "launches": {k: v for k, v in counts.items() if v}}
        log(f"slab[{case.name}] vs whole-image: rgb max-abs {e_rgb:.3e}, "
            f"conservative {e_img:.3e}, pre statistics rel {e_pre:.3e}; "
            "device ms by rank "
            f"{[round(r['device_ms'], 3) for r in recs]}, peak GiB "
            f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in recs]} (both "
            "ranks share one card: no multi-GPU speedup is measured here); "
            f"launches summed over the ranks {records[case.name]['launches']}")
    fast, mixed = summed["fast"], summed["mixed"]
    for k in ("fused_conv3x3.owned_launches",
              "upsample_conv3x3.owned_launches",
              "flash_attention_bf16.launches"):
        check(fast[k] > 0, f"slab fast never ran {k}")
    check(mixed["flash_attention_3pass.launches"] > 0
          and mixed["fused_conv3x3.launches"] == 0,
          f"slab mixed: K3 3-pass / K1 launched "
          f"{mixed['flash_attention_3pass.launches']} / "
          f"{mixed['fused_conv3x3.launches']} times, want > 0 / 0")
    return fast, records


def _close(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """|got - ref|'s max, mean and p99.9, and max|ref|, on the host."""
    d = (got.float().cpu() - ref.float().cpu()).abs()
    return {"max": d.max().item(), "mean": d.mean().item(), "p999": p999(d),
            "ref_max": ref.float().abs().max().item()}


def _short(kernel: str) -> str:
    """A profiler kernel name without its return type, anonymous
    namespace and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", kernel)
    return name.split("(")[0][:80]


class _RankRecords(logging.Handler):
    """The rank records that the CLI logs (``rank_record``), in order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if hasattr(record, "rank_record"):
            self.records.append(record.rank_record)

    def take(self) -> list:
        out, self.records = self.records, []
        return out


def _rank_counts(recs) -> dict:
    """The launch counts of ranks' records, summed; nonzero ones."""
    counts = {}
    for r in recs:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    return {k: v for k, v in counts.items() if v}


def phase_tiled(dec, image: torch.Tensor, refs, lf_records, card) -> dict:
    """The tile grid across ranks (its own limit, TILED_BUDGET_S): the
    full-width decoder's ``sharded_tiled_decode`` of the large-frame
    phase's 2048^2 latent (tile 64, overlap 8, conservative, the fused
    epilogue), fast ``per_tile`` (K1 / K2 / K3 bf16 chain, K4) and
    ``global`` (the GroupNorm tape, the layers, K3 bf16, K4) on 2 gloo
    ranks sharing the card and on 1 NCCL rank, and mixed ``global`` on the
    2 ranks; each held to the whole-image decode of its tier (``refs``:
    its seam error's mean and p99.9 inside ``TILED_SEAM``'s bands) with
    the ranks agreeing; one fast per_tile request profiled on each rank.
    The fast x4 ESRGAN and SwinIR-M ``sharded_hdr_upscale`` of the 1024^2
    image on the 2 ranks, bit-equal to ``hdr_upscale`` in this process.
    Then ``cli decode --tiled --mesh 2`` and ``cli upscale --sharded`` (one
    rank a card), the ranks' records read from the CLI's log.  Returns the
    phase's record."""
    from hdrvae_torch.core.config import (HDRDecodeConfig, Precision,
                                          UpscaleConfig)
    from hdrvae_torch.io import exr
    from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet
    from hdrvae_torch.models.swinir import SwinIRConfig, init_swinir
    from hdrvae_torch.models.zoo import upscaler_state_dict
    from hdrvae_torch.sharding import multihost

    t_phase = time.perf_counter()
    record = {"card": card}
    cons = HDRDecodeConfig(hdr_mode="conservative", use_fused_epilogue=True)
    fast, mixed = Precision.fast(), Precision.mixed()
    z = _latent(256).cpu()
    grid = dict(latent_tile=TILED_TILE, latent_overlap=TILED_OVERLAP)

    def tiled(name, prec, ns, **kw):
        return multihost.TiledCase(name, "flux", z, cons, prec,
                                   norm_stats=ns, **grid, **kw)

    decodes = [tiled("fast per_tile", fast, "per_tile", requests=2),
               tiled("fast global", fast, "global", requests=2),
               tiled("mixed global", mixed, "global", requests=2),
               tiled("fast per_tile profiled", fast, "per_tile",
                     profile=True)]
    nets = {"ESRGAN": init_rrdbnet(RRDBNetConfig(), seed=2, device="cuda"),
            "SwinIR": init_swinir(SwinIRConfig(), seed=3, device="cuda")}
    upscales = [multihost.UpscaleCase(name, name, image.cpu(),
                                      UpscaleConfig(), fast, requests=2)
                for name in nets]
    sd = {k: v.cpu() for k, v in dec.state_dict().items()}
    ups = {name: (name, upscaler_state_dict(net))
           for name, net in nets.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = multihost.RankGroup(TILED_RANKS, {"flux": (dec.cfg, sd)},
                              decodes + upscales, upscalers=ups,
                              device="cuda").wait(timeout=600)
    t_two = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = multihost.RankGroup(1, {"flux": (dec.cfg, sd)}, decodes[:2],
                              device="cuda").wait(timeout=300)
    t_one = time.perf_counter() - t0
    log(f"tiled: {TILED_RANKS} ranks ({two[0][0]['backend']}) in "
        f"{t_two:.1f} s, 1 rank ({one[0][0]['backend']}) in {t_one:.1f} s")
    check(two[0][0]["backend"] == "gloo" and one[0][0]["backend"] == "nccl",
          f"backends {two[0][0]['backend']} / {one[0][0]['backend']}, want "
          "gloo / nccl")
    whole_ms = {t: lf_records[f"{t} 2048^2 whole-image"]["device_ms"]
                for t in ("fast", "mixed")}
    record["decode"] = {}
    seam = {}
    for group, ranks in ((f"{TILED_RANKS} ranks", two), ("1 rank", one)):
        for i, case in enumerate(decodes if ranks is two else decodes[:2]):
            recs = [r[i] for r in ranks]
            got = recs[0]
            check(len({r["digest"] for r in recs}) == 1,
                  f"tiled {case.name} on {group}: ranks disagree")
            check(tuple(got["image"].shape) == (1, 2048, 2048, 3)
                  and torch.isfinite(got["image"]).all().item(),
                  f"tiled {case.name} on {group}: image "
                  f"{tuple(got['image'].shape)}, non-finite or wrong shape")
            tier = case.name.split()[0]
            std, img, _ = refs[tier]
            e_rgb = _close(got["standard"], std)
            e_img = _close(got["image"], img)
            counts = _rank_counts(recs)
            rec = {"device_ms": [r["device_ms"] for r in recs],
                   "wall_ms": [r["wall_ms"] for r in recs],
                   "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in recs],
                   "whole_image_device_ms": whole_ms[tier],
                   "rgb_vs_whole": e_rgb, "conservative_vs_whole": e_img,
                   "launches": counts}
            if case.profile:
                rec["top5"] = [[(_short(n), c, ms) for n, c, ms in r["top"]]
                               for r in recs]
                rec["kernel_ms"] = [r["kernel_ms"] for r in recs]
            record["decode"][f"{case.name}, {group}"] = rec
            seam[(case.name, group)] = e_rgb["max"] / max(
                1.0, e_rgb["ref_max"])
            for stat, want in zip(("mean", "p999"), TILED_SEAM[
                    case.name.replace(" profiled", "")]):
                check(want / TILED_SEAM_BAND <= e_rgb[stat]
                      <= want * TILED_SEAM_BAND,
                      f"tiled {case.name} on {group}: seam {stat} "
                      f"{e_rgb[stat]} outside [{want / TILED_SEAM_BAND}, "
                      f"{want * TILED_SEAM_BAND}]")
            log(f"tiled[{case.name}, {group}] vs whole-image: rgb max-abs "
                f"{e_rgb['max']:.4e} (mean {e_rgb['mean']:.4e}, p99.9 "
                f"{e_rgb['p999']:.4e}), conservative max-abs "
                f"{e_img['max']:.4e}; device ms by rank "
                f"{[round(r['device_ms'], 3) for r in recs]} (whole-image "
                f"{whole_ms[tier]:.3f}), peak GiB "
                f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in recs]}; "
                f"launches summed {counts}")
            if case.profile:
                for r, top in zip(recs, rec["top5"]):
                    log(f"tiled[{case.name}] rank {r['rank']} kernels "
                        f"{r['kernel_ms']:.3f} device ms in all; top-5 "
                        "(launches): " + ", ".join(
                            f"{n} {ms:.3f} ({c})" for n, c, ms in top))
            if tier == "fast" and "per_tile" in case.name:
                for k in ("fused_conv3x3.launches",
                          "upsample_conv3x3.launches",
                          "flash_attention_bf16.launches",
                          "collapse_and_stats_fused.launches"):
                    check(counts.get(k, 0) > 0,
                          f"tiled {case.name} on {group} never ran {k}")
            if case.name == "fast global":
                check(counts.get("flash_attention_bf16.launches", 0) > 0
                      and counts.get("collapse_and_stats_fused.launches",
                                     0) > 0
                      and "fused_conv3x3.launches" not in counts,
                      f"tiled fast global on {group}: {counts}, want K3 "
                      "bf16 and K4 on the layers, no K1")
            if case.name == "mixed global":
                check(counts.get("flash_attention_3pass.launches", 0) > 0,
                      f"tiled mixed global never ran K3 3-pass: {counts}")
    for name in ("fast per_tile", "fast global"):
        a = two[0][[c.name for c in decodes].index(name)]["image"]
        b = one[0][[c.name for c in decodes].index(name)]["image"]
        e = _close(a, b)
        record["decode"][f"{name}, 2 ranks vs 1"] = e
        bar = CONV_BUDGET * max(1.0, e["ref_max"])
        check(e["max"] <= bar, f"tiled {name}: 2 ranks vs 1 max-abs "
              f"{e['max']} > {bar}")
        log(f"tiled[{name}] {TILED_RANKS} ranks vs 1: max-abs "
            f"{e['max']:.4e}")
    g, t = (seam[(n, f"{TILED_RANKS} ranks")]
            for n in ("fast global", "fast per_tile"))
    check(g < t, f"tiled fast: global seam {g} not below per_tile's {t}")

    # the sharded upscales against hdr_upscale in this process
    record["upscale"] = {}
    for j, case in enumerate(upscales):
        recs = [r[len(decodes) + j] for r in two]
        check(len({r["digest"] for r in recs}) == 1,
              f"sharded {case.name} upscale: ranks disagree")
        for _ in range(2):
            ref, dev_ms, wall_ms, peak = _upscale_request(
                nets[case.name], image, UpscaleConfig(), fast,
                architecture=case.name)
        e = _close(recs[0]["image"], ref.image)
        counts = _rank_counts(recs)
        kernel = {"ESRGAN": "dense_conv3x3.launches",
                  "SwinIR": "swin_block_fused.launches"}[case.name]
        check(counts.get(kernel, 0) > 0,
              f"sharded {case.name} upscale never ran {kernel}")
        # the same tiles through the same kernels: bit-equal
        check(e["max"] == 0 and recs[0]["digest"] == multihost.digest(
                  ref.image),
              f"sharded {case.name} vs single-rank: max-abs {e['max']}, "
              "not bit-equal")
        record["upscale"][case.name] = {
            "device_ms": [r["device_ms"] for r in recs],
            "single_rank_device_ms": dev_ms, "vs_single_rank": e,
            "bit_equal": True,
            "peak_gib": [r["peak_bytes"] / 2 ** 30 for r in recs],
            "launches": counts}
        log(f"sharded upscale[{case.name} x4 fast, {TILED_RANKS} ranks] "
            f"device ms by rank {[round(r['device_ms'], 3) for r in recs]}"
            f" (single rank {dev_ms:.3f}); vs single rank max-abs "
            f"{e['max']:.4e}, mean {e['mean']:.4e}, p99.9 {e['p999']:.4e}; "
            f"launches summed {counts}")
        del ref
    del nets
    torch.cuda.empty_cache()

    # the CLI: decode --tiled --mesh 2, upscale --sharded (one rank a card);
    # each rank's record comes from the CLI's log
    rank_log = _RankRecords()
    cli_log = logging.getLogger("hdrvae_torch.cli")
    cli_level = cli_log.level
    cli_log.setLevel(logging.INFO)
    cli_log.addHandler(rank_log)
    env = os.environ.get("HDRVAE_OUTPUT_DIR")
    with tempfile.TemporaryDirectory() as out_dir:
        os.environ["HDRVAE_OUTPUT_DIR"] = out_dir
        try:
            outs, wall = _cli(["decode", "--tiled", "--mesh", "2", "--size",
                               "2048", "--bit-depth", "16bit",
                               "--compression", "piz", "--prefix", "tiled"])
            recs = rank_log.take()
            counts = _rank_counts(recs)
            check(len(outs) == 2 and "used_fallback" in outs[0]
                  and len(recs) == 2
                  and counts.get("fused_conv3x3.owned_launches", 0) > 0,
                  f"cli decode --tiled: lines {outs}, launches {counts}")
            back = exr.read_exr(outs[1]["filepath"])
            check(back.shape == (2048, 2048, 3) and np.isfinite(back).all(),
                  f"cli decode --tiled: file {back.shape}")
            record["cli_decode_tiled"] = {"wall_s": wall,
                                          "launches": counts}
            log(f"cli decode --tiled --mesh 2 --size 2048: {wall:.2f} s, "
                f"{outs[1]['filepath']} reads back {back.shape}; launches "
                f"summed over the ranks {counts}")
            ckpt = os.path.join(out_dir, "esrgan.pth")
            net = init_rrdbnet(RRDBNetConfig(), seed=2, device="cuda")
            torch.save(net.state_dict(), ckpt)
            npy = os.path.join(out_dir, "image.npy")
            np.save(npy, image[0].cpu().numpy())
            outs, wall = _cli(["upscale", "--sharded", "--image", npy,
                               "--model", ckpt, "--precision", "fast",
                               "--bit-depth", "16bit", "--compression",
                               "piz", "--prefix", "sharded"])
            recs = rank_log.take()
            counts = _rank_counts(recs)
            check(len(outs) == 2 and outs[0]["sharded"] is True
                  and outs[0]["out_shape"] == [1, 4096, 4096, 3]
                  and len(recs) == torch.cuda.device_count()
                  and counts.get("dense_conv3x3.launches", 0) > 0,
                  f"cli upscale --sharded: lines {outs}, launches {counts}")
            ref = _upscale_request(net, image, UpscaleConfig(), fast)[0]
            back = torch.from_numpy(exr.read_exr(outs[1]["filepath"]))
            e = _close(back, ref.image[0].half())
            # the file holds hdr_upscale's image in float16, bit for bit
            check(e["max"] == 0,
                  f"cli upscale --sharded vs hdr_upscale: {e}")
            record["cli_upscale_sharded"] = {"wall_s": wall,
                                             "vs_single_rank": e,
                                             "launches": counts}
            log(f"cli upscale --sharded ({len(recs)} rank, "
                f"{recs[0]['backend']}): {wall:.2f} s; the "
                f"file vs hdr_upscale's float16 max-abs {e['max']:.4e}, "
                f"mean {e['mean']:.4e}; launches {counts}")
            del net, ref, back
        finally:
            cli_log.removeHandler(rank_log)
            cli_log.setLevel(cli_level)
            if env is None:
                os.environ.pop("HDRVAE_OUTPUT_DIR", None)
            else:
                os.environ["HDRVAE_OUTPUT_DIR"] = env
    torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    check(record["phase_s"] <= TILED_BUDGET_S,
          f"tiled phase {record['phase_s']:.1f} s > {TILED_BUDGET_S} s")
    log(f"tiled phase {record['phase_s']:.1f} s (<= {TILED_BUDGET_S} s); "
        f"{card}")
    return record


def _start_cli_serve(argv, cwd) -> tuple:
    """``cli serve`` started as a subprocess in ``cwd``, its standard error
    into ``cwd/err.log``: (the process, the list of (arrival s, line) its
    reader thread fills with its standard output)."""
    import threading
    t0 = time.perf_counter()
    with open(os.path.join(cwd, "err.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hdrvae_torch.cli.main", "serve", *argv],
            stdout=subprocess.PIPE, stderr=err, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=cwd)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line))
    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def _stop_cli_serve(proc, cwd) -> tuple:
    """SIGTERM to a ``cli serve`` subprocess, killed if it outlives 120 s:
    (its exit code, seconds to exit, its standard error)."""
    import signal
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=120)
    finally:
        proc.kill()
        proc.wait()
    with open(os.path.join(cwd, "err.log")) as f:
        return proc.returncode, time.perf_counter() - t0, f.read()


def _http(port: int, method: str, path: str, body=None) -> tuple:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def phase_serve_ranks(dec, card: str, one_rank: dict) -> dict:
    """Serving across ranks (its own limit, SERVE_RANKS_BUDGET_S): the
    full-width decoder's ``ServeEngine(mesh=)`` on rank 0 of
    SERVE_RANKS gloo ranks sharing the card (``multihost.ServeCase``, two
    client threads, the followers in ``serve.ranks.follow``): a fast engine
    without a bucket taking four 2048^2 latents at their shape (the chain:
    K1 / K2 owned_rows, K3 bf16), a fast engine with bucket 64 two
    [1, 121, 100, 16] latents (pad_to: the layers, K3 bf16 masked), a
    mixed engine two 1024^2 latents (K3 3-pass, split_qkv); each response
    bit-equal to the same ranks' direct ``sharded_slab_decode`` of its
    latent and within SLAB_FAST / SLAB_MIXED of this process's
    whole-image decode; one fast 2048^2 slab request profiled on each
    rank.  One NCCL rank serving two fast 2048^2 requests.  ``cli serve
    --sharded --mesh 2`` as a subprocess: one 32-bit EXR response equal to
    the fast engine's image, /healthz with 2 devices, SIGTERM and no rank
    left.  Latency p50 / p95 and MP/s of each engine beside phase 4b's
    one-rank engine (``one_rank``).  Returns the phase's record."""
    import io

    from hdrvae_torch.core.config import HDRDecodeConfig, Precision
    from hdrvae_torch.decode.pipeline import hdr_decode
    from hdrvae_torch.io import exr
    from hdrvae_torch.sharding import multihost

    t_phase = time.perf_counter()
    record = {"card": card}
    cons = HDRDecodeConfig(hdr_mode="conservative")
    fast = Precision.fast()
    zc = dec.cfg.z_channels

    def latent(seed, h, w):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, h, w, zc)).astype(np.float32))

    # engine: (tier, latents, bucket, the direct call's pad_to)
    engines = {
        "fast": (fast, [latent(130 + i, 256, 256) for i in range(4)],
                 "default", None),
        "fast bucket 64": (fast, [latent(140 + i, *BUCKET_LATENT)
                                  for i in range(2)], 64, (128, 128)),
        "mixed": (Precision.mixed(), [latent(150 + i, 128, 128)
                                      for i in range(2)], "default", None)}
    S, R = multihost.SlabCase, multihost.ServeRequest
    cases = [S(f"direct {name} {i}", "flux", z, cons, prec, pad_to=pad_to,
               requests=2 if i == 0 else 1)
             for name, (prec, zs, _, pad_to) in engines.items()
             for i, z in enumerate(zs)]
    big = engines["fast"][1]
    cases.append(S("profiled", "flux", big[0], cons, fast, profile=True))
    cases += [multihost.ServeCase(name, "flux", [R(z, cons) for z in zs],
                                  prec, bucket=bucket,
                                  warmup=(tuple(zs[0].shape[1:3]),))
              for name, (prec, zs, bucket, _) in engines.items()]
    nccl_cases = [S("direct nccl 0", "flux", big[0], cons, fast, requests=2),
                  S("direct nccl 1", "flux", big[1], cons, fast),
                  multihost.ServeCase("nccl", "flux",
                                      [R(z, cons) for z in big[:2]], fast,
                                      warmup=((256, 256),))]
    sd = {k: v.cpu() for k, v in dec.state_dict().items()}
    torch.cuda.empty_cache()
    # cli serve --sharded starts now (random weights from seed 0: the
    # phase's decoder), beside the two groups, and is checked after them
    cli_dir = tempfile.mkdtemp(prefix="hdrvae_serve_")
    cli, lines = _start_cli_serve(["--sharded", "--mesh", str(SERVE_RANKS),
                                   "--port", "0"], cli_dir)
    try:
        t0 = time.perf_counter()
        two = multihost.RankGroup(SERVE_RANKS, {"flux": (dec.cfg, sd)}, cases,
                                  device="cuda").wait(timeout=300)
        t_two = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = multihost.RankGroup(1, {"flux": (dec.cfg, sd)}, nccl_cases,
                                  device="cuda").wait(timeout=300)
        t_one = time.perf_counter() - t0
        by_name = {}
        for ranks in (two, one):
            for i, rec in enumerate(ranks[0]):
                by_name[rec["name"]] = [r[i] for r in ranks]
        check(by_name["fast"][0]["backend"] == "gloo"
              and by_name["nccl"][0]["backend"] == "nccl",
              f"serve ranks: backends {by_name['fast'][0]['backend']} / "
              f"{by_name['nccl'][0]['backend']}, want gloo / nccl")
        log(f"serve ranks: {SERVE_RANKS} gloo ranks in {t_two:.1f} s, 1 NCCL "
            f"rank in {t_one:.1f} s")

        record["engines"] = {}
        for name in (*engines, "nccl"):
            prec, zs, _, pad_to = engines["fast" if name == "nccl" else name]
            zs = zs[:2] if name == "nccl" else zs
            recs = by_name[name]
            rank0 = recs[0]
            check("refused" not in rank0 and all(r["ok"] for r in
                                                 rank0["responses"]),
                  f"serve ranks[{name}]: {rank0.get('refused')} "
                  f"{[r.get('error') for r in rank0['responses']]}")
            check(all(r["served"] == len(zs) + 1 for r in recs[1:]),
                  f"serve ranks[{name}]: the followers served "
                  f"{[r['served'] for r in recs[1:]]}, want {len(zs) + 1} "
                  "(the warm-up and the requests)")
            errs, bars, direct_ms = [], [], []
            for i, (z, resp) in enumerate(zip(zs, rank0["responses"])):
                direct = by_name[f"direct {name} {i}"]
                check(len({r["digest"] for r in direct}) == 1
                      and resp["digest"] == direct[0]["digest"],
                      f"serve ranks[{name} {i}]: not bit-equal to the same "
                      "ranks' direct slab decode")
                direct_ms.append(direct[0]["wall_ms"])
                whole = hdr_decode(dec, z.cuda(), cons, prec).image.cpu()
                e = (resp["image"] - whole).abs().max().item()
                if prec.mode == "fast":
                    bar = SLAB_FAST * max(1.0, whole.abs().max().item())
                else:
                    bar = SLAB_MIXED[1]
                check(e <= bar, f"serve ranks[{name} {i}] vs whole-image: "
                      f"max-abs {e} > {bar}")
                errs.append(e)
                bars.append(bar)
            counts = [{k: v for k, v in r["counts"].items() if v}
                      for r in recs]
            n = len(zs)
            rec = {**_latency_record(
                       [types.SimpleNamespace(**r)
                        for r in rank0["responses"]], rank0["burst_s"]),
                   "direct_wall_ms": direct_ms,
                   "overhead_ms": 1e3 * rank0["burst_s"] / n
                   - sum(direct_ms) / n,
                   "vs_whole_image_max_abs": errs,
                   "vs_whole_image_bar": bars, "launches": counts,
                   "stats": rank0["stats"]}
            record["engines"][name] = rec
            log(f"serve ranks[{name}] {n} responses bit-equal to the direct "
                f"slab decode; vs whole-image max-abs "
                f"{[f'{e:.3e}' for e in errs]} (bars "
                f"{[f'{b:.3e}' for b in bars]}); "
                f"latency p50 {1e3 * rec['latency_p50_s']:.3f} ms, p95 "
                f"{1e3 * rec['latency_p95_s']:.3f} ms, {rec['mp_per_s']:.3f} "
                f"MP/s (burst {1e3 * rec['wall_s']:.3f} ms; direct slab wall "
                f"ms {[round(t, 3) for t in direct_ms]}; engine overhead "
                f"{rec['overhead_ms']:.3f} ms a request); launches by rank "
                f"{counts}; {card}")
        for name, kernels in (("fast", ("fused_conv3x3.owned_launches",
                                        "upsample_conv3x3.owned_launches",
                                        "flash_attention_bf16.launches")),
                              ("nccl", ("fused_conv3x3.owned_launches",
                                        "flash_attention_bf16.launches")),
                              ("fast bucket 64",
                               ("flash_attention_bf16.launches_masked",)),
                              ("mixed", ("flash_attention_3pass.launches",
                                         "split_qkv.launches"))):
            for r in by_name[name]:
                for k in kernels:
                    check(r["counts"].get(k, 0) > 0, f"serve ranks[{name}] "
                          f"rank {r['rank']} never ran {k}")
        for r in by_name["fast bucket 64"]:
            check(r["counts"].get("fused_conv3x3.launches", 0) == 0,
                  f"serve ranks[fast bucket 64] rank {r['rank']} ran the "
                  "chain")
        d1 = one_rank["depth2"]
        log(f"serve ranks beside phase 4b's one-rank engine (fast 1024^2 x6, "
            f"depth 2): p50 {1e3 * d1['latency_p50_s']:.3f} ms, p95 "
            f"{1e3 * d1['latency_p95_s']:.3f} ms, {d1['mp_per_s']:.3f} MP/s; "
            f"{card}")

        # the fast 2048^2 slab request profiled on each rank
        record["profiled"] = []
        for r in by_name["profiled"]:
            top = [(_short(n), c, ms) for n, c, ms in r["top"]]
            coll = [(n, c, ms) for n, c, ms in r["collectives"]]
            record["profiled"].append({
                "rank": r["rank"], "wall_ms": r["wall_ms"],
                "device_ms": r["device_ms"], "kernel_ms": r["kernel_ms"],
                "top5": top, "collectives": coll})
            log(f"serve ranks[profiled fast 2048^2 slab request] rank "
                f"{r['rank']}: wall {r['wall_ms']:.3f} ms, device "
                f"{r['device_ms']:.3f} ms, kernels {r['kernel_ms']:.3f} ms in "
                "all; top-5 (launches): " + ", ".join(
                    f"{n} {ms:.3f} ({c})" for n, c, ms in top)
                + "; collectives (host ms, wait included): " + ", ".join(
                    f"{n} {ms:.3f} ({c})" for n, c, ms in coll))

        # cli serve --sharded --mesh 2 (started with the phase): one 32-bit EXR
        # response, /healthz, stop
        deadline = time.perf_counter() + 120
        while len(lines) < 2:
            check(cli.poll() is None and time.perf_counter() < deadline,
                  f"cli serve --sharded did not start: {lines}")
            time.sleep(0.05)
        (_, group), (t_start, serving) = ((t, json.loads(x))
                                          for t, x in lines[:2])
        port = int(serving["serving"].rsplit(":", 1)[1])
        buf = io.BytesIO()
        np.save(buf, big[0].numpy())
        t0 = time.perf_counter()
        status, data = _http(port, "POST", "/v1/decode?format=exr&mode="
                             "conservative&bit_depth=32bit&compression=zip",
                             buf.getvalue())
        t_post = time.perf_counter() - t0
        check(status == 200, f"cli serve --sharded: {status} {data[:300]}")
        path = os.path.join(cli_dir, "served.exr")
        with open(path, "wb") as f:
            f.write(data)
        want = by_name["fast"][0]["responses"][0]["image"][0].numpy()
        check(np.array_equal(exr.read_exr(path), want), "cli serve --sharded: "
              "the EXR is not the fast engine's image")
        status, data = _http(port, "GET", "/healthz")
        health = json.loads(data)
        check(status == 200 and health["ok"] is True
              and health["device_count"] == SERVE_RANKS
              and health["device"] == torch.cuda.get_device_name(0),
              f"cli serve --sharded: /healthz {status} {health}")
        code, t_stop, err = _stop_cli_serve(cli, cli_dir)
        check(code == 0, f"cli serve --sharded exited {code}: {err[-3000:]}")
        alive = []
        for pid in group["pids"]:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        check(not alive, f"cli serve --sharded left ranks {alive}")
        ranks_line = [x for x in err.splitlines() if "): served" in x]
        record["cli_serve_sharded"] = {
            "start_s": t_start, "post_exr_s": t_post, "stop_s": t_stop,
            "health": health, "ranks": ranks_line}
        log(f"cli serve --sharded --mesh {SERVE_RANKS}: serving "
            f"{t_start:.2f} s after its start (beside the rank groups above), "
            f"a 2048^2 32-bit zip EXR response in {t_post:.3f} s equal to the "
            f"fast engine's image; /healthz {health}; SIGTERM to exit 0 in "
            f"{t_stop:.2f} s, no rank left; {ranks_line}")
        record["phase_s"] = time.perf_counter() - t_phase
        check(record["phase_s"] <= SERVE_RANKS_BUDGET_S,
              f"serve ranks phase {record['phase_s']:.1f} s > "
              f"{SERVE_RANKS_BUDGET_S} s")
        log(f"serve ranks phase {record['phase_s']:.1f} s (<= "
            f"{SERVE_RANKS_BUDGET_S} s); {card}")
        return record
    finally:
        if cli.poll() is None:
            _stop_cli_serve(cli, cli_dir)
        shutil.rmtree(cli_dir, ignore_errors=True)


def phase_exr(image: torch.Tensor) -> None:
    from hdrvae_torch.io.exr import read_exr, write_exr
    img = image[0].cpu().numpy()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "parity.exr")
        t0 = time.perf_counter()
        write_exr(path, img, pixel_type="float", compression="zip")
        size = os.path.getsize(path)
        back = read_exr(path)
        dt = time.perf_counter() - t0
    check(back.shape == img.shape and np.array_equal(back, img),
          "EXR round trip is not bit-exact")
    log(f"exr: 32-bit zip {img.shape} {size} bytes written and read back "
        f"bit-exact in {dt:.2f} s")


def _upscale_request(net, image, ucfg, prec, architecture="ESRGAN"):
    """One hdr_upscale with its result synchronised: (result, device ms,
    host wall ms, peak GiB)."""
    from hdrvae_torch.upscale.pipeline import hdr_upscale
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    res = hdr_upscale(net, image, ucfg, architecture=architecture,
                      precision=prec)
    end.record()
    torch.cuda.synchronize()
    return (res, start.elapsed_time(end), 1e3 * (time.perf_counter() - h0),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _k6_forward(net, tile: torch.Tensor) -> None:
    """One RRDBNetConfig() forward of a 512^2 tile through the K6 chain,
    measured (its weights prepared by the calls before): K6's launches
    from its count, K6's device time and the device's busy time from the
    profiler's kernel events, the forward's time from CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply
    dense = _wrappers()["dense_conv3x3"]
    dense.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_ms = cuda_ms(lambda: rrdbnet_fused_apply(
            net, tile, precision=Precision.fast()), iters=1, warmup=0)
    launches = dense.launches
    spans, k6_ms, k6_events = [], 0.0, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t0, t1 = evt.time_range.start, evt.time_range.end
        spans.append((t0, t1))
        if "dense_wgmma_kernel" in evt.name:
            k6_ms, k6_events = k6_ms + (t1 - t0) / 1e3, k6_events + 1
    busy, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            busy, reach = busy + (t1 - max(t0, reach)) / 1e3, t1
    check(launches == sum(K6_FORWARD.values()),
          f"K6 tile forward: {launches} launches counted, "
          f"{sum(K6_FORWARD.values())} convs")
    shapes = {shape[0]: shape[1:5] for shape in K6_SHAPES + K6_EXTRA}
    flops = sum(n * 2 * h * w * 9 * sum(cins) * cout
                for name, n in K6_FORWARD.items()
                for h, w, cins, cout in [shapes[name]])
    rate = flops / (k6_ms * 1e9) if k6_ms else float("nan")
    log(f"K6 in one RRDBNetConfig() 512^2 tile forward, measured: "
        f"{launches} launches ({k6_events} kernel events), K6 device "
        f"{k6_ms:.3f} ms ({rate:.1f} TFLOP/s, torch.profiler), device busy "
        f"{busy:.3f} ms of the forward's {fwd_ms:.3f} ms (CUDA events)")


def phase_upscale(image: torch.Tensor):
    from hdrvae_torch.core.config import Precision, UpscaleConfig
    from hdrvae_torch.models.rrdbnet import (RRDBNetConfig, init_rrdbnet,
                                             rrdbnet_layers)
    from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply

    t0 = time.perf_counter()
    net = init_rrdbnet(RRDBNetConfig(), seed=2, device="cuda")
    n_params = sum(p.numel() for p in net.parameters())
    log(f"upscaler: ESRGAN x4 {n_params} parameters, weights from numpy "
        f"seed 2 in {time.perf_counter() - t0:.1f} s; input "
        f"{list(image.shape)} max {image.max().item():.6g}, "
        f"{int((image > 1).sum().item())} values > 1")
    out_shape = (1, image.shape[1] * 4, image.shape[2] * 4, 3)
    ucfg = UpscaleConfig()
    results, times = {}, {}
    _reset_counts()
    for name, prec, n in (("fast", Precision.fast(), 2),
                          ("parity", Precision.parity(), 1)):
        walls = []
        for _ in range(n):
            res, dev_ms, wall_ms, peak = _upscale_request(net, image, ucfg,
                                                          prec)
            walls.append((dev_ms, wall_ms, peak))
        results[name], times[name] = res, walls
        check(tuple(res.image.shape) == out_shape,
              f"upscale {name}: shape {tuple(res.image.shape)}")
        check(torch.isfinite(res.image).all().item(),
              f"upscale {name}: non-finite output")
        log(f"upscale[{name}] device ms {[round(d, 3) for d, _, _ in walls]}"
            f", host wall ms {[round(w, 3) for _, w, _ in walls]}, peak "
            f"{walls[-1][2]:.3f} GiB; out max "
            f"{res.image.max().item():.6g}")
        if name == "fast":
            fast_counts = _counts()
            check(fast_counts["dense_conv3x3"] > 0,
                  "fast upscale never ran dense_conv3x3")
    log(f"launches in the fast upscale (2 requests): {fast_counts}")

    d = (results["fast"].image - results["parity"].image).abs()
    log(f"upscale fast vs parity image |diff| mean {d.mean().item():.4e} "
        f"p99.9 {p999(d):.4e} (not gated: the atanh reversal)")
    del d

    # the K6 chain against the unfused fast layers on the first tile's raw
    # model output (before the reversal)
    tile = image[:, :512, :512, :].contiguous()
    fused = rrdbnet_fused_apply(net, tile, precision=Precision.fast())
    unfused = rrdbnet_layers(net, tile, precision=Precision.fast()).float()
    e = (fused - unfused).abs().max().item()
    bound = CONV_BUDGET * max(1.0, unfused.abs().max().item())
    check(e <= bound, f"fused vs unfused raw tile max-abs {e} > {bound}")
    log(f"upscale fused vs unfused fast raw 512^2 tile: max-abs {e:.4e} "
        f"(<= {bound:.4e}; max|ref| {unfused.abs().max().item():.4e})")
    del fused, unfused, results
    _k6_forward(net, tile)

    res, dev_ms, wall_ms, peak = _upscale_request(
        net, image, UpscaleConfig(local_fix=True, small_blur=True),
        Precision.fast())
    check(torch.isfinite(res.image).all().item(),
          "upscale local_fix + small_blur: non-finite output")
    log(f"upscale[fast, local_fix + small_blur] device ms {dev_ms:.3f}, "
        f"peak {peak:.3f} GiB: finite")
    del res, net
    torch.cuda.empty_cache()
    return fast_counts, times


def phase_swin_upscale(image: torch.Tensor, family: str):
    """The full-width SwinIR-M, HAT-M or Swin2SR-M x4 through
    ``hdr_upscale`` on a 768^2 crop of the decoded image (4 tiles a pass):
    one fast request, whose K7 / K8 launches must be one per block / OCAB
    per tile run, and one parity request, which must launch neither; then
    the fused fast chain against the unfused fast layers on the first
    tile's raw output."""
    import dataclasses

    from hdrvae_torch.core.config import Precision, UpscaleConfig
    from hdrvae_torch.models.hat import HATConfig, hat_apply, init_hat
    from hdrvae_torch.models.swin2sr import (Swin2SRConfig, init_swin2sr,
                                             swin2sr_apply)
    from hdrvae_torch.models.swinir import (SwinIRConfig, init_swinir,
                                            swinir_apply)
    from hdrvae_torch.upscale.pipeline import upscale_progress_total

    cfg, seed, init, apply = {
        "SwinIR": (SwinIRConfig(), 3, init_swinir, swinir_apply),
        "HAT": (HATConfig(), 4, init_hat, hat_apply),
        "Swin2SR": (Swin2SRConfig(), 5, init_swin2sr, swin2sr_apply),
    }[family]
    net = init(cfg, seed=seed, device="cuda")
    n_params = sum(p.numel() for p in net.parameters())
    crop = image[:, :SWIN_CROP, :SWIN_CROP, :].contiguous()
    ucfg = UpscaleConfig()
    runs = upscale_progress_total(crop, cfg, ucfg)
    blocks = sum(cfg.depths)
    want = {"swin_block_fused": blocks * runs,
            "ocab_attention": len(cfg.depths) * runs if family == "HAT"
            else 0}
    log(f"upscaler: {family} x4 ({cfg.embed_dim} wide, {blocks} blocks, "
        f"window {cfg.window_size}) {n_params} parameters, weights from "
        f"numpy seed {seed}; input {list(crop.shape)}, {runs} tile runs")
    out_shape = (1, SWIN_CROP * 4, SWIN_CROP * 4, 3)
    results, times = {}, {}
    for name, prec in (("fast", Precision.fast()),
                       ("parity", Precision.parity())):
        _reset_counts()
        res, dev_ms, wall_ms, peak = _upscale_request(
            net, crop, ucfg, prec, architecture=family)
        counts = _counts()
        results[name], times[name] = res, (dev_ms, wall_ms, peak)
        check(tuple(res.image.shape) == out_shape,
              f"{family} {name}: shape {tuple(res.image.shape)}")
        for t in res:
            check(torch.isfinite(t).all().item(),
                  f"{family} {name}: non-finite output")
        log(f"upscale[{family}, {name}] device ms {dev_ms:.3f}, host wall "
            f"ms {wall_ms:.3f}, peak {peak:.6f} GiB; out max "
            f"{res.image.max().item():.6g}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if name == "fast":
            fast_counts = counts
            for kname, n in want.items():
                check(counts[kname] == n, f"{family} fast: {kname} launched "
                      f"{counts[kname]} times, want {n}")
        else:
            check(not any(counts.values()),
                  f"{family} parity ran a fast-tier kernel: {counts}")
    d = (results["fast"].image - results["parity"].image).abs()
    log(f"upscale[{family}] fast vs parity image |diff| mean "
        f"{d.mean().item():.4e} p99.9 {p999(d):.4e} (not gated: the "
        f"{'logit' if family == 'Swin2SR' else 'atanh'} reversal)")
    del d, results

    tile = crop[:, :512, :512, :].contiguous()
    fused = apply(net, tile, precision=Precision.fast())
    unfused = apply(net, tile, precision=dataclasses.replace(
        Precision.fast(), swin_attn="xla"))
    e = (fused - unfused).abs().max().item()
    bound = SWIN_BUDGET * max(1.0, unfused.abs().max().item())
    check(e <= bound, f"{family} fused vs unfused raw tile max-abs {e} > "
          f"{bound}")
    log(f"upscale[{family}] fused vs unfused fast raw 512^2 tile: max-abs "
        f"{e:.4e} (<= {bound:.4e}; max|ref| {unfused.abs().max().item():.4e})")
    del fused, unfused, net
    torch.cuda.empty_cache()
    return fast_counts, times


def _zoo_checkpoints():
    """(label, architecture, config, seed, the official state dict) of each
    full-width checkpoint of the conv families, weights from numpy seeds."""
    from hdrvae_torch.models import plksr, span, srvgg
    cfgs = (("Compact", "Compact", srvgg.SRVGGConfig(), 6),
            ("SPAN", "SPAN", span.SPANConfig(), 7),
            ("RealPLKSR", "RealPLKSR", plksr.RealPLKSRConfig(), 8),
            ("RealPLKSR DySample", "RealPLKSR", plksr.RealPLKSRConfig(
                upsampler="dysample"), 9))
    for label, arch, cfg, seed in cfgs:
        if arch == "Compact":
            sd = srvgg.init_srvgg(cfg, seed=seed, device="cpu").state_dict()
        elif arch == "SPAN":
            sd = span.official_state_dict(cfg, seed=seed)
        else:
            sd = plksr.init_realplksr(cfg, seed=seed,
                                      device="cpu").state_dict()
        yield label, arch, cfg, seed, sd


def phase_zoo_upscale(image: torch.Tensor):
    """The full-width Compact (SRVGGConfig(): 64 features, 32 convs, x4,
    PReLU), SPAN (SPANConfig(): 48 features, 6 blocks, x4, official
    Conv3XC keys) and RealPLKSR (RealPLKSRConfig(): dim 64, 28 blocks,
    kernel 17, x4; PixelShuffle and DySample heads) upscalers, each
    written to a temporary .pth and loaded by ``load_upscale_model`` on
    the card, through ``hdr_upscale`` on a ZOO_CROP^2 crop of the parity
    image (one tile a pass): two fast and two parity requests each (the
    first cold), every output finite and of its shape, on the layers (no
    hand-written kernel launched).  Prints device ms, peak GiB, the raw
    forward's activation bytes per input pixel of the tile beside
    ``working_set_bytes_per_pixel``, and fast vs parity (not gated)."""
    from hdrvae_torch.core.config import Precision, UpscaleConfig
    from hdrvae_torch.models.zoo import (load_upscale_model, upscaler_apply,
                                         working_set_bytes_per_pixel)

    crop = image[:, :ZOO_CROP, :ZOO_CROP, :].contiguous()
    ucfg = UpscaleConfig()
    out_shape = (1, ZOO_CROP * 4, ZOO_CROP * 4, 3)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, arch, cfg, seed, sd in _zoo_checkpoints():
            path = os.path.join(tmp, f"{arch}.pth")
            torch.save(sd, path)
            del sd
            net, got_cfg, got_arch = load_upscale_model(path, device="cuda")
            check((got_arch, got_cfg) == (arch, cfg),
                  f"{label}: loaded as {got_arch} {got_cfg}")
            n_params = sum(p.numel() for p in net.parameters())
            log(f"upscaler: {label} x4 {n_params} parameters, weights from "
                f"numpy seed {seed}; input {list(crop.shape)}")
            results, times[label] = {}, {}
            for name, prec in (("fast", Precision.fast()),
                               ("parity", Precision.parity())):
                _reset_counts()
                runs = [_upscale_request(net, crop, ucfg, prec,
                                         architecture=arch)
                        for _ in range(2)]
                counts = _counts()
                check(not any(counts.values()), f"{label} {name} launched "
                      f"a hand-written kernel: {counts}")
                for res, *_ in runs:
                    check(tuple(res.image.shape) == out_shape,
                          f"{label} {name}: shape {tuple(res.image.shape)}")
                    for t in res:
                        check(torch.isfinite(t).all().item(),
                              f"{label} {name}: non-finite output")
                # the raw forward alone on the tile: its activations
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                upscaler_apply(net, crop, precision=prec)
                torch.cuda.synchronize()
                per_px = (torch.cuda.max_memory_allocated() - base) \
                    / ZOO_CROP ** 2
                row = working_set_bytes_per_pixel(cfg, prec)
                results[name] = runs[-1][0]
                times[label][name] = runs[-1][1:]
                log(f"upscale[{label}, {name}] device ms "
                    f"{[round(r[1], 3) for r in runs]} (cold, warm), host "
                    f"wall ms {[round(r[2], 3) for r in runs]}, peak "
                    f"{runs[-1][3]:.3f} GiB; raw forward {per_px:.0f} B per "
                    f"input pixel (working_set_bytes_per_pixel {row:.0f}); "
                    f"out max {results[name].image.max().item():.6g}")
                del runs
            d = (results["fast"].image - results["parity"].image).abs()
            log(f"upscale[{label}] fast vs parity image |diff| mean "
                f"{d.mean().item():.4e} p99.9 {p999(d):.4e} (not gated: the "
                f"logit reversal)")
            del d, results, net
            torch.cuda.empty_cache()
    return times


def phase_swin_chain(image: torch.Tensor):
    """The staged chain on the full-width SwinIR-M's path: its body (6
    residual groups of 6 blocks) on one 512^2 tile of the decoded image,
    walked once with every block through ``chain_block`` (K10 -> K9 -> K11)
    and once through ``fused_block`` (K7), each block's input the previous
    block's output and each group's conv + residual after its blocks.
    Each walk must launch its kernels once a block and the other's never;
    the two bodies are held to each other.  Both walks are timed in turns
    (chain, K7, K7, chain).  Returns the chain walk's launch counts and the
    record."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.models.layers import conv2d
    from hdrvae_torch.models.swinir import (SwinIRConfig, _rstb_conv,
                                            block_weights, chain_block,
                                            fused_block, init_swinir,
                                            layer_norm, prepare_input)
    cfg = SwinIRConfig()
    net = init_swinir(cfg, seed=3, device="cuda")
    n_params = sum(p.numel() for p in net.parameters())
    fast, ws = Precision.fast(), cfg.window_size
    blocks = sum(cfg.depths)
    tile = image[:, :512, :512, :].contiguous()
    x = prepare_input(tile, ws, cfg.in_channels, cfg.img_range, fast)
    tok = layer_norm(conv2d(x, net.conv_first, precision=fast),
                     net.patch_embed.norm)
    weights = [[block_weights(blk, cfg.num_heads[li], ws, torch.bfloat16)
                for blk in layer.residual_group.blocks]
               for li, layer in enumerate(net.layers)]
    log(f"swin chain: SwinIR-M {n_params} parameters, weights from numpy "
        f"seed 3; body input {list(tok.shape)}, {blocks} blocks")

    def walk(block):
        """(body output, device ms, launch counts) of one walk."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        _reset_counts()
        start.record()
        t = tok
        for layer, wts in zip(net.layers, weights):
            y = t
            for bi, w in enumerate(wts):
                y = block(y, w, ws, 0 if bi % 2 == 0 else ws // 2, fast)
            t = _rstb_conv(y, layer.conv, fast) + t
        end.record()
        torch.cuda.synchronize()
        return t, start.elapsed_time(end), _counts()

    chain_out, chain_ms, cc = walk(chain_block)
    fused_out, fused_ms, cf = walk(fused_block)
    chain_kernels = ("ln_qkv", "window_attention_core", "proj_mlp")
    for name in chain_kernels:
        check(cc[name] == blocks and cf[name] == 0,
              f"swin chain: {name} launched {cc[name]} / {cf[name]} times "
              f"in the chain / K7 walks, want {blocks} / 0")
    check(cf["swin_block_fused"] == blocks and cc["swin_block_fused"] == 0,
          f"swin chain: K7 launched {cf['swin_block_fused']} / "
          f"{cc['swin_block_fused']} times in the K7 / chain walks, want "
          f"{blocks} / 0")
    check(torch.isfinite(chain_out.float()).all().item(),
          "swin chain: body output not finite")
    e = (chain_out.float() - fused_out.float()).abs().max().item()
    ref_max = fused_out.float().abs().max().item()
    bound = SWIN_BUDGET * max(1.0, ref_max)
    check(e <= bound, f"swin chain vs K7 body: max-abs {e} > {bound}")
    fused_ms2 = walk(fused_block)[1]
    chain_ms2 = walk(chain_block)[1]
    record = {"blocks": blocks, "body_shape": list(tok.shape),
              "max_abs_err": e, "err_budget": bound, "max_abs_ref": ref_max,
              "bit_equal": bool(torch.equal(chain_out, fused_out)),
              "chain_walk_ms": [chain_ms, chain_ms2],
              "k7_walk_ms": [fused_ms, fused_ms2]}
    log(f"swin chain: body max-abs vs K7 {e:.3e} (budget {bound:.3e}, "
        f"bit-equal {record['bit_equal']}); device ms a walk: chain "
        f"{chain_ms:.3f}, {chain_ms2:.3f}  K7 {fused_ms:.3f}, "
        f"{fused_ms2:.3f}; launches {dict((k, cc[k]) for k in chain_kernels)}")
    del net, chain_out, fused_out, tok, x, weights
    torch.cuda.empty_cache()
    return cc, record


def phase_f32_probe(entry: dict):
    """K12's main path: the probe's measurement (``tools/
    f32_dot_probe_torch.py``) at K12_SHAPE, each precision's error against
    a float64 product held to its class; its times fill K12's entry, each
    precision's beside the library's float32 (TF32 off, on) and bf16
    ``torch.matmul``.  Returns the probe's launch counts and rows."""
    _reset_counts()
    rows = _probe().measure(*K12_SHAPE)
    counts = _counts()
    lib = rows["library"]
    # one PyTorch call computing each precision's function: highest the
    # float32 matmul with TF32 off, default the bf16 matmul of operands
    # cast beforehand, high none
    same_fn = {"highest": lib["matmul_f32"]["ms"], "high": None,
               "default": lib["matmul_bf16"]["ms"]}
    for d in entry["shapes"]:
        r = rows["modes"][d["precision"]]
        check(r["rel_vs_exact"] <= K12_CLASSES[d["precision"]],
              f"K12 {d['precision']}: error {r['rel_vs_exact']} of "
              f"max|exact| > {K12_CLASSES[d['precision']]}")
        d.update(ms=r["ms"], plain_ms=r["plain_ms"],
                 library_ms=same_fn[d["precision"]],
                 rel_vs_exact=r["rel_vs_exact"],
                 max_abs_vs_exact=r["max_abs_vs_exact"],
                 **{k: r[k] for k in ("split_ms", "main_ms") if k in r})
        parts = (f" (split {r['split_ms'] * 1e3:.2f} us, tensor-core kernel "
                 f"{r['main_ms'] * 1e3:.2f} us alone)" if "main_ms" in r
                 else "")
        log(f"K12 f32_dot {d['precision']}: kernel {r['ms'] * 1e3:.2f} us"
            f"{parts} (bound {d['bound_ms'] * 1e3:.2f} us)  plain "
            f"{r['plain_ms'] * 1e3:.2f} us  vs float64 {r['rel_vs_exact']:.3e}"
            f" of max|exact| (<= {K12_CLASSES[d['precision']]}); torch.matmul "
            f"float32 {lib['matmul_f32']['ms'] * 1e3:.2f} us, TF32 "
            f"{lib['matmul_tf32']['ms'] * 1e3:.2f} us, bf16 "
            f"{lib['matmul_bf16']['ms'] * 1e3:.2f} us")
    for key in ("ms", "plain_ms"):
        entry[key] = sum(d[key] for d in entry["shapes"])
    entry["library_ms"] = len(entry["shapes"]) * lib["matmul_f32"]["ms"]
    log("f32 dot probe library rows: " + ", ".join(
        f"{k} {r['ms'] * 1e3:.2f} us ({r['rel_vs_exact']:.3e})"
        for k, r in lib.items()))
    return counts, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "hdrvae_torch")):
        print("chip_smoke: hdrvae_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cudnn.benchmark = False
    t_start = time.perf_counter()

    card = phase_device()
    phase_build()
    entries, chain_ab = phase_kernels()
    image, counts, per_tier, times, epi_counts, dec = phase_decode()
    serve_record = phase_serve(dec, card)
    front_record = phase_frontend(dec, image, card)
    t_b = time.perf_counter()
    bucket_masked, bucket_records = phase_bucketed(dec)
    log(f"bucketed phase {time.perf_counter() - t_b:.1f} s")
    t_lf = time.perf_counter()
    lf_counts, lf_records, slab_refs = phase_large_frames(dec)
    log(f"large-frame phase {time.perf_counter() - t_lf:.1f} s")
    t_sl = time.perf_counter()
    slab_counts, slab_records = phase_slab(dec, slab_refs)
    log(f"slab phase {time.perf_counter() - t_sl:.1f} s")
    tiled_record = phase_tiled(dec, image, slab_refs, lf_records, card)
    serve_ranks_record = phase_serve_ranks(dec, card, serve_record)
    del dec, slab_refs
    phase_exr(image)
    t_up = time.perf_counter()
    up_counts, up_times = phase_upscale(image)
    log(f"upscale phase {time.perf_counter() - t_up:.1f} s")
    swin_counts = {}
    for family in ("SwinIR", "HAT", "Swin2SR"):
        t_up = time.perf_counter()
        swin_counts[family], up_times[family] = phase_swin_upscale(image,
                                                                   family)
        log(f"{family} upscale phase {time.perf_counter() - t_up:.1f} s")
    t_zoo = time.perf_counter()
    up_times.update(phase_zoo_upscale(image))
    log(f"Compact / SPAN / RealPLKSR upscale phase "
        f"{time.perf_counter() - t_zoo:.1f} s")
    t_ch = time.perf_counter()
    chain_counts, chain_record = phase_swin_chain(image)
    log(f"swin chain phase {time.perf_counter() - t_ch:.1f} s")
    by_name = {e["name"]: e for e in entries}
    probe_counts, probe_rows = phase_f32_probe(by_name["f32_dot"])

    log(f"launches in the decode phase: {counts}")
    for name in ("fused_conv3x3", "upsample_conv3x3",
                 "flash_attention_bf16"):
        check(per_tier["fast"][name] > 0, f"fast decode never ran {name}")
    check(per_tier["mixed"]["flash_attention_3pass"] > 0,
          "mixed decode never ran flash_attention_3pass")
    # the 3-pass kernel's operands are split once a launch, in its tier alone
    check(per_tier["mixed"]["split_qkv"]
          == per_tier["mixed"]["flash_attention_3pass"]
          and per_tier["fast"]["split_qkv"] == 0
          and per_tier["parity"]["split_qkv"] == 0,
          f"split_qkv launched {[per_tier[t]['split_qkv'] for t in per_tier]}"
          " times (fast, parity, mixed), want once a 3-pass launch")
    check(per_tier["parity"]["flash_attention_f32"] > 0,
          "parity decode never ran flash_attention_f32")
    check(epi_counts["collapse_and_stats_fused"] > 0,
          "fused-epilogue decodes never ran collapse_and_stats_fused")
    # K3's key_valid mode: each tier's kernel masked in the bucketed phase
    for tier, kname in (("parity", "flash_attention_f32"),
                        ("mixed", "flash_attention_3pass"),
                        ("fast", "flash_attention_bf16")):
        check(bucket_masked[tier] > 0, f"bucketed {tier} decode never ran "
              f"{kname} with key_valid")
    # each kernel's launches in the run of the path it serves
    main_path = dict(counts)
    main_path["collapse_and_stats_fused"] = epi_counts[
        "collapse_and_stats_fused"]
    main_path["dense_conv3x3"] = up_counts["dense_conv3x3"]
    main_path["swin_block_fused"] = sum(swin_counts[f]["swin_block_fused"]
                                        for f in ("SwinIR", "HAT"))
    # the v2 body is the same wrapper's, in the Swin2SR upscale
    main_path["swin_block_fused_v2"] = \
        swin_counts["Swin2SR"]["swin_block_fused"]
    main_path["ocab_attention"] = swin_counts["HAT"]["ocab_attention"]
    # the streamed top level's kernels: the low-memory fast 2048^2 request
    for name in ("upconv_gn_conv3x3", "upsample_conv3x3_stats_only"):
        main_path[name] = lf_counts[name]
    # the staged Swin chain's kernels: the chain walk of the Swin chain
    # phase; K12: the probe
    for entry_name, wrapper in (("swin_ln_qkv", "ln_qkv"),
                                ("swin_attn_core", "window_attention_core"),
                                ("swin_proj_mlp", "proj_mlp")):
        main_path[entry_name] = chain_counts[wrapper]
    main_path["f32_dot"] = probe_counts["f32_dot"]
    main_path["split_w"] = probe_counts["split_w"]
    # K1 / K2 owned_rows: the fast slab decode, summed over its ranks
    for name in ("fused_conv3x3", "upsample_conv3x3"):
        main_path[name + "_owned_rows"] = slab_counts[name +
                                                      ".owned_launches"]
    for entry in entries:
        entry["launches"] = main_path[entry["name"]]
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on its main path")
        if "key_valid" in entry:
            # the masked mode's main path: the bucketed decode of its tier
            entry["key_valid"]["launches"] = bucket_masked[
                entry["tiers"][0]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries,
                      "decode_ms": {k: v[-1][0] for k, v in times.items()},
                      "upscale_ms": {k: v[-1][0] if k in ("fast", "parity")
                                     else {t: r[0] for t, r in v.items()}
                                     for k, v in up_times.items()},
                      "serve": serve_record,
                      "frontend": front_record,
                      "bucketed_decode": bucket_records,
                      "large_frames": lf_records,
                      "slab_sharded": slab_records,
                      "tiled": tiled_record,
                      "serve_ranks": serve_ranks_record,
                      "swin_chain_vs_k7": chain_ab,
                      "swin_chain": chain_record,
                      "f32_dot_probe": probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
