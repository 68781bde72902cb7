#!/usr/bin/env python3
"""Profile the PyTorch port's decode, or its upscale, on one NVIDIA GPU.

    python3 tools/profile_decode_torch.py [--latent 128 256]
                                          [--tiers fast parity mixed]
    python3 tools/profile_decode_torch.py --upscale [--latent 128]
                                          [--tiers fast parity]
                                          [--model esrgan swinir hat swin2sr]
    python3 tools/profile_decode_torch.py --lowmem [--latent 256 512]
    python3 tools/profile_decode_torch.py --staged [--latent 256 512]
    python3 tools/profile_decode_torch.py --ab-tree DIR
                                          [--ab-only swin conv esrgan attn
                                                     hat lowmem]
    python3 tools/profile_decode_torch.py --upscale --model hat --ab-tree DIR
    python3 tools/profile_decode_torch.py --fused-epilogue --ab-tree DIR
                                          --ab-only epilogue

For each latent side (128 gives a 1024^2 image, 256 a 2048^2 one) and
tier, the full-width Flux.1 decoder (``DecoderConfig()``, random weights
from numpy seed 0, latent from seed 1) runs ``hdr_decode`` +
``decode_summary`` in conservative mode, as ``chip_smoke.py`` does.  With
``--upscale`` the parity decode's image instead goes through
``hdr_upscale`` with a full-width x4 upscaler, random weights from a numpy
seed (``--model``: ESRGAN ``RRDBNetConfig()`` seed 2, SwinIR-M
``SwinIRConfig()`` seed 3, HAT-M ``HATConfig()`` seed 4, Swin2SR-M
``Swin2SRConfig()`` seed 5, as ``chip_smoke.py``), and ``UpscaleConfig()``
(512^2 tiles, overlap 64, comfy seams), 1024^2 -> 4096^2 for latent 128.
Either way:

- a few requests unprofiled (three decodes, two upscales): device ms from
  CUDA events, host wall ms, and the peak of allocated device memory;
- one more under ``torch.profiler``, reported over the device's own events
  only (kernels, memcpy, memset), never the operator rows that enclose
  them: their summed time, the time the device was busy (the union of
  their intervals) against the request's host wall, each kernel name's
  share of the summed time, and the share of each of the port's own CUDA
  kernels (``hdrvae_torch/csrc``).

``--lowmem`` runs the fast tier twice per latent side (default 256 and
512: 2048^2 and 4096^2), with the whole-image top level and with the
low-memory one (K2 ``stats_only`` + K5, ``models/fused_tail.py``), each
forced whatever ``LOWMEM_MIN_PIXELS`` says; ``--staged`` runs the mixed
tier whole-image and through the staged executor (``decode/staged.py``).
For each it adds one more request run stage by stage (the calls
``hdr_decode`` makes, in its order): the device ms and the peak of
allocated memory within each stage (the head, the top level, the tail,
the epilogue; for the staged executor its front through level 0's first
block, level 0's other blocks, and the streamed tail with the epilogue).
A run that exhausts the card's memory is reported as such.

With ``--ab-tree DIR`` it instead compares this tree with another copy of
the repository (an older commit unpacked into DIR) in turns: this, DIR,
DIR, this.  Each turn is a subprocess from its tree's root, which builds
and loads that tree's kernels: K7 ``swin_block_fused`` (v1 body) at
SwinIR-M's 512^2 tile (C 180, 6 heads, window 8), unshifted and shifted,
CUDA events over 20 launches after 3 warm-ups, then two fast
``hdr_upscale`` requests of SwinIR-M x4 (seed 3) on a 768^2 HDR image from
numpy seed 1; then K1 and K2 at ``chip_smoke.py``'s phase-3 shapes and
its ragged ones, K2 ``stats_only`` at the 2048^2 junction (CUDA events over
10 launches after 2 warm-ups, 5 for stats_only), and three requests each of
fast decodes at 1024^2 and 2048^2 and of parity and mixed ones at 1024^2;
then K6 ``dense_conv3x3`` at ``chip_smoke.py``'s phase-3 shapes and
conv_body (10 launches after 2 warm-ups, the table taken from this tree's
``chip_smoke.py``), summed, and as an estimate of one ``RRDBNetConfig()``
tile forward weighted by each shape's launches there; one such forward
measured (K6's device time from ``torch.profiler``); and three fast and
one parity ESRGAN x4
``hdr_upscale`` requests of a 1024^2 HDR image from numpy seed 1 (the
first fast one warms up); then K3 bf16, K3 f32 and K3 3-pass at N =
16,384 and 65,536 (C = 512), unmasked and with the bucketed phase's live
fraction of the grid (10 launches, 3 at N = 65,536, after 2 warm-ups), and
three fast, three parity and three mixed decodes each at 1024^2 and
2048^2, with each tier's peak memory and, for mixed, K3 3-pass's share of
one profiled request; then K8
``ocab_attention`` at ``chip_smoke.py``'s K8_SHAPE beside SDPA bf16, fast
HAT-M x4 requests of a 1024^2 HDR image (one to warm up, two timed, one
under ``torch.profiler`` for K8's share), and as controls two fast SwinIR-M
x4 requests and three fast 1024^2 decodes; then K5 ``upconv_gn_conv3x3``
at ``chip_smoke.py``'s K5_SHAPES (the wrapper by CUDA events, the kernel
by ``torch.profiler``), and three requests each of fast 2048^2 and 4096^2
decodes with the whole-image and the streamed top level, with a fast
1024^2 and a mixed 2048^2 decode as controls.  ``--ab-only swin conv
esrgan attn hat lowmem`` picks the turns; ``--upscale --model hat`` runs the HAT turn
alone, and ``--upscale --model swinir swin2sr hat`` (any other list) the
upscale turn: for each model named, three fast x4 requests of a 1024^2
HDR image from numpy seed 1 (the first warms up), then three fast 1024^2
decodes as the control.

``--fused-epilogue`` runs every decode, the ``--ab-tree`` turns' included,
with ``HDRDecodeConfig(use_fused_epilogue=True)``: the epilogue's collapse
and statistics by K4 instead of the plain reductions.  Its own turn,
``--ab-only epilogue``, times K4 at ``chip_smoke.py``'s K4_SHAPE in float32
and bf16 (CUDA events over 10 launches after 2 warm-ups), then three
requests each of fast decodes at 1024^2 and 2048^2 and of parity and mixed
ones at 1024^2, with K4's launches in each.

The script only reads: it changes nothing in the package.  Without a CUDA
device it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,  # noqa: E402
                                      Precision, UpscaleConfig)
from hdrvae_torch.decode import pipeline, staged  # noqa: E402
from hdrvae_torch.decode.pipeline import (decode_summary, hdr_decode,  # noqa: E402
                                          hdr_epilogue)
from hdrvae_torch.models import decoder as tdecoder, fused_tail  # noqa: E402
from hdrvae_torch.models.layers import conv2d  # noqa: E402
from hdrvae_torch.models.hat import HATConfig, init_hat  # noqa: E402
from hdrvae_torch.models.params import init_decoder  # noqa: E402
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet  # noqa: E402
from hdrvae_torch.models.swin2sr import Swin2SRConfig, init_swin2sr  # noqa: E402
from hdrvae_torch.models.swinir import SwinIRConfig, init_swinir  # noqa: E402
from hdrvae_torch.upscale.pipeline import hdr_upscale  # noqa: E402

TIERS = {"fast": Precision.fast, "parity": Precision.parity,
         "mixed": Precision.mixed}
CONSERVATIVE = HDRDecodeConfig(hdr_mode="conservative")
# --model: (architecture, network on the card)
UPSCALERS = {
    "esrgan": ("ESRGAN", lambda: init_rrdbnet(RRDBNetConfig(), seed=2,
                                              device="cuda")),
    "swinir": ("SwinIR", lambda: init_swinir(SwinIRConfig(), seed=3,
                                             device="cuda")),
    "hat": ("HAT", lambda: init_hat(HATConfig(), seed=4, device="cuda")),
    "swin2sr": ("Swin2SR", lambda: init_swin2sr(Swin2SRConfig(), seed=5,
                                                device="cuda"))}
# the __global__ functions of hdrvae_torch/csrc (K1/K2, K5, K3 in its three
# dot modes, K4, K6, K7, K8)
PORT_KERNELS = ("conv_wgmma_kernel", "group_stats_kernel",
                "upconv_wgmma_kernel", "flash_bf16_kernel",
                "flash_3pass_kernel", "flash_f32_kernel",
                "collapse_stats_kernel",
                "stats_finalize_kernel", "dense_wgmma_kernel",
                "swin_block_kernel", "ocab_kernel")


def request(fn) -> tuple[float, float]:
    """One request ``fn()`` run to its end: (device ms, host wall ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), 1e3 * (time.perf_counter() - h0)


def device_rows(prof) -> tuple[dict, float, float]:
    """Per-name (ms, count) of the device's events, their summed ms, and the
    ms during which at least one of them ran."""
    rows = defaultdict(lambda: [0.0, 0])
    spans = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        t0, t1 = evt.time_range.start, evt.time_range.end
        rows[evt.name][0] += (t1 - t0) / 1e3
        rows[evt.name][1] += 1
        spans.append((t0, t1))
    busy, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    total = sum(ms for ms, _ in rows.values())
    return rows, total, busy / 1e3


def report(label: str, fn, n: int, top: int) -> None:
    """``n`` unprofiled requests of ``fn``, then one under the profiler;
    prints the times, the peak memory and the top device rows."""
    torch.cuda.reset_peak_memory_stats()
    walls = [request(fn) for _ in range(n)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = request(fn)
    rows, total, busy = device_rows(prof)
    launches = sum(n for _, n in rows.values())
    print(f"== {label}: device ms {[round(d, 3) for d, _ in walls]}, host "
          f"wall ms {[round(h, 3) for _, h in walls]}, peak {peak:.3f} GiB; "
          f"profiled: wall {wall:.3f} ms, kernels {total:.3f} ms summed, "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f} % of wall), "
          f"{launches} device events", flush=True)
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    for name, (ms, k) in ranked[:top]:
        print(f"  {ms:10.3f} ms {100 * ms / total:5.1f} %  x{k:<5d} "
              f"{name[:110]}", flush=True)
    for kname in PORT_KERNELS:
        ms = sum(t for name, (t, _) in rows.items() if kname in name)
        k = sum(c for name, (_, c) in rows.items() if kname in name)
        if k:
            print(f"  port kernel {kname}: {ms:.3f} ms, "
                  f"{100 * ms / total:.1f} % of kernel time, x{k}",
                  flush=True)


@contextlib.contextmanager
def route(variant: str):
    """Force hdr_decode's large-frame route: "whole" (whole-image top
    level, whole-image mixed), "lowmem" (the streamed top level) or
    "staged" (the staged executor); the thresholds are restored after."""
    saved = fused_tail.LOWMEM_MIN_PIXELS, pipeline._STAGED_MIN_PIXELS_OVERRIDE
    fused_tail.LOWMEM_MIN_PIXELS = 1 if variant == "lowmem" else 1 << 62
    pipeline._STAGED_MIN_PIXELS_OVERRIDE = (1 if variant == "staged"
                                            else 1 << 62)
    try:
        yield
    finally:
        (fused_tail.LOWMEM_MIN_PIXELS,
         pipeline._STAGED_MIN_PIXELS_OVERRIDE) = saved


class Stages:
    """Device ms (CUDA events) and peak allocated GiB within each stage."""

    def __init__(self):
        self.rows = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        torch.cuda.synchronize()
        self.rows.append((name, start.elapsed_time(end),
                          torch.cuda.max_memory_allocated() / 2 ** 30))


def decode_stages(dec, z, variant: str) -> list:
    """One decode as the calls ``hdr_decode`` makes for ``variant``, stage
    by stage: [(stage, device ms, peak GiB)]."""
    cfg, st = dec.cfg, Stages()
    if variant == "staged":
        mixed = Precision.mixed()
        with st("front: head, level 1, level-0 block 0"):
            buf, m = staged.staged_front(dec, z, mixed)
        with st("level 0, blocks 1.."):
            buf, m = staged.staged_level0(dec, buf, m, mixed)
        with st("tail + epilogue"):
            staged.staged_tail(dec, buf, m, z, CONSERVATIVE, mixed)
        return st.rows
    if variant == "mixed":
        mixed = Precision.mixed()
        with st("head"):
            x = tdecoder.decoder_head(dec, z, precision=mixed, tail_levels=1)
        with st("top level"):
            x = tdecoder._up_level(dec, x, 0, mixed)
        with st("tail"):
            out = tdecoder.decoder_tail(dec, x, precision=mixed)
    else:   # the fast tier, "whole" or "lowmem"
        fast = Precision.fast()
        with st("head"):
            x = conv2d(z / cfg.scale_factor + cfg.shift_factor, dec.conv_in,
                       precision=fast)
            x, m = fused_tail.midstack_apply(dec, x, precision=fast)
            x, m = fused_tail.upper_levels_apply(dec, x, m, precision=fast)
        with st("top level"):
            x, m = fused_tail.top_level_apply(dec, x, m, precision=fast,
                                              lowmem=variant == "lowmem",
                                              owned=True)
        with st("tail"):
            out = tdecoder.decoder_tail(dec, x, precision=fast, moments=m)
    with st("epilogue"):
        hdr_epilogue(out.rgb, out.pre_conv_out, CONSERVATIVE)
    return st.rows


def large_frames(dec, latents, variants, n: int, top: int) -> None:
    """``--lowmem`` / ``--staged``: each variant at each latent side, as
    requests, one profiled request and one run stage by stage."""
    for side in latents:
        z = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, side, side, dec.cfg.z_channels)).astype(np.float32)).cuda()
        for variant in variants:
            tier = "fast" if variant in ("whole", "lowmem") else "mixed"
            label = f"{side * 8}^2 {tier} {variant}"
            prec = TIERS[tier]()
            try:
                with route("whole" if variant == "mixed" else variant):
                    report(label, lambda: decode_summary(hdr_decode(
                        dec, z, CONSERVATIVE, prec)), n, top)
                    rows = decode_stages(dec, z, variant)
                for name, ms, peak in rows:
                    print(f"  stage {name}: {ms:.3f} ms, peak {peak:.3f} GiB",
                          flush=True)
            except torch.cuda.OutOfMemoryError as exc:
                print(f"== {label}: out of device memory: "
                      f"{str(exc).splitlines()[0]}", flush=True)
            torch.cuda.empty_cache()
        del z
        torch.cuda.empty_cache()


AB_TURN = r'''
import time
import numpy as np
import torch
from hdrvae_torch.core.config import Precision, UpscaleConfig
from hdrvae_torch.kernels import swin_attention as ska
from hdrvae_torch.models import swinir
from hdrvae_torch.upscale.pipeline import hdr_upscale

rng = np.random.default_rng(0)
fast = Precision.fast()
blk = swinir.SwinBlock(180, 6, 8, 2.0)
blk.load_state_dict({k: torch.from_numpy(
    (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
    for k, v in blk.state_dict().items()})
blk = blk.requires_grad_(False).cuda()
w = swinir.block_weights(blk, 6, 8, torch.bfloat16)
x = torch.from_numpy(rng.standard_normal((1, 512, 512, 180)).astype(
    np.float32)).cuda().bfloat16()
for shift in (0, 4):
    def run():
        ska.swin_block_fused(x, w, ws=8, shift=shift, precision=fast)
    for _ in range(3):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        run()
    end.record()
    torch.cuda.synchronize()
    print(f"  K7 v1 SwinIR-M 512^2 shift {shift}: "
          f"{start.elapsed_time(end) / 20:.3f} ms", flush=True)
net = swinir.init_swinir(swinir.SwinIRConfig(), seed=3, device="cuda")
img = torch.from_numpy((np.random.default_rng(1).standard_normal(
    (1, 768, 768, 3)) * 1.5 + 0.3).astype(np.float32)).cuda()
for i in range(2):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    hdr_upscale(net, img, UpscaleConfig(), architecture="SwinIR",
                precision=fast)
    end.record()
    torch.cuda.synchronize()
    print(f"  SwinIR-M x4 768^2 fast request {i}: device "
          f"{start.elapsed_time(end):.3f} ms, host wall "
          f"{1e3 * (time.perf_counter() - h0):.3f} ms", flush=True)
'''

# K1 and K2 at chip_smoke.py's phase-3 shapes (and its ragged ones), K2
# stats_only at the 2048^2 junction, then fast decodes at 1024^2 and 2048^2
# and parity and mixed ones at 1024^2 (which launch neither kernel)
AB_CONV = r'''
import time
import numpy as np
import torch
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import conv3x3
from hdrvae_torch.models.params import init_decoder

K1 = [(128, 128, 512, 512, "add"), (256, 256, 512, 512, "add"),
      (512, 512, 256, 256, "add"), (512, 512, 512, 256, "proj"),
      (1024, 1024, 256, 128, "proj"), (1024, 1024, 128, 128, "add"),
      (152, 104, 512, 512, "add")]
K2 = [(128, 128, 512), (256, 256, 512), (512, 512, 256), (304, 208, 512)]


def ms(fn, iters=10):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).cuda().bfloat16()


rng = np.random.default_rng(0)
for h, w, cin, cout, res in K1:
    x = rand(rng, (1, h, w, cin))
    kern = rand(rng, (3, 3, cin, cout), (9 * cin) ** -0.5)
    bias = torch.zeros(cout, device="cuda")
    kw = dict(gamma=torch.ones(1, cin, device="cuda"),
              beta=torch.zeros(1, cin, device="cuda"), emit_stats=True,
              num_groups=32)
    if res == "add":
        kw["residual"] = rand(rng, (1, h, w, cout), 0.5)
    else:
        kw.update(residual=x, res_kernel=rand(rng, (cin, cout), cin ** -0.5))
    t = ms(lambda: conv3x3.fused_conv3x3(x, kern, bias, **kw))
    flops = 2 * h * w * cin * cout * (9 + (res == "proj"))
    print(f"  K1 {h}x{w} {cin}->{cout} {res}: {t:.3f} ms "
          f"({flops / (t * 1e9):.1f} TFLOP/s)", flush=True)
for h, w, c in K2:
    x = rand(rng, (1, h, w, c), 0.5)
    kern = rand(rng, (3, 3, c, c), (9 * c) ** -0.5)
    bias = torch.zeros(c, device="cuda")
    t = ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias, emit_stats=True))
    print(f"  K2 {h}x{w} {c}: {t:.3f} ms "
          f"({32 * h * w * c * c / (t * 1e9):.1f} TFLOP/s)", flush=True)
x = rand(rng, (1, 1024, 1024, 256), 0.5)
kern = rand(rng, (3, 3, 256, 256), (9 * 256) ** -0.5)
bias = torch.zeros(256, device="cuda")
t = ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias, emit_stats=True,
                                        stats_only=True), iters=5)
print(f"  K2 stats_only 1024x1024 256: {t:.3f} ms", flush=True)
del x
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
cons = HDRDecodeConfig(hdr_mode="conservative")
for side, tier in ((128, "fast"), (256, "fast"), (128, "parity"),
                   (128, "mixed")):
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, side, side, 16)).astype(np.float32)).cuda()
    prec = getattr(Precision, tier)()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        decode_summary(hdr_decode(dec, z, cons, prec))
        end.record()
        torch.cuda.synchronize()
        times.append(round(start.elapsed_time(end), 3))
    print(f"  decode {side * 8}^2 {tier}: device ms {times}", flush=True)
    torch.cuda.empty_cache()
'''


# K6 at chip_smoke.py's phase-3 shapes and conv_body, each on its own and
# summed over phase 3's ten, with weights prepared beforehand where the tree
# prepares them (the kernel's main path) and the HWIO kernel otherwise; an
# estimate of K6 in one RRDBNetConfig() 512^2 tile forward (each shape's
# time times its launches there), and one such forward measured (K6's
# kernel events under torch.profiler, the forward by CUDA events); then
# three fast and one parity ESRGAN x4 hdr_upscale requests of a 1024^2 HDR
# image.  K6_TABLE becomes this tree's chip_smoke.py K6 table (an older
# tree's chip_smoke may lack it): (name, H, W, input widths, Cout, act,
# residual scale, float32 out, launches a tile forward, in phase 3's sum).
AB_ESRGAN = r'''
import time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from hdrvae_torch.core.config import Precision, UpscaleConfig
from hdrvae_torch.kernels import dense_conv
from hdrvae_torch.models.rrdbnet import RRDBNetConfig, init_rrdbnet
from hdrvae_torch.models.rrdbnet_fused import rrdbnet_fused_apply
from hdrvae_torch.upscale.pipeline import hdr_upscale

K6 = K6_TABLE


def ms(fn, iters=10):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).cuda().bfloat16()


rng = np.random.default_rng(0)
summed = forward = 0.0
for name, h, w, cins, cout, act, rs, f32, n, in_sum in K6:
    xs = [rand(rng, (1, h, w, c), 0.5) for c in cins]
    kern = rand(rng, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5)
    bias = torch.zeros(cout, device="cuda")
    kw = dict(act=act, out_dtype=torch.float32 if f32 else None)
    if rs is not None:
        kw.update(residual=rand(rng, (1, h, w, cout), 0.5), res_scale=rs)
    if hasattr(dense_conv, "prepare_weights"):
        pw = dense_conv.prepare_weights(kern, bias, cins)
        t = ms(lambda: dense_conv.dense_conv3x3(xs, pw, **kw))
    else:
        t = ms(lambda: dense_conv.dense_conv3x3(xs, kern, bias, **kw))
    summed += t if in_sum else 0.0
    forward += n * t
    print(f"  K6 {name} {h}x{w} {'+'.join(map(str, cins))}->{cout}: "
          f"{t:.3f} ms", flush=True)
    del xs, kern, kw
    torch.cuda.empty_cache()
print(f"  K6 summed over phase-3's ten shapes: {summed:.3f} ms; one "
      f"RRDBNetConfig() tile forward, estimate (launch-weighted): "
      f"{forward:.3f} ms", flush=True)
net = init_rrdbnet(RRDBNetConfig(), seed=2, device="cuda")
tile = torch.from_numpy((rng.standard_normal((1, 512, 512, 3)) * 1.5
                         + 0.3).astype(np.float32)).cuda()
fast = Precision.fast()
rrdbnet_fused_apply(net, tile, precision=fast)   # prepares the weights
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    start.record()
    rrdbnet_fused_apply(net, tile, precision=fast)
    end.record()
    torch.cuda.synchronize()
k6 = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
      if e.device_type == DeviceType.CUDA and "dense_" in e.name]
print(f"  K6 in one RRDBNetConfig() 512^2 tile forward, measured: "
      f"{len(k6)} launches, K6 device {sum(k6):.3f} ms (torch.profiler); "
      f"the forward {start.elapsed_time(end):.3f} ms (CUDA events)",
      flush=True)
img = torch.from_numpy((np.random.default_rng(1).standard_normal(
    (1, 1024, 1024, 3)) * 1.5 + 0.3).astype(np.float32)).cuda()
for tier in ("fast", "fast", "fast", "parity"):
    prec = getattr(Precision, tier)()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    hdr_upscale(net, img, UpscaleConfig(), architecture="ESRGAN",
                precision=prec)
    end.record()
    torch.cuda.synchronize()
    print(f"  ESRGAN x4 1024^2 {tier} request: device "
          f"{start.elapsed_time(end):.3f} ms, host wall "
          f"{1e3 * (time.perf_counter() - h0):.3f} ms", flush=True)
'''


# K3 bf16, K3 f32 and K3 3-pass at the fast, parity and mixed decodes' mid
# attention, N = 16,384 and 65,536 (the 1024^2 and 2048^2 decodes), C =
# 512, unmasked and with the bucketed phase's live fraction (121 x 100 of
# 128 x 128, scaled to the grid), CUDA events over 10 launches (3 at N =
# 65,536) after 2 warm-ups; then three requests each of fast, parity and
# mixed decodes at 1024^2 and 2048^2, the mixed ones with their peak memory
# and one more under torch.profiler: K3 3-pass's share (its kernel and its
# split, where the tree has one) of the request's summed device time
AB_ATTN = r'''
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import attention
from hdrvae_torch.models.params import init_decoder


def ms(fn, iters=10):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


rng = np.random.default_rng(0)
for side in (128, 256):
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, side, side, 512)).astype(np.float32)).cuda() for _ in range(3))
    live = (121 * side // 128, 100 * side // 128)
    grid = torch.arange(side, device="cuda")
    kv = (grid[:, None] < live[0]) & (grid[None, :] < live[1])
    n = side * side
    for name, fn, cast, passes in (
            ("bf16", attention.flash_attention_bf16, torch.bfloat16, 1),
            ("f32", attention.flash_attention_f32, torch.float32, 1),
            ("3-pass", attention.flash_attention_3pass, torch.float32, 3)):
        qc, kc, vc = (x.to(cast) for x in (q, k, v))
        for label, mask in (("unmasked", None),
                            (f"live {live[0]} x {live[1]}", kv)):
            t = ms(lambda: fn(qc, kc, vc, mask),
                   iters=10 if side == 128 else 3)
            print(f"  K3 {name} N={n} C=512 {label}: {t:.3f} ms "
                  f"({passes * 4 * n * n * 512 / (t * 1e9):.1f} TFLOP/s)",
                  flush=True)
        del qc, kc, vc
    del q, k, v
torch.cuda.empty_cache()
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
cons = HDRDecodeConfig(hdr_mode="conservative")
for tier in ("fast", "parity", "mixed"):
    for side in (128, 256):
        z = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, side, side, 16)).astype(np.float32)).cuda()
        prec = getattr(Precision, tier)()

        def run():
            decode_summary(hdr_decode(dec, z, cons, prec))
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(round(start.elapsed_time(end), 3))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  decode {side * 8}^2 {tier}: device ms {times}, peak "
              f"{peak:.3f} GiB", flush=True)
        if tier == "mixed":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            dev = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            total = sum(x for _, x in dev)
            k3 = sum(x for nm, x in dev if "flash_3pass_kernel" in nm)
            sp = sum(x for nm, x in dev if "split_qkv_kernel" in nm)
            print(f"  decode {side * 8}^2 mixed, profiled: K3 3-pass "
                  f"{k3:.3f} ms + split {sp:.3f} ms of {total:.3f} ms summed "
                  f"device time ({100 * (k3 + sp) / total:.2f} %)",
                  flush=True)
        del z
        torch.cuda.empty_cache()
'''


# K8 at chip_smoke.py's K8_SHAPE (HAT-M's 512^2-tile OCAB: 1024 windows, 6
# heads, 256 queries, 576 keys) beside SDPA bf16 with the bias as its mask,
# CUDA events over 10 launches after 2 warm-ups; then fast HAT-M x4
# hdr_upscale requests of a 1024^2 HDR image from numpy seed 1: one to warm
# up, two timed, and one under torch.profiler (K8's launches and device
# time against the device time of all the request's events); then the
# controls, which do not run K8: two fast SwinIR-M x4 requests of the same
# image (the first warms up) and three fast 1024^2 decodes
AB_HAT = r'''
import time
import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      Precision, UpscaleConfig)
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import ocab
from hdrvae_torch.models.hat import HATConfig, init_hat
from hdrvae_torch.models.params import init_decoder
from hdrvae_torch.models.swinir import SwinIRConfig, init_swinir
from hdrvae_torch.upscale.pipeline import hdr_upscale


def ms(fn, iters=10):
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), 1e3 * (time.perf_counter() - h0)


rng = np.random.default_rng(0)
nwb, heads, nq, nk = 1024, 6, 256, 576


def qkv(n, scale):
    t = torch.from_numpy((rng.standard_normal((nwb, heads, n, 32)) * scale)
                         .astype(np.float32)).cuda().bfloat16()
    t[..., 30:] = 0
    return t


q, k, v = qkv(nq, 30 ** -0.5), qkv(nk, 1.0), qkv(nk, 1.0)
bias = torch.from_numpy(rng.standard_normal((heads, nq, nk)).astype(
    np.float32)).cuda()
kw = dict(compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16)
t = ms(lambda: ocab.ocab_attention(q, k, v, bias, **kw))
mask = bias.bfloat16()
tl = ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               scale=1.0))
print(f"  K8 [{nwb}, {heads}, {nq}, {nk}]: {t:.3f} ms; SDPA bf16 (the bias "
      f"as a bf16 mask) {tl:.3f} ms", flush=True)
del q, k, v, bias, mask
torch.cuda.empty_cache()

fast = Precision.fast()
img = torch.from_numpy((np.random.default_rng(1).standard_normal(
    (1, 1024, 1024, 3)) * 1.5 + 0.3).astype(np.float32)).cuda()
for name, arch, net, n in (
        ("HAT-M", "HAT", init_hat(HATConfig(), seed=4, device="cuda"), 3),
        ("SwinIR-M", "SwinIR",
         init_swinir(SwinIRConfig(), seed=3, device="cuda"), 2)):
    def run():
        hdr_upscale(net, img, UpscaleConfig(), architecture=arch,
                    precision=fast)
    for i in range(n):
        d, w = timed(run)
        print(f"  {name} x4 1024^2 fast request {i}: device {d:.3f} ms, "
              f"host wall {w:.3f} ms", flush=True)
    if arch == "HAT":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(x for _, x in dev)
        k8 = [x for name_, x in dev if "ocab_kernel" in name_]
        print(f"  {name} x4 1024^2 fast, profiled: K8 {len(k8)} launches, "
              f"{sum(k8):.3f} ms of {total:.3f} ms summed device time "
              f"({100 * sum(k8) / total:.2f} %)", flush=True)
    del net
    torch.cuda.empty_cache()
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
z = torch.from_numpy(np.random.default_rng(1).standard_normal(
    (1, 128, 128, 16)).astype(np.float32)).cuda()
cons = HDRDecodeConfig(hdr_mode="conservative")
times = [round(timed(lambda: decode_summary(hdr_decode(dec, z, cons, fast)))[0],
               3) for _ in range(3)]
print(f"  decode 1024^2 fast: device ms {times}", flush=True)
'''

# --upscale --model ... --ab-tree: fast x4 requests of a 1024^2 HDR image
# (numpy seed 1) through each model of MODELS (one warms up, two timed),
# then three fast 1024^2 decodes as the control
AB_UPSCALE = r'''
import time
import numpy as np
import torch
from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                      Precision, UpscaleConfig)
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.models.hat import HATConfig, init_hat
from hdrvae_torch.models.params import init_decoder
from hdrvae_torch.models.swin2sr import Swin2SRConfig, init_swin2sr
from hdrvae_torch.models.swinir import SwinIRConfig, init_swinir
from hdrvae_torch.upscale.pipeline import hdr_upscale


def timed(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), 1e3 * (time.perf_counter() - h0)


NETS = {"swinir": ("SwinIR-M", "SwinIR",
                   lambda: init_swinir(SwinIRConfig(), seed=3, device="cuda")),
        "swin2sr": ("Swin2SR-M", "Swin2SR",
                    lambda: init_swin2sr(Swin2SRConfig(), seed=5,
                                         device="cuda")),
        "hat": ("HAT-M", "HAT",
                lambda: init_hat(HATConfig(), seed=4, device="cuda")),
        "esrgan": None}
fast = Precision.fast()
img = torch.from_numpy((np.random.default_rng(1).standard_normal(
    (1, 1024, 1024, 3)) * 1.5 + 0.3).astype(np.float32)).cuda()
for model in MODELS:
    if NETS.get(model) is None:
        continue
    name, arch, make = NETS[model]
    net = make()

    def run():
        hdr_upscale(net, img, UpscaleConfig(), architecture=arch,
                    precision=fast)
    for i in range(3):
        d, w = timed(run)
        print(f"  {name} x4 1024^2 fast request {i}"
              f"{' (warm-up)' if i == 0 else ''}: device {d:.3f} ms, host "
              f"wall {w:.3f} ms", flush=True)
    del net
    torch.cuda.empty_cache()
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
z = torch.from_numpy(np.random.default_rng(1).standard_normal(
    (1, 128, 128, 16)).astype(np.float32)).cuda()
cons = HDRDecodeConfig(hdr_mode="conservative")
times = [round(timed(lambda: decode_summary(hdr_decode(dec, z, cons, fast)))[0],
               3) for _ in range(3)]
print(f"  decode 1024^2 fast: device ms {times}", flush=True)
'''


def k6_table() -> list:
    """``chip_smoke.py``'s K6 shapes with their launches a tile forward and
    whether phase 3 sums them (the turn's K6_TABLE)."""
    import chip_smoke
    return [shape + (chip_smoke.K6_FORWARD.get(shape[0], 0),
                     shape in chip_smoke.K6_SHAPES)
            for shape in chip_smoke.K6_SHAPES + chip_smoke.K6_EXTRA[:1]]


# K5 at chip_smoke.py's K5_SHAPES and its inputs (the wrapper by CUDA
# events over 5 launches after 2 warm-ups; the kernel's device time from
# torch.profiler over 5 more), then three requests each (the first warms
# up) of fast decodes at 2048^2 and 4096^2 with the whole-image and the
# streamed top level (LOWMEM_MIN_PIXELS set in-process), and as controls,
# which do not launch K5, a fast 1024^2 and a mixed 2048^2 decode on their
# default routes
AB_LOWMEM = r'''
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import conv3x3
from hdrvae_torch.models import fused_tail
from hdrvae_torch.models.params import init_decoder

rng = np.random.default_rng(5)
wrap_sum = dev_sum = 0.0
for h, w in cs.K5_SHAPES:
    cin, cm, cout = cs.K5_CIN, cs.K5_CM, cs.K5_COUT
    args = (cs._bf16(rng, (1, h, w, cin), 0.5),
            cs._bf16(rng, (3, 3, cin, cm), (9 * cin) ** -0.5),
            cs._uniform(rng, -0.1, 0.1, cm), cs._uniform(rng, 0.5, 1.5, (1, cm)),
            cs._uniform(rng, -0.5, 0.5, (1, cm)),
            cs._bf16(rng, (3, 3, cm, cout), (9 * cm) ** -0.5),
            cs._uniform(rng, -0.1, 0.1, cout))

    def run():
        conv3x3.upconv_gn_conv3x3(*args, emit_stats=True, num_groups=32)
    wrap = cs.cuda_ms(run, iters=5, warmup=2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    dev = sum(e.device_time_total for e in prof.key_averages()
              if "upconv" in e.key) / 5 / 1e3
    wrap_sum, dev_sum = wrap_sum + wrap, dev_sum + dev
    print(f"  K5 {h}x{w}->{2 * h}x{2 * w}: wrapper {wrap:.3f} ms, device "
          f"{dev:.3f} ms", flush=True)
    del args
print(f"  K5 K5_SHAPES sum: wrapper {wrap_sum:.3f} ms, device "
      f"{dev_sum:.3f} ms", flush=True)
torch.cuda.empty_cache()
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
cons = HDRDecodeConfig(hdr_mode="conservative")
default = fused_tail.LOWMEM_MIN_PIXELS
for tier, side, route in (("fast", 256, "whole"), ("fast", 256, "streamed"),
                          ("fast", 512, "whole"), ("fast", 512, "streamed"),
                          ("fast", 128, None), ("mixed", 256, None)):
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, side, side, 16)).astype(np.float32)).cuda()
    prec = getattr(Precision, tier)()
    fused_tail.LOWMEM_MIN_PIXELS = {"whole": 1 << 62, "streamed": 1}.get(
        route, default)
    k5 = conv3x3.upconv_gn_conv3x3.launches
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        decode_summary(hdr_decode(dec, z, cons, prec))
        end.record()
        torch.cuda.synchronize()
        times.append(round(start.elapsed_time(end), 3))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  decode {side * 8}^2 {tier} {route or 'default route'}: device "
          f"ms {times}, peak {peak:.3f} GiB, K5 launches "
          f"{conv3x3.upconv_gn_conv3x3.launches - k5}", flush=True)
    del z
    torch.cuda.empty_cache()
fused_tail.LOWMEM_MIN_PIXELS = default
'''


# K4 at chip_smoke.py's K4_SHAPE (a post-SiLU map) in float32 and bf16,
# then three requests each of fast 1024^2 and 2048^2 and parity and mixed
# 1024^2 decodes, with their epilogue's K4 launches
AB_EPILOGUE = r'''
import numpy as np
import torch
import chip_smoke as cs
from hdrvae_torch.core.config import DecoderConfig, HDRDecodeConfig, Precision
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
from hdrvae_torch.kernels import epilogue
from hdrvae_torch.models.params import init_decoder

g = torch.Generator(device="cuda").manual_seed(4)
x = torch.nn.functional.silu(
    torch.randn(cs.K4_SHAPE, generator=g, device="cuda") * 2.0)
for pre in (x, x.bfloat16()):
    t = cs.cuda_ms(lambda: epilogue.collapse_and_stats_fused(pre), iters=10)
    print(f"  K4 {list(cs.K4_SHAPE)} {pre.dtype}: {t:.3f} ms", flush=True)
del x, pre
torch.cuda.empty_cache()
dec = init_decoder(DecoderConfig(), seed=0, device="cuda")
cons = HDRDecodeConfig(hdr_mode="conservative")
for tier, side in (("fast", 128), ("fast", 256), ("parity", 128),
                   ("mixed", 128)):
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, side, side, 16)).astype(np.float32)).cuda()
    prec = getattr(Precision, tier)()
    k4 = epilogue.collapse_and_stats_fused.launches
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        decode_summary(hdr_decode(dec, z, cons, prec))
        end.record()
        torch.cuda.synchronize()
        times.append(round(start.elapsed_time(end), 3))
    print(f"  decode {side * 8}^2 {tier}, "
          f"{'fused' if cons.use_fused_epilogue else 'default'} epilogue: "
          f"device ms {times}, K4 launches "
          f"{epilogue.collapse_and_stats_fused.launches - k4}", flush=True)
    del z
    torch.cuda.empty_cache()
'''

AB_TURNS = {"swin": lambda models: AB_TURN,
            "conv": lambda models: AB_CONV,
            "esrgan": lambda models: AB_ESRGAN.replace(
                "K6_TABLE", repr(k6_table())),
            "attn": lambda models: AB_ATTN, "hat": lambda models: AB_HAT,
            "lowmem": lambda models: AB_LOWMEM,
            "epilogue": lambda models: AB_EPILOGUE,
            "upscale": lambda models: AB_UPSCALE.replace("MODELS",
                                                         repr(models))}


FUSED = 'HDRDecodeConfig(hdr_mode="conservative", use_fused_epilogue=True)'


def ab(other: str, turns, models=(), fused: bool = False) -> int:
    """The turns of ``--ab-tree``: this tree, ``other``, ``other``, this
    (``models`` for the upscale turn; ``fused``: every decode with the
    fused epilogue)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    there = os.path.abspath(other)
    scripts = [AB_TURNS[t](list(models)) for t in turns]
    if fused:
        scripts = [t.replace('HDRDecodeConfig(hdr_mode="conservative")',
                             FUSED) for t in scripts]
    for label, root in (("this", here), ("other", there), ("other", there),
                        ("this", here)):
        print(f"== {label}: {root}", flush=True)
        for turn in scripts:
            proc = subprocess.run([sys.executable, "-c", turn], cwd=root,
                                  env=dict(os.environ, PYTHONPATH=root),
                                  timeout=900)
            if proc.returncode != 0:
                return proc.returncode
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", default=None,
                    help="latent sides (default 128 256; 128 with "
                         "--upscale; 256 512 with --lowmem or --staged)")
    ap.add_argument("--tiers", nargs="+", default=None, choices=list(TIERS),
                    help="default: all three; fast parity with --upscale")
    ap.add_argument("--upscale", action="store_true",
                    help="profile hdr_upscale of the parity decode's image")
    ap.add_argument("--model", nargs="+", default=["esrgan"],
                    choices=list(UPSCALERS),
                    help="upscalers profiled with --upscale")
    ap.add_argument("--lowmem", action="store_true",
                    help="fast tier: whole-image against the low-memory "
                         "top level, with per-stage peaks")
    ap.add_argument("--staged", action="store_true",
                    help="mixed tier: whole-image against the staged "
                         "executor, with per-stage peaks")
    ap.add_argument("--requests", type=int, default=3,
                    help="unprofiled decode requests per run")
    ap.add_argument("--top", type=int, default=12,
                    help="kernel names listed per run")
    ap.add_argument("--ab-tree", metavar="DIR",
                    help="compare K7, a SwinIR-M upscale, K1, K2, decodes, "
                         "K6, ESRGAN upscales, K3, K8, HAT-M upscales, K5 "
                         "and streamed decodes with the tree in DIR instead")
    ap.add_argument("--ab-only", nargs="+", choices=list(AB_TURNS),
                    default=[t for t in AB_TURNS if t != "upscale"],
                    help="the --ab-tree turns run (default: all)")
    ap.add_argument("--fused-epilogue", action="store_true",
                    help="decode with HDRDecodeConfig.use_fused_epilogue "
                         "(K4), in the --ab-tree turns too")
    args = ap.parse_args()
    global CONSERVATIVE
    if args.fused_epilogue:
        CONSERVATIVE = HDRDecodeConfig(hdr_mode="conservative",
                                       use_fused_epilogue=True)
    latents = args.latent or ([128] if args.upscale else [128, 256])
    tiers = args.tiers or (["fast", "parity"] if args.upscale
                           else list(TIERS))
    if not torch.cuda.is_available():
        print("profile_decode_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if args.ab_tree:
        # --upscale --model hat: the HAT turn alone; --upscale with other
        # models: their x4 requests
        if args.upscale:
            turns = ["hat"] if args.model == ["hat"] else ["upscale"]
        else:
            turns = args.ab_only
        return ab(args.ab_tree, turns, args.model, args.fused_epilogue)

    cfg = DecoderConfig()
    dec = init_decoder(cfg, seed=0, device="cuda")
    if args.lowmem or args.staged:
        variants = ((["whole", "lowmem"] if args.lowmem else [])
                    + (["mixed", "staged"] if args.staged else []))
        large_frames(dec, args.latent or [256, 512], variants,
                     args.requests, args.top)
        return 0
    for side in latents:
        z = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, side, side, cfg.z_channels)).astype(np.float32)).cuda()
        if args.upscale:
            image = hdr_decode(dec, z, CONSERVATIVE,
                               Precision.parity()).image
            for model in args.model:
                arch, make = UPSCALERS[model]
                net = make()
                for tier in tiers:
                    prec = TIERS[tier]()
                    report(f"upscale {arch} {side * 8}^2 -> {side * 32}^2 "
                           f"{tier}",
                           lambda: hdr_upscale(net, image, UpscaleConfig(),
                                               architecture=arch,
                                               precision=prec), 2, args.top)
                del net
                torch.cuda.empty_cache()
            del image
        else:
            for tier in tiers:
                prec = TIERS[tier]()
                report(f"{side * 8}^2 {tier}",
                       lambda: decode_summary(hdr_decode(dec, z,
                                                         CONSERVATIVE,
                                                         prec)),
                       args.requests, args.top)
        del z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
