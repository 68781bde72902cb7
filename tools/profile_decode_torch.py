#!/usr/bin/env python3
"""Profile the PyTorch port's decode, or its upscale, on one NVIDIA GPU.

    python3 tools/profile_decode_torch.py [--latent 128 256]
                                          [--tiers fast parity mixed]
    python3 tools/profile_decode_torch.py --upscale [--latent 128]
                                          [--tiers fast parity]
                                          [--model esrgan swinir hat swin2sr]
    python3 tools/profile_decode_torch.py --ab-tree DIR

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

With ``--ab-tree DIR`` it instead compares this tree with another copy of
the repository (an older commit unpacked into DIR) in turns: this, DIR,
DIR, this.  Each turn is a subprocess from its tree's root, which builds
and loads that tree's kernels: K7 ``swin_block_fused`` (v1 body) at
SwinIR-M's 512^2 tile (C 180, 6 heads, window 8), unshifted and shifted,
CUDA events over 20 launches after 3 warm-ups, then two fast
``hdr_upscale`` requests of SwinIR-M x4 (seed 3) on a 768^2 HDR image from
numpy seed 1.

The script only reads: it changes nothing in the package.  Without a CUDA
device it exits non-zero.
"""

from __future__ import annotations

import argparse
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
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode  # noqa: E402
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
# the __global__ functions of hdrvae_torch/csrc (K1/K2, K3, K4, K6, K7, K8)
PORT_KERNELS = ("conv_tile_kernel", "group_stats_kernel", "flash_bf16_kernel",
                "flash_f32_kernel", "collapse_stats_kernel",
                "stats_finalize_kernel", "dense_conv_kernel",
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


def ab(other: str) -> int:
    """The turns of ``--ab-tree``: this tree, ``other``, ``other``, this."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    there = os.path.abspath(other)
    for label, root in (("this", here), ("other", there), ("other", there),
                        ("this", here)):
        print(f"== {label}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", AB_TURN], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root),
                              timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", default=None,
                    help="latent sides (default 128 256; 128 with "
                         "--upscale)")
    ap.add_argument("--tiers", nargs="+", default=None, choices=list(TIERS),
                    help="default: all three; fast parity with --upscale")
    ap.add_argument("--upscale", action="store_true",
                    help="profile hdr_upscale of the parity decode's image")
    ap.add_argument("--model", nargs="+", default=["esrgan"],
                    choices=list(UPSCALERS),
                    help="upscalers profiled with --upscale")
    ap.add_argument("--top", type=int, default=12,
                    help="kernel names listed per run")
    ap.add_argument("--ab-tree", metavar="DIR",
                    help="compare K7 and a SwinIR-M upscale with the tree "
                         "in DIR instead")
    args = ap.parse_args()
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
        return ab(args.ab_tree)

    cfg = DecoderConfig()
    dec = init_decoder(cfg, seed=0, device="cuda")
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
                       3, args.top)
        del z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
