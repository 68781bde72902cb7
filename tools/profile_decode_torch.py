#!/usr/bin/env python3
"""Profile the PyTorch port's decode on one NVIDIA GPU.

    python3 tools/profile_decode_torch.py [--latent 128 256]
                                          [--tiers fast parity mixed]

For each latent side (128 gives a 1024^2 image, 256 a 2048^2 one) and
tier, the full-width Flux.1 decoder (``DecoderConfig()``, random weights
from numpy seed 0, latent from seed 1) runs ``hdr_decode`` +
``decode_summary`` in conservative mode, as ``chip_smoke.py`` does:

- three requests unprofiled: device ms from CUDA events, host wall ms, and
  the peak of allocated device memory;
- one more under ``torch.profiler``, reported over the device's own events
  only (kernels, memcpy, memset), never the operator rows that enclose
  them: their summed time, the time the device was busy (the union of
  their intervals) against the request's host wall, and each kernel name's
  share of the summed time.

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
                                      Precision)
from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode  # noqa: E402
from hdrvae_torch.models.params import init_decoder  # noqa: E402

TIERS = {"fast": Precision.fast, "parity": Precision.parity,
         "mixed": Precision.mixed}


def request(dec, z, prec) -> tuple[float, float]:
    """One decode with its summary fetched: (device ms, host wall ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    res = hdr_decode(dec, z, HDRDecodeConfig(hdr_mode="conservative"), prec)
    end.record()
    decode_summary(res)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--tiers", nargs="+", default=list(TIERS),
                    choices=list(TIERS))
    ap.add_argument("--top", type=int, default=12,
                    help="kernel names listed per run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)

    cfg = DecoderConfig()
    dec = init_decoder(cfg, seed=0, device="cuda")
    for side in args.latent:
        z = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, side, side, cfg.z_channels)).astype(np.float32)).cuda()
        for tier in args.tiers:
            prec = TIERS[tier]()
            torch.cuda.reset_peak_memory_stats()
            walls = [request(dec, z, prec) for _ in range(3)]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = request(dec, z, prec)
            rows, total, busy = device_rows(prof)
            launches = sum(n for _, n in rows.values())
            print(f"== {side * 8}^2 {tier}: device ms "
                  f"{[round(d, 3) for d, _ in walls]}, host wall ms "
                  f"{[round(h, 3) for _, h in walls]}, peak {peak:.3f} GiB; "
                  f"profiled: wall {wall:.3f} ms, kernels {total:.3f} ms "
                  f"summed, busy {busy:.3f} ms ({100 * busy / wall:.1f} % "
                  f"of wall), {launches} device events", flush=True)
            ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
            for name, (ms, n) in ranked[:args.top]:
                print(f"  {ms:10.3f} ms {100 * ms / total:5.1f} %  x{n:<4d} "
                      f"{name[:110]}", flush=True)
            del prof
        del z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
