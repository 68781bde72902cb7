#!/usr/bin/env python3
"""Price float32 contractions on an NVIDIA GPU: the port's counterpart of
``tools/perf/pallas_f32_dot_probe.py``.

    python3 tools/f32_dot_probe_torch.py [--m 8192 --k 256 --n 256]

One decoder-class contraction, x [M, K] @ w [K, N] (a row block of the
512^2 level-1 conv, the JAX probe's shape), through the port's K12 kernel
(``hdrvae_torch/kernels/f32_dot.py``) in its three modes: exact float32 on
the CUDA cores (highest), the bf16x3 split that the mixed tier's 3-pass
contractions compute (high), and one bf16 pass (default).  For each mode:
the kernel's and its plain version's device ms, the kernel's max-abs
against the plain version and, with the relative error, against a float64
product of the same operands.  For high and default also the two launches
of a call apart: w's split alone (``split_ms``) and the tensor-core kernel
alone on parts split beforehand (``main_ms``).  Beside them the library rows, which the
port never calls: ``torch.matmul`` in float32 with TF32 off and on, and in
bf16.  Prints one JSON object; writes nothing.

Times are CUDA-event means over back-to-back launches queued behind a
sleeping kernel (so the host's launch rate does not show), the operands
rotating over four copies (67 MB at the default shape, past the 50 MB L2).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from hdrvae_torch.kernels import _build  # noqa: E402
from hdrvae_torch.kernels.f32_dot import (PRECISIONS, f32_dot,  # noqa: E402
                                          f32_dot_reference, split_w)

M, K, N = 8192, 256, 256
COPIES = 4                 # operand copies the timed launches rotate over
SLEEP_CYCLES = 50_000_000  # ~25 ms: longer than queueing the launches


def operands(m: int = M, k: int = K, n: int = N, seed: int = 0,
             device: str = "cuda") -> tuple:
    """x ~ N(0, 1) [m, k] and w ~ N(0, 0.05^2) [k, n] in float32 from a
    numpy seed (the JAX probe's scales)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def device_ms(fn, iters: int = 100, warmup: int = 3) -> float:
    """Mean device ms of fn(i), i = 0 .. iters - 1, from CUDA events around
    launches queued behind ``torch.cuda._sleep`` after a warm-up."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _main(x: torch.Tensor, parts: torch.Tensor, y: torch.Tensor,
          mode: str) -> None:
    """The tensor-core kernel alone on parts ``split_w`` wrote."""
    (m, k), n = x.shape, y.shape[1]
    _build.check(_build.library().hdrvae_f32_dot(
        x.data_ptr(), parts.data_ptr(), y.data_ptr(), m, n, k,
        PRECISIONS.index(mode), torch.cuda.current_stream().cuda_stream),
        "hdrvae_f32_dot")


def _err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.double() - ref.double()).abs().max().item()


def measure(m: int = M, k: int = K, n: int = N, *, seed: int = 0,
            iters: int = 100) -> dict:
    """The probe's rows on the current CUDA device (see module doc)."""
    if not torch.cuda.is_available():
        raise RuntimeError("f32_dot_probe_torch: no CUDA device")
    x, w = operands(m, k, n, seed)
    exact = x.double() @ w.double()
    scale = exact.abs().max().item()
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    ws = [w] + [w.clone() for _ in range(COPIES - 1)]
    modes = {}
    for mode in PRECISIONS:
        y = f32_dot(x, w, precision=mode)
        ref = f32_dot_reference(x, w, precision=mode)
        torch.cuda.synchronize()
        e = _err(y, exact)
        modes[mode] = {
            "ms": device_ms(lambda i: f32_dot(
                xs[i % COPIES], ws[i % COPIES], precision=mode), iters),
            "plain_ms": device_ms(lambda i: f32_dot_reference(
                xs[i % COPIES], ws[i % COPIES], precision=mode), iters),
            "max_abs_vs_plain": _err(y, ref),
            "plain_max_abs": ref.abs().max().item(),
            "max_abs_vs_exact": e, "rel_vs_exact": e / scale}
        if mode != "highest":
            lo = mode == "high"
            parts = [split_w(t, lo=lo) for t in ws]
            ys = [torch.empty_like(y) for _ in range(COPIES)]
            modes[mode]["split_ms"] = device_ms(
                lambda i: split_w(ws[i % COPIES], lo=lo), iters)
            modes[mode]["main_ms"] = device_ms(lambda i: _main(
                xs[i % COPIES], parts[i % COPIES], ys[i % COPIES], mode),
                iters)
    library = {}
    for name, tf32, dtype in (("matmul_f32", False, torch.float32),
                              ("matmul_tf32", True, torch.float32),
                              ("matmul_bf16", False, torch.bfloat16)):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            xd, wd = ([t.to(dtype) for t in xs], [t.to(dtype) for t in ws])
            e = _err(xd[0] @ wd[0], exact)
            library[name] = {
                "ms": device_ms(lambda i: xd[i % COPIES] @ wd[i % COPIES],
                                iters),
                "max_abs_vs_exact": e, "rel_vs_exact": e / scale}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return {"shape": [m, k, n], "device": torch.cuda.get_device_name(0),
            "max_abs_exact": scale, "modes": modes, "library": library}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_dot_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(measure(args.m, args.k, args.n, seed=args.seed,
                             iters=args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
