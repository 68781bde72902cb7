#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

No other set-up: the CUDA kernels are built from ``hdrvae_torch/csrc`` by
``nvcc`` on first use.  Phases, each of which raises on failure:

1. device: the card's name and power limit, as the line nvidia-smi prints;
2. build: compile the kernels, print the build time and ptxas' register
   and spill report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (K1-K4: a 1024^2 decode; K6: one 512^2
   tile of the full-width ESRGAN x4 net; K7: one 512^2 tile of SwinIR-M,
   unshifted and shifted, of HAT-M with its CAB residual, and a ragged
   128 x 120 tile; K7's SwinV2 body: one 512^2 tile of Swin2SR-M,
   unshifted and shifted, a window-7 grid and the ragged tile; K8: HAT-M's
   OCAB on a 512^2 tile; K2's stats_only mode, its sums bit-equal to K2's
   with y written, and K5: the 2048^2 decode's top-level junction and a
   ragged map; the staged Swin chain's K10, K9 and K11 at K7's v1 shapes,
   each on the previous kernel's output, and the chain against K7 on the
   same inputs and weights; K12 at the probe's 8192 x 256 x 256 in its
   three precisions), with its tolerance, and both timed with CUDA
   events after a warm-up; beside them the least time the card could take
   (bound_ms: the function's operations over the peak rate of their type,
   or its bytes, each input read once and each output written once, over
   the memory rate, whichever is larger) and, where one PyTorch call
   computes the same function, that call's time (library_ms; the port
   never calls it);
4. decode: the full-width Flux.1 decoder (random weights from a numpy
   seed) on a [1, 128, 128, 16] latent through ``hdr_decode`` +
   ``decode_summary`` in the fast, parity and mixed tiers, three requests
   each (the first warms cuDNN up); fast is held against the unfused fast
   path, mixed against parity; then one fast and one parity decode with
   the fused epilogue (K4) held to the default path's; then the epilogue
   in all four modes on one decoder output;
5. large frames: fast decodes at 2048^2 and 4096^2 with the whole-image
   and the streamed top level (``LOWMEM_MIN_PIXELS`` set in-process), the
   streamed one launching K5 and K2 stats_only once a request and the
   whole-image one neither, held to each other (and at 2048^2 to the
   unfused fast path); a mixed 2048^2 decode through the staged executor
   (its route forced by the test hook) held to the whole-image one; and
   one mixed request that ``hdr_decode`` routes to the staged executor by
   itself, at the smallest latent side whose frame reaches
   ``STAGED_MIN_PIXELS``; each with its time and peak memory;
6. EXR: the parity image written as a 32-bit EXR and read back bit-exact;
7. upscale: the full-width ESRGAN x4 (RRDBNet, random weights from a numpy
   seed) through ``hdr_upscale`` on the parity image, 1024^2 -> 4096^2 in
   512^2 tiles (9 tiles x 2 passes): two fast requests and one parity
   request, the fused K6 chain held to the unfused fast layers on one
   tile, and one fast request with small_blur and local_fix;
8. SwinIR, HAT and Swin2SR upscale: the full-width SwinIR-M x4, HAT-M x4
   and Swin2SR-M x4 (random weights from numpy seeds) through
   ``hdr_upscale`` on a 768^2 crop of the parity image (4 tiles x 2
   passes), one fast and one parity request each; the fast one must
   launch K7 (Swin2SR: its v2 body) once per block and K8 once per OCAB
   of every tile run, the parity one neither; the fused chain is held to
   the unfused fast layers on the first tile's raw output;
9. Swin chain: the body of the full-width SwinIR-M (seed 3) on one 512^2
   tile of the decoded image, walked twice, each block through the staged
   chain (K10 -> K9 -> K11, 36 launches each), then through K7 (36), each
   group's conv + residual after its blocks; the two bodies held to each
   other, and both walks timed;
10. f32 dot probe: ``tools/f32_dot_probe_torch.py``'s measurement, K12's
   main path: each precision's time and error against a float64 product,
   held to its class, beside ``torch.matmul`` in float32 (TF32 off and on)
   and bf16;
11. launch counts: K1, K2 and K3 ran in the fast decode, K3 in parity and
   mixed, K4 in the fused-epilogue decodes, K5 and K2 stats_only in the
   low-memory fast 2048^2 decode, K6 in the fast ESRGAN upscale, K7 in the
   fast SwinIR and HAT upscales, its v2 body in the fast Swin2SR upscale,
   K8 in the fast HAT upscale, K9-K11 in the Swin chain phase, K12 in the
   probe; every kernel of the table ran.

The last two lines of standard output are a JSON object describing each
kernel and the JSON result ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, the script exits
non-zero before printing a result.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
# them, HBM3
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12

# 1024^2 decode shapes (latent 128^2): (H, W, Cin, Cout, residual) of the
# ResNet conv2s, which carry every fused part (prologue, residual, stats)
K1_SHAPES = [(128, 128, 512, 512, "add"), (256, 256, 512, 512, "add"),
             (512, 512, 256, 256, "add"), (512, 512, 512, 256, "proj"),
             (1024, 1024, 256, 128, "proj"),
             (1024, 1024, 128, 128, "add")]
# (H, W, C) of the low-resolution input of each upsample conv
K2_SHAPES = [(128, 128, 512), (256, 256, 512), (512, 512, 256)]
N_TOKENS, C_ATTN = 128 * 128, 512
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
K4_SHAPE = (1, 1024, 1024, 128)
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
# K8 at HAT-M's 512^2-tile OCAB: (windows, heads, queries, keys)
K8_SHAPE = (1024, 6, 256, 576)
SWIN_BUDGET = 5e-2          # relative to max(1, max|ref|), K7 and K8
SWIN_CROP = 768             # the SwinIR / HAT upscale input: 4 tiles a pass
K4_BUDGET = 1e-5            # relative, on mean and std
FUSED_EPI_BUDGET = 1e-5     # image max-abs and summary relative

CONV_BUDGET = 5e-2          # the decoder chain's bf16 budget (y, max-abs)
STATS_BUDGET = 1e-3         # relative, on the emitted GroupNorm sums
ATTN_BUDGET = {"parity": 1e-5, "mixed": 1e-4}

# K5 at the 2048^2 decode's junction and at a ragged map: (H, W) of the
# low-resolution x [1, H, W, 256] -> y [1, 2H, 2W, 128], middle width 256
K5_SHAPES = [(1024, 1024), (36, 60)]
K5_CIN, K5_CM, K5_COUT = 256, 256, 128
# K2 stats_only at the same junction: x [1, 1024, 1024, 256]
K2_STATS_SHAPE = (1024, 1024, 256)
# the large-frame phase: staged vs whole-image mixed budgets (rgb and the
# conservative image max-abs, the pre-map statistics relative)
STAGED_RGB, STAGED_CONS, STAGED_PRE = 1e-4, 1e-3, 1e-4
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
    of their type and its bytes over the memory rate."""

    def __init__(self):
        self.ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, flops: float, nbytes_: float,
            peak: float = PEAK_BF16) -> dict:
        t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes_ / HBM_BYTES_S
        self.ms += max(t_ops, t_bytes)
        self.ops_ms += t_ops
        self.bytes_ms += t_bytes
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def entry(self) -> dict:
        return {"bound_ms": self.ms, "bound_by": "operations"
                if self.ops_ms >= self.bytes_ms else "bytes"}


CONV_ALONE = "F.conv2d, bf16, channels_last (the conv alone)"


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> float:
    """``F.scaled_dot_product_attention`` of the spatial attention's
    [1, h, w, C] q, k, v as one head of h w tokens."""
    q, k, v = (t.reshape(1, 1, -1, t.shape[-1]) for t in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=3)


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


def _bf16(rng, shape, scale=1.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).cuda().bfloat16()


def phase_kernels() -> list:
    from hdrvae_torch.kernels import attention, conv3x3
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    entries = []

    # K1 ---------------------------------------------------------------
    details, k_ms, p_ms, l_ms, err, bnd = [], 0.0, 0.0, 0.0, 0.0, Bound()
    for h, w, cin, cout, res in K1_SHAPES:
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
        log(f"K1 fused_conv3x3 {h}x{w} {cin}->{cout} {res}: max-abs {e:.3e} "
            f"stats {es:.2e}  kernel {t:.3f} ms ({flops / (t * 1e9):.1f} "
            f"TFLOP/s)  plain {tp:.3f} ms  conv alone {tl:.3f} ms  bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
        details.append({"shape": [h, w, cin, cout, res], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp,
                        "library_ms": tl, **b})
        k_ms, p_ms, l_ms, err = k_ms + t, p_ms + tp, l_ms + tl, max(err, e)
        del x, kern, y, ry
    entries.append({"name": "fused_conv3x3", "route": "cuda",
                    "source": "hdrvae_torch/csrc/conv3x3.cu",
                    "replaces": "hdrvae/kernels/conv3x3.py:333",
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    **bnd.entry(), "library_ms": l_ms,
                    "library_call": CONV_ALONE, "shapes": details})

    # K2 ---------------------------------------------------------------
    details, k_ms, p_ms, l_ms, err, bnd = [], 0.0, 0.0, 0.0, 0.0, Bound()
    for h, w, c in K2_SHAPES:
        x = _bf16(rng, (1, h, w, c), 0.5)
        kern = _bf16(rng, (3, 3, c, c), (9 * c) ** -0.5)
        bias = torch.from_numpy(rng.uniform(-0.1, 0.1, c)
                                .astype(np.float32)).to(dev)
        kw = dict(emit_stats=True, num_groups=32)
        y, s = conv3x3.upsample_conv3x3(x, kern, bias, **kw)
        ry, rs = conv3x3.upsample_conv3x3_reference(x, kern, bias, **kw)
        torch.cuda.synchronize()
        e = (y.float() - ry.float()).abs().max().item()
        es = stats_err(s, rs, ry)
        check(e <= CONV_BUDGET, f"K2 {h}x{w} {c}: max-abs {e}")
        check(es <= STATS_BUDGET, f"K2 {h}x{w} stats rel err {es}")
        t = cuda_ms(lambda: conv3x3.upsample_conv3x3(x, kern, bias, **kw))
        tp = cuda_ms(lambda: conv3x3.upsample_conv3x3_reference(
            x, kern, bias, **kw))
        # the conv alone, on the upsampled map made beforehand
        up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        tl = conv_alone_ms(up, kern)
        del up
        # the phase-decomposed conv: four 2x2 taps per output pixel
        flops = 2 * (4 * h * w) * 4 * c * c
        b = bnd.add(flops, nbytes(x, kern, bias, y, *s))
        log(f"K2 upsample_conv3x3 {h}x{w}->{2 * h}x{2 * w} {c}: max-abs "
            f"{e:.3e} stats {es:.2e}  kernel {t:.3f} ms  plain {tp:.3f} ms"
            f"  conv alone {tl:.3f} ms  bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']})")
        details.append({"shape": [h, w, c, c], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp,
                        "library_ms": tl, **b})
        k_ms, p_ms, l_ms, err = k_ms + t, p_ms + tp, l_ms + tl, max(err, e)
        del x, y, ry
    entries.append({"name": "upsample_conv3x3", "route": "cuda",
                    "source": "hdrvae_torch/csrc/conv3x3.cu",
                    "replaces": "hdrvae/kernels/conv3x3.py:653",
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    **bnd.entry(), "library_ms": l_ms,
                    "library_call": CONV_ALONE + " (on the upsampled map)",
                    "shapes": details})

    # K3 ---------------------------------------------------------------
    from hdrvae_torch.core.config import Precision
    hw = int(N_TOKENS ** 0.5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, hw, hw, C_ATTN)).astype(np.float32)).to(dev) for _ in range(3))
    ref = attention.spatial_attention_reference(q, k, v)
    f32_err = {}
    for tier in ("parity", "mixed"):
        got = attention.spatial_attention(q, k, v,
                                          precision=Precision(mode=tier))
        torch.cuda.synchronize()
        f32_err[tier] = (got - ref).abs().max().item()
        check(f32_err[tier] <= ATTN_BUDGET[tier],
              f"K3 {tier}: max-abs {f32_err[tier]} > {ATTN_BUDGET[tier]}")
    t = cuda_ms(lambda: attention.flash_attention_f32(q, k, v), iters=3)
    tp = cuda_ms(lambda: attention.spatial_attention_reference(q, k, v),
                 iters=3)
    tl = sdpa_ms(q, k, v)
    # q k^T and p v; exact float32 runs outside the tensor cores
    attn_flops = 4 * N_TOKENS * N_TOKENS * C_ATTN
    b = Bound().add(attn_flops, 4 * nbytes(q), PEAK_F32)
    log(f"K3 flash_attention_f32 N={N_TOKENS} C={C_ATTN}: parity max-abs "
        f"{f32_err['parity']:.3e} mixed {f32_err['mixed']:.3e}  kernel "
        f"{t:.3f} ms  plain {tp:.3f} ms  SDPA {tl:.3f} ms  bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    entries.append({"name": "flash_attention_f32", "route": "cuda",
                    "source": "hdrvae_torch/csrc/attention.cu",
                    "replaces": "hdrvae/kernels/attention.py:210",
                    "max_abs_err": max(f32_err.values()), "ms": t,
                    "plain_ms": tp, **b, "library_ms": tl,
                    "library_call": "F.scaled_dot_product_attention, float32",
                    "tiers": ["parity", "mixed"],
                    "max_abs_err_by_tier": f32_err})

    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attention.spatial_attention(qb, kb, vb, precision=Precision.fast())
    ref = attention.spatial_attention_reference(qb, kb, vb)
    torch.cuda.synchronize()
    e = (got - ref).abs().max().item()
    bound = bf16_ulp(ref)
    check(e <= bound, f"K3 fast: max-abs {e} > {bound}")
    t = cuda_ms(lambda: attention.flash_attention_bf16(qb, kb, vb), iters=3)
    tp = cuda_ms(lambda: attention.spatial_attention_reference(qb, kb, vb),
                 iters=3)
    tl = sdpa_ms(qb, kb, vb)
    b = Bound().add(attn_flops, 4 * nbytes(qb))
    log(f"K3 flash_attention_bf16 N={N_TOKENS} C={C_ATTN}: max-abs {e:.3e} "
        f"(budget {bound:.3e})  kernel {t:.3f} ms  plain {tp:.3f} ms  SDPA "
        f"{tl:.3f} ms  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
    entries.append({"name": "flash_attention_bf16", "route": "cuda",
                    "source": "hdrvae_torch/csrc/attention.cu",
                    "replaces": "hdrvae/kernels/attention.py:210",
                    "max_abs_err": e, "err_budget": bound, "ms": t,
                    "plain_ms": tp, **b, "library_ms": tl,
                    "library_call": "F.scaled_dot_product_attention, bf16",
                    "tiers": ["fast"]})
    del q, k, v, qb, kb, vb, ref, got
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
    entries.append(_check_k12())
    return entries, chain_ab


def _uniform(rng, lo, hi, shape) -> torch.Tensor:
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
        np.float32)).cuda()


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
    a ragged map whose output width is no multiple of the 16-pixel tile;
    y max-abs within CONV_BUDGET, the statistics within STATS_BUDGET."""
    from hdrvae_torch.kernels import conv3x3
    cin, cm, cout = K5_CIN, K5_CM, K5_COUT
    details, k_ms, p_ms, err, err_s, bnd = [], 0.0, 0.0, 0.0, 0.0, Bound()
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
        del ry
        t = cuda_ms(lambda: conv3x3.upconv_gn_conv3x3(*args, **kw))
        tp = cuda_ms(lambda: conv3x3.upconv_gn_conv3x3_reference(
            *args, **kw), iters=2, warmup=1)
        # the phase-decomposed up-conv (16 taps over the low-resolution
        # map) and conv1 (9 taps at the doubled resolution)
        flops = 2 * h * w * 16 * cin * cm + 2 * (4 * h * w) * 9 * cm * cout
        b = bnd.add(flops, nbytes(*args, y, *s))
        log(f"K5 upconv_gn_conv3x3 {h}x{w}->{2 * h}x{2 * w} {cin}->{cm}->"
            f"{cout}: max-abs {e:.3e} stats {es:.2e}  kernel {t:.3f} ms "
            f"({flops / (t * 1e9):.1f} TFLOP/s)  plain {tp:.3f} ms  bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
        details.append({"shape": [h, w, cin, cm, cout], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp,
                        "tflops": flops / (t * 1e9), **b})
        k_ms, p_ms = k_ms + t, p_ms + tp
        err, err_s = max(err, e), max(err_s, es)
        del x, args, y, s
        torch.cuda.empty_cache()
    return {"name": "upconv_gn_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/upconv.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:1059",
            "max_abs_err": err, "stats_rel_err": err_s, "ms": k_ms,
            "plain_ms": p_ms, **bnd.entry(), "library_ms": None,
            "library_call": "none: no one PyTorch call computes the up-conv, "
                            "the GroupNorm affine + SiLU and the next conv",
            "shapes": details}


def _check_k4() -> dict:
    from hdrvae_torch.kernels import epilogue
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(K4_SHAPE, generator=g, device="cuda") * 2.0
    details, k_ms, p_ms, err, rel_err = [], 0.0, 0.0, 0.0, 0.0
    bnd = Bound()
    for dtype in (torch.float32, torch.bfloat16):
        pre = torch.nn.functional.silu(x).to(dtype)   # a post-SiLU map
        col, st = epilogue.collapse_and_stats_fused(pre)
        rcol, rst = epilogue.collapse_and_stats_reference(pre)
        torch.cuda.synchronize()
        check(torch.equal(col, rcol), f"K4 {dtype}: collapse not bit-exact")
        e_abs = max((col.float() - rcol.float()).abs().max().item(),
                    *(abs(st[k].item() - rst[k].item()) for k in st))
        for key in ("min", "max"):
            check(st[key].item() == rst[key].item(),
                  f"K4 {dtype}: {key} {st[key].item()} != "
                  f"{rst[key].item()}")
        rel = {key: abs(st[key].item() - rst[key].item())
               / abs(rst[key].item()) for key in ("mean", "std")}
        for key, e in rel.items():
            check(e <= K4_BUDGET, f"K4 {dtype}: {key} rel err {e}")
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
        del pre, col, rcol
    del x
    torch.cuda.empty_cache()
    # max_abs_err: over the collapsed map and the four statistics
    return {"name": "collapse_and_stats_fused", "route": "cuda",
            "source": "hdrvae_torch/csrc/epilogue.cu",
            "replaces": "hdrvae/kernels/epilogue.py:93", "max_abs_err": err,
            "stats_rel_err": rel_err, "ms": k_ms, "plain_ms": p_ms,
            **bnd.entry(), "library_ms": None,
            "library_call": "none: no one PyTorch call computes the collapse "
                            "and its statistics",
            "shapes": details}


def _check_k6(rng) -> dict:
    from hdrvae_torch.kernels import dense_conv
    dev = torch.device("cuda")
    details, k_ms, p_ms, l_ms, err, bnd = [], 0.0, 0.0, 0.0, 0.0, Bound()
    for name, h, w, cins, cout, act, rs, f32 in K6_SHAPES:
        xs = [_bf16(rng, (1, h, w, c), 0.5) for c in cins]
        kern = _bf16(rng, (3, 3, sum(cins), cout), (9 * sum(cins)) ** -0.5)
        bias = torch.from_numpy(rng.uniform(-0.1, 0.1, cout)
                                .astype(np.float32)).to(dev)
        kw = dict(act=act, out_dtype=torch.float32 if f32 else None)
        if rs is not None:
            kw.update(residual=_bf16(rng, (1, h, w, cout), 0.5),
                      res_scale=rs)
        y = dense_conv.dense_conv3x3(xs, kern, bias, **kw)
        ry = dense_conv.dense_conv3x3_reference(xs, kern, bias, **kw)
        torch.cuda.synchronize()
        check(y.dtype == ry.dtype and y.shape == ry.shape,
              f"K6 {name}: {y.dtype} {tuple(y.shape)}")
        check(torch.isfinite(y.float()).all().item(),
              f"K6 {name}: output not finite")
        e = (y.float() - ry.float()).abs().max().item()
        check(e <= CONV_BUDGET, f"K6 {name} {h}x{w}: max-abs {e} > "
              f"{CONV_BUDGET}")
        t = cuda_ms(lambda: dense_conv.dense_conv3x3(xs, kern, bias, **kw))
        tp = cuda_ms(lambda: dense_conv.dense_conv3x3_reference(
            xs, kern, bias, **kw))
        # the conv alone, on the concatenated input made beforehand
        cat = torch.cat(xs, dim=-1)
        tl = conv_alone_ms(cat, kern)
        del cat
        flops = 2 * h * w * 9 * sum(cins) * cout
        tflops = flops / (t * 1e9)
        b = bnd.add(flops, nbytes(*xs, kern, bias, y, kw.get("residual")))
        log(f"K6 dense_conv3x3 {name} {h}x{w} {'+'.join(map(str, cins))}->"
            f"{cout}: max-abs {e:.3e}  kernel {t:.3f} ms ({tflops:.1f} "
            f"TFLOP/s)  plain {tp:.3f} ms  conv alone {tl:.3f} ms  bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
        details.append({"shape": [name, h, w, list(cins), cout],
                        "max_abs_err": e, "ms": t, "plain_ms": tp,
                        "tflops": tflops, "library_ms": tl, **b})
        k_ms, p_ms, l_ms, err = k_ms + t, p_ms + tp, l_ms + tl, max(err, e)
        del xs, kern, y, ry, kw
        torch.cuda.empty_cache()
    return {"name": "dense_conv3x3", "route": "cuda",
            "source": "hdrvae_torch/csrc/dense_conv.cu",
            "replaces": "hdrvae/kernels/conv3x3.py:1306",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            **bnd.entry(), "library_ms": l_ms,
            "library_call": CONV_ALONE + " (on the concatenated inputs)",
            "shapes": details}


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
        bound = SWIN_BUDGET * max(1.0, ry.float().abs().max().item())
        check(e <= bound, f"{name_k} {name}: max-abs {e} > {bound}")
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
            f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
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


def _check_k8(rng) -> dict:
    """K8 against its plain version at HAT-M's 512^2-tile OCAB shape: 1024
    windows, 6 heads, 256 queries against 576 keys, head dim 30 padded to
    32 with zeros."""
    from hdrvae_torch.kernels import ocab
    nwb, heads, nq, nk = K8_SHAPE

    def qkv(n, scale):
        t = _bf16(rng, (nwb, heads, n, 32), scale)
        t[..., 30:] = 0
        return t
    q, k, v = qkv(nq, 30 ** -0.5), qkv(nk, 1.0), qkv(nk, 1.0)
    bias = torch.from_numpy(rng.standard_normal((heads, nq, nk))
                            .astype(np.float32)).cuda()
    kw = dict(compute_dtype=torch.bfloat16, storage_dtype=torch.bfloat16)
    o = ocab.ocab_attention(q, k, v, bias, **kw)
    ro = ocab.ocab_attention_reference(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    check(o.dtype == ro.dtype and o.shape == ro.shape,
          f"K8: {o.dtype} {tuple(o.shape)}")
    e = (o.float() - ro.float()).abs().max().item()
    bound = SWIN_BUDGET * max(1.0, ro.float().abs().max().item())
    check(e <= bound, f"K8: max-abs {e} > {bound}")
    t = cuda_ms(lambda: ocab.ocab_attention(q, k, v, bias, **kw))
    tp = cuda_ms(lambda: ocab.ocab_attention_reference(q, k, v, bias, **kw),
                 iters=2, warmup=1)
    # the bias as SDPA's additive mask, in the queries' dtype (q carries
    # the softmax scale already)
    mask = bias.to(q.dtype)
    tl = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0))
    del mask
    flops = 4 * nwb * heads * nq * nk * 32
    b = Bound().add(flops, nbytes(q, k, v, bias, o))
    log(f"K8 ocab_attention {list(K8_SHAPE)}: max-abs {e:.3e} (budget "
        f"{bound:.3e})  kernel {t:.3f} ms ({flops / (t * 1e9):.1f} TFLOP/s)"
        f"  plain {tp:.3f} ms  SDPA {tl:.3f} ms  bound {b['bound_ms']:.3f} "
        f"ms ({b['bound_by']})")
    del q, k, v, bias, o, ro
    torch.cuda.empty_cache()
    return {"name": "ocab_attention", "route": "cuda",
            "source": "hdrvae_torch/csrc/ocab.cu",
            "replaces": "hdrvae/kernels/ocab.py:95", "max_abs_err": e,
            "err_budget": bound, "ms": t, "plain_ms": tp, **b,
            "library_ms": tl,
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


def _check_chain(rng) -> tuple:
    """The staged Swin chain at K7's v1 shapes: K10, K9 and K11 each against
    its plain version on the same input, each kernel's input the previous
    kernel's output, with the max-abs over the last window row and column
    apart; then the chain against K7 on the same inputs and weights, with
    both times.  Returns the three kernels' entries and the A/B records."""
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import swin_attention as ska
    from hdrvae_torch.models.swinir import block_weights
    fast = Precision.fast()
    keys = ("swin_ln_qkv", "swin_attn_core", "swin_proj_mlp")
    acc = {k: {"details": [], "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "err": 0.0, "edge": 0.0, "bound": Bound()} for k in keys}
    ab = []
    c = SWIN_DIM
    for name, h, w, ws, shift, extra in K7_SHAPES:
        blk = _swin_block(rng, c, SWIN_HEADS, ws)
        wts = block_weights(blk, SWIN_HEADS, ws, torch.bfloat16)
        x = _bf16(rng, (1, h, w, c))
        e_in = _bf16(rng, (1, h, w, c), 0.5) if extra else None
        grid, n, tokens = (h // ws, w // ws), ws * ws, h * w
        kc = dict(heads=SWIN_HEADS, ws=ws, shift=shift, grid=grid)
        qkv = ska.ln_qkv(x, wts, ws=ws, precision=fast)
        o = ska.window_attention_core(qkv, wts.bias, **kc)
        y = ska.proj_mlp(o, x, wts, ws=ws, extra=e_in, precision=fast)
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
        work = {   # (operations, bytes): each input read once, output once
            "swin_ln_qkv": (2 * tokens * c * 3 * c, nbytes(
                x, qkv, wts.wq, wts.bq, wts.g1, wts.be1)),
            "swin_attn_core": (4 * tokens * n * c, nbytes(qkv, wts.bias, o)),
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
            tl = None
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
            log(f"{key} {name} {h}x{w} ws {ws} shift {shift}"
                f"{' +extra' if extra else ''}: max-abs {e:.3e} (last window "
                f"row/col {e_last:.3e}, budget {bound:.3e})  kernel {t:.3f} "
                f"ms  plain {tp:.3f} ms"
                + (f"  SDPA {tl:.3f} ms" if tl is not None else "")
                + f"  bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
            acc[key]["details"].append({
                "shape": [name, h, w, c, ws, shift, bool(extra)],
                "max_abs_err": e, "max_abs_err_last_row_col": e_last,
                "err_budget": bound, "ms": t, "plain_ms": tp,
                "library_ms": tl, **b})
            a = acc[key]
            a["ms"] += t
            a["plain_ms"] += tp
            a["library_ms"] += tl or 0.0
            a["err"], a["edge"] = max(a["err"], e), max(a["edge"], e_last)
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
        del x, e_in, qkv, o, y, yc, y7, wts, blk
        torch.cuda.empty_cache()
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
            "max_abs_err": a["err"], "max_abs_err_last_row_col": a["edge"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], **a["bound"].entry(),
            "library_ms": a["library_ms"] if core else None,
            "library_call": "F.scaled_dot_product_attention, bf16, the bias "
                            "and masks as a bf16 attn_mask" if core else
                            "none: no one PyTorch call computes it",
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


def _check_k12() -> dict:
    """K12 at the probe's shape in its three precisions, each against its
    plain version on the probe's operands within K12_BUDGET * max|ref|.
    Its times come from the probe's run (``phase_f32_probe``)."""
    from hdrvae_torch.kernels import f32_dot
    m, k, n = K12_SHAPE
    x, w = _probe().operands(m, k, n)
    details, err, bnd = [], 0.0, Bound()
    for mode in f32_dot.PRECISIONS:
        y = f32_dot.f32_dot(x, w, precision=mode)
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
    return {"name": "f32_dot", "route": "cuda",
            "source": "hdrvae_torch/csrc/f32_dot.cu",
            "replaces": "tools/perf/pallas_f32_dot_probe.py:45",
            "max_abs_err": err, **bnd.entry(),
            "library_call": "torch.matmul, float32, TF32 off, once a "
                            "precision", "shapes": details}


def _wrappers() -> dict:
    """The kernel wrappers, by name; each counts its own launches."""
    from hdrvae_torch.kernels import (attention, conv3x3, dense_conv,
                                      epilogue, f32_dot, ocab,
                                      swin_attention)
    return {fn.__name__: fn for fn in (
        conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
        conv3x3.upconv_gn_conv3x3,
        attention.flash_attention_bf16, attention.flash_attention_f32,
        epilogue.collapse_and_stats_fused, dense_conv.dense_conv3x3,
        swin_attention.swin_block_fused, ocab.ocab_attention,
        swin_attention.ln_qkv, swin_attention.window_attention_core,
        swin_attention.proj_mlp, f32_dot.f32_dot)}


def _counts() -> dict:
    """Every counter; K2's stats_only launches under their own name."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["upsample_conv3x3_stats_only"] = \
        _wrappers()["upsample_conv3x3"].stats_only_launches
    return counts


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["upsample_conv3x3"].stats_only_launches = 0


def phase_decode():
    from hdrvae_torch.core.config import (DecoderConfig, HDRDecodeConfig,
                                          Precision)
    from hdrvae_torch.decode.pipeline import (decode_summary, hdr_decode,
                                              hdr_epilogue)
    from hdrvae_torch.models.decoder import (decoder_apply, decoder_head,
                                             decoder_tail)
    from hdrvae_torch.models.params import init_decoder

    cfg = DecoderConfig()
    t0 = time.perf_counter()
    dec = init_decoder(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in dec.parameters())
    log(f"decoder: {n_params} parameters, weights from numpy seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
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

    # fast tier: the fused chain vs the port's unfused fast path (the
    # layers' own ops), the way the JAX chain was held to its XLA layers
    fast = tiers["fast"]
    x = decoder_head(dec, z, precision=fast)
    unfused = decoder_tail(dec, x, precision=fast)
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
    del x, unfused

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


def _decode_request(dec, z, hcfg, prec):
    """One hdr_decode with its summary fetched: (result, summary, device
    ms, host wall ms, peak GiB of allocated memory)."""
    from hdrvae_torch.decode.pipeline import decode_summary, hdr_decode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    res = hdr_decode(dec, z, hcfg, prec)
    end.record()
    summary = decode_summary(res)
    torch.cuda.synchronize()
    return (res, summary, start.elapsed_time(end),
            1e3 * (time.perf_counter() - h0),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _latent(side: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, side, side, 16)).astype(np.float32)).cuda()


def phase_large_frames(dec):
    """The large-frame routes of hdr_decode on the full-width decoder:
    the fast tier's streamed top level (K2 stats_only + K5) and the mixed
    tier's staged executor, each held to the whole-image decode, with
    their times and peaks.  Returns (the low-memory 2048^2 request's
    launch counts, the records)."""
    from hdrvae_torch.core.config import HDRDecodeConfig, Precision
    from hdrvae_torch.decode import pipeline, staged
    from hdrvae_torch.models import fused_tail
    from hdrvae_torch.models.decoder import decoder_head, decoder_tail
    cons = HDRDecodeConfig(hdr_mode="conservative")
    fast, mixed = Precision.fast(), Precision.mixed()
    records = {}
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
                unfused = decoder_tail(dec, decoder_head(dec, z,
                                                         precision=fast),
                                       precision=fast).rgb.cpu()
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
        whole = host(run("mixed 2048^2 whole-image", z, mixed)[0])
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
    try:
        run(f"mixed {8 * side}^2 auto-routed", _latent(side), mixed)
    finally:
        staged.staged_hdr_decode = real
    check(calls == [1], f"a mixed {8 * side}^2 decode was not routed to the "
          "staged executor")
    torch.cuda.empty_cache()
    return main_counts, records


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
    a float64 product held to its class; its times fill K12's entry.
    Returns the probe's launch counts and rows."""
    _reset_counts()
    rows = _probe().measure(*K12_SHAPE)
    counts = _counts()
    lib = rows["library"]["matmul_f32"]["ms"]
    for d in entry["shapes"]:
        r = rows["modes"][d["precision"]]
        check(r["rel_vs_exact"] <= K12_CLASSES[d["precision"]],
              f"K12 {d['precision']}: error {r['rel_vs_exact']} of "
              f"max|exact| > {K12_CLASSES[d['precision']]}")
        d.update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=lib,
                 rel_vs_exact=r["rel_vs_exact"],
                 max_abs_vs_exact=r["max_abs_vs_exact"])
        log(f"K12 f32_dot {d['precision']}: kernel {r['ms'] * 1e3:.2f} us "
            f"(bound {d['bound_ms'] * 1e3:.2f} us)  plain "
            f"{r['plain_ms'] * 1e3:.2f} us  vs float64 {r['rel_vs_exact']:.3e}"
            f" of max|exact| (<= {K12_CLASSES[d['precision']]})")
    for key in ("ms", "plain_ms", "library_ms"):
        entry[key] = sum(d[key] for d in entry["shapes"])
    log("f32 dot probe library rows: " + ", ".join(
        f"{k} {r['ms'] * 1e3:.2f} us ({r['rel_vs_exact']:.3e})"
        for k, r in rows["library"].items()))
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

    phase_device()
    phase_build()
    entries, chain_ab = phase_kernels()
    image, counts, per_tier, times, epi_counts, dec = phase_decode()
    t_lf = time.perf_counter()
    lf_counts, lf_records = phase_large_frames(dec)
    del dec
    log(f"large-frame phase {time.perf_counter() - t_lf:.1f} s")
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
    t_ch = time.perf_counter()
    chain_counts, chain_record = phase_swin_chain(image)
    log(f"swin chain phase {time.perf_counter() - t_ch:.1f} s")
    by_name = {e["name"]: e for e in entries}
    probe_counts, probe_rows = phase_f32_probe(by_name["f32_dot"])

    log(f"launches in the decode phase: {counts}")
    for name in ("fused_conv3x3", "upsample_conv3x3",
                 "flash_attention_bf16"):
        check(per_tier["fast"][name] > 0, f"fast decode never ran {name}")
    for tier in ("parity", "mixed"):
        check(per_tier[tier]["flash_attention_f32"] > 0,
              f"{tier} decode never ran flash_attention_f32")
    check(epi_counts["collapse_and_stats_fused"] > 0,
          "fused-epilogue decodes never ran collapse_and_stats_fused")
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
    for entry in entries:
        entry["launches"] = main_path[entry["name"]]
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on its main path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries,
                      "decode_ms": {k: v[-1][0] for k, v in times.items()},
                      "upscale_ms": {k: v[-1][0] if k in ("fast", "parity")
                                     else {t: r[0] for t, r in v.items()}
                                     for k, v in up_times.items()},
                      "large_frames": lf_records,
                      "swin_chain_vs_k7": chain_ab,
                      "swin_chain": chain_record,
                      "f32_dot_probe": probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
