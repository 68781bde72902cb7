#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

No other set-up: the CUDA kernels are built from ``hdrvae_torch/csrc`` by
``nvcc`` on first use.  Phases, each of which raises on failure:

1. device: the card's name and power limit, as the line nvidia-smi prints;
2. build: compile the kernels, print the build time and ptxas' register
   and spill report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of a 1024^2 decode, with its tolerance, and both timed with
   CUDA events after a warm-up;
4. decode: the full-width Flux.1 decoder (random weights from a numpy
   seed) on a [1, 128, 128, 16] latent through ``hdr_decode`` +
   ``decode_summary`` in the fast, parity and mixed tiers, three requests
   each (the first warms cuDNN up); fast is held against the unfused fast
   path, mixed against parity; then the epilogue in all four modes on one
   decoder output;
5. EXR: the parity image written as a 32-bit EXR and read back bit-exact;
6. launch counts: K1, K2 and K3 ran in the fast decode, K3 in parity and
   mixed.

The last two lines of standard output are a JSON object describing each
kernel and the JSON result ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository beside it, the script exits
non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# 1024^2 decode shapes (latent 128^2): (H, W, Cin, Cout, residual) of the
# ResNet conv2s, which carry every fused part (prologue, residual, stats)
K1_SHAPES = [(128, 128, 512, 512, "add"), (256, 256, 512, 512, "add"),
             (512, 512, 256, 256, "add"), (512, 512, 512, 256, "proj"),
             (1024, 1024, 256, 128, "proj"),
             (1024, 1024, 128, 128, "add")]
# (H, W, C) of the low-resolution input of each upsample conv
K2_SHAPES = [(128, 128, 512), (256, 256, 512), (512, 512, 256)]
N_TOKENS, C_ATTN = 128 * 128, 512

CONV_BUDGET = 5e-2          # the decoder chain's bf16 budget (y, max-abs)
STATS_BUDGET = 1e-3         # relative, on the emitted GroupNorm sums
ATTN_BUDGET = {"parity": 1e-5, "mixed": 1e-4}


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


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
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
    details, k_ms, p_ms, err = [], 0.0, 0.0, 0.0
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
        tflops = 2 * h * w * 9 * cin * cout / (t * 1e9)
        log(f"K1 fused_conv3x3 {h}x{w} {cin}->{cout} {res}: max-abs {e:.3e} "
            f"stats {es:.2e}  kernel {t:.3f} ms ({tflops:.1f} TFLOP/s)  "
            f"plain {tp:.3f} ms")
        details.append({"shape": [h, w, cin, cout, res], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp})
        k_ms, p_ms, err = k_ms + t, p_ms + tp, max(err, e)
        del x, kern, y, ry
    entries.append({"name": "fused_conv3x3", "route": "cuda",
                    "source": "hdrvae_torch/csrc/conv3x3.cu",
                    "replaces": "hdrvae/kernels/conv3x3.py:333",
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "shapes": details})

    # K2 ---------------------------------------------------------------
    details, k_ms, p_ms, err = [], 0.0, 0.0, 0.0
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
        log(f"K2 upsample_conv3x3 {h}x{w}->{2 * h}x{2 * w} {c}: max-abs "
            f"{e:.3e} stats {es:.2e}  kernel {t:.3f} ms  plain {tp:.3f} ms")
        details.append({"shape": [h, w, c, c], "max_abs_err": e,
                        "stats_rel_err": es, "ms": t, "plain_ms": tp})
        k_ms, p_ms, err = k_ms + t, p_ms + tp, max(err, e)
        del x, y, ry
    entries.append({"name": "upsample_conv3x3", "route": "cuda",
                    "source": "hdrvae_torch/csrc/conv3x3.cu",
                    "replaces": "hdrvae/kernels/conv3x3.py:653",
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
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
    log(f"K3 flash_attention_f32 N={N_TOKENS} C={C_ATTN}: parity max-abs "
        f"{f32_err['parity']:.3e} mixed {f32_err['mixed']:.3e}  kernel "
        f"{t:.3f} ms  plain {tp:.3f} ms")
    entries.append({"name": "flash_attention_f32", "route": "cuda",
                    "source": "hdrvae_torch/csrc/attention.cu",
                    "replaces": "hdrvae/kernels/attention.py:210",
                    "max_abs_err": max(f32_err.values()), "ms": t,
                    "plain_ms": tp, "tiers": ["parity", "mixed"],
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
    log(f"K3 flash_attention_bf16 N={N_TOKENS} C={C_ATTN}: max-abs {e:.3e} "
        f"(bound {bound:.3e})  kernel {t:.3f} ms  plain {tp:.3f} ms")
    entries.append({"name": "flash_attention_bf16", "route": "cuda",
                    "source": "hdrvae_torch/csrc/attention.cu",
                    "replaces": "hdrvae/kernels/attention.py:210",
                    "max_abs_err": e, "bound": bound, "ms": t,
                    "plain_ms": tp, "tiers": ["fast"]})
    del q, k, v, qb, kb, vb, ref, got
    torch.cuda.empty_cache()
    return entries


def _wrappers() -> dict:
    """The kernel wrappers, by name; each counts its own launches."""
    from hdrvae_torch.kernels import attention, conv3x3
    return {fn.__name__: fn for fn in (
        conv3x3.fused_conv3x3, conv3x3.upsample_conv3x3,
        attention.flash_attention_bf16, attention.flash_attention_f32)}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


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
    results, per_tier, times = {}, {}, {}
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
    return results["parity"].image, decode_counts, per_tier, times


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
    entries = phase_kernels()
    image, counts, per_tier, times = phase_decode()
    phase_exr(image)

    log(f"launches in the decode phase: {counts}")
    for name in ("fused_conv3x3", "upsample_conv3x3",
                 "flash_attention_bf16"):
        check(per_tier["fast"][name] > 0, f"fast decode never ran {name}")
    for tier in ("parity", "mixed"):
        check(per_tier[tier]["flash_attention_f32"] > 0,
              f"{tier} decode never ran flash_attention_f32")
    for entry in entries:
        entry["launches"] = counts[entry["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries,
                      "decode_ms": {k: v[-1][0] for k, v in times.items()}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
