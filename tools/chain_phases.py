#!/usr/bin/env python3
"""Where K10 (``ln_qkv``) and K11 (``proj_mlp``) spend their time, on one
NVIDIA GPU.

    python3 tools/chain_phases.py

copies ``hdrvae_torch/csrc/swin_chain.cu`` with ``clock64()`` stamps at
the phase boundaries of both kernels (the lead thread of every warpgroup
adds the SM clocks since its last stamp into a ``__device__`` array), builds
that copy alone into a library of its own, runs K10 and K11 at
``chip_smoke.py``'s SwinIR-M and HAT-M 512^2 shapes (K11 on K9's output
of K10's qkv; five launches each after one warm-up) and prints the wrapper
time (CUDA events) and each phase's SM clocks per warpgroup item (a 64-row
block):

- K10: LN1 (the rows' statistics and their store, from registers loaded
  one item ahead), the heads (products, epilogues, stores), the item's
  top;
- K11: the item's top with its x loads and the o wait, proj, x2 + LN2
  (with extra's loads), the MLP, of it GELU (from fc1's wait to the wait
  for fc2's tile, with two tiles' releases) and fc1's issue, and the
  epilogue;
- both: the time spent waiting for weight tiles.

The stamps cost time of their own (atomics a phase), so the phases add
up to more than the uninstrumented kernel; compare phases with each
other, and times with ``tools/mutate_kernels.py --time-k11``.  The
checkout is never changed.  It prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (text of swin_chain.cu, its stamped form): each text must appear once
STAMPS = [
    ("namespace {\n\nusing namespace winattn;",
     "__device__ unsigned long long phase_clk[32];\n"
     'extern "C" int hdrvae_phase_read(void* dst) {\n'
     "  return cudaMemcpyFromSymbol(dst, phase_clk, sizeof(phase_clk));\n"
     "}\n"
     'extern "C" int hdrvae_phase_zero() {\n'
     "  unsigned long long z[32] = {};\n"
     "  return cudaMemcpyToSymbol(phase_clk, z, sizeof(z));\n"
     "}\n"
     "#define STAMP(i) if (lead) { const long long now_ = clock64(); "
     "atomicAdd(&phase_clk[i], (unsigned long long)(now_ - last_)); "
     "last_ = now_; }\n"
     "namespace {\n\nusing namespace winattn;"),
    ("  __device__ __forceinline__ void wait(int j) const {\n"
     "    hopper::mbar_wait(full(j), (static_cast<unsigned>(j) / NS) & 1);\n"
     "  }",
     "  __device__ __forceinline__ void wait(int j) const {\n"
     "    const long long s_ = clock64();\n"
     "    hopper::mbar_wait(full(j), (static_cast<unsigned>(j) / NS) & 1);\n"
     "    if ((threadIdx.x & 127) == 0)\n"
     "      atomicAdd(&phase_clk[8], (unsigned long long)(clock64() - s_));\n"
     "  }"),
    # K10
    ("    wg_sync();   // the last item's products have read region A\n",
     "    STAMP(3)\n"
     "    wg_sync();   // the last item's products have read region A\n"),
    ("    if (item + gridDim.x < a.items) load_x(item + gridDim.x);\n"
     "    hopper::fence_proxy_async();   // the rows, before wgmma reads them\n"
     "    wg_sync();\n",
     "    if (item + gridDim.x < a.items) load_x(item + gridDim.x);\n"
     "    hopper::fence_proxy_async();   // the rows, before wgmma reads them\n"
     "    wg_sync();\n"
     "    STAMP(1)\n"),
    ("    epi(a.nhead - 1, f[1]);\n",
     "    epi(a.nhead - 1, f[1]);\n"
     "    STAMP(2)\n"
     "    if (lead) atomicAdd(&phase_clk[15], 1ull);\n"),
    # K11
    ("    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);\n\n"
     "    // this thread's two rows of x",
     "    const int win = rb / a.nrb, tok0 = 64 * (rb % a.nrb);\n"
     "    STAMP(4)\n\n"
     "    // this thread's two rows of x"),
    ("    hopper::mbar_wait(obar, k & 1);\n",
     "    hopper::mbar_wait(obar, k & 1);\n    STAMP(5)\n"),
    ("    ring.release(j0 + H - 1, refill);\n",
     "    ring.release(j0 + H - 1, refill);\n    STAMP(6)\n"),
    ("    hopper::fence_proxy_async();   // the rows, before wgmma reads them\n"
     "    wg_sync();\n\n    // the MLP",
     "    hopper::fence_proxy_async();   // the rows, before wgmma reads them\n"
     "    wg_sync();\n    STAMP(7)\n\n    // the MLP"),
    ("    ring.release(jm + fc2_tile(c + 1, a.nchunk), refill);\n",
     "    ring.release(jm + fc2_tile(c + 1, a.nchunk), refill);\n"
     "    STAMP(10)\n"
     "    if (lead) atomicAdd(&phase_clk[14], 1ull);\n"),
    ("    auto fc2 = [&](int c, float (&h)[CW / 2], uint32_t (&u)[CW / 4]) {\n",
     "    auto fc2 = [&](int c, float (&h)[CW / 2], uint32_t (&u)[CW / 4]) {\n"
     "      const long long g0_ = clock64();\n"),
    ("      const int j2 = jm + fc2_tile(c, a.nchunk);\n",
     "      if (lead)\n"
     "        atomicAdd(&phase_clk[12], (unsigned long long)(clock64() - g0_));\n"
     "      const int j2 = jm + fc2_tile(c, a.nchunk);\n"),
    ("    auto fc1 = [&](int c, float (&h)[CW / 2]) {\n",
     "    auto fc1 = [&](int c, float (&h)[CW / 2]) {\n"
     "      const long long f0_ = clock64();\n"),
    ("        hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);\n"
     "      hopper::wgmma_commit();\n",
     "        hopper::wgmma_ss<CW, 1>(h, dA + a_step(ks), db + ks * 64);\n"
     "      hopper::wgmma_commit();\n"
     "      if (lead)\n"
     "        atomicAdd(&phase_clk[13], (unsigned long long)(clock64() - f0_));\n"),
]
# both kernels: the stamp's clock after their lead flag
LEAD = ("  const bool lead = (tid & 127) == 0;\n",
        "  const bool lead = (tid & 127) == 0;\n  long long last_ = clock64();\n")

PHASES = {
    "K10": {1: "LN1", 2: "heads", 3: "item top", 8: "weight waits"},
    "K11": {4: "epilogue (and the item's end)", 5: "x loads + o wait",
            6: "proj", 7: "x2 + LN2", 10: "MLP",
            12: "  of it GELU (and two releases)", 13: "  of it fc1 issue",
            8: "weight waits"},
}


def stamped_source() -> str:
    src = open(os.path.join(REPO, "hdrvae_torch", "csrc",
                            "swin_chain.cu")).read()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"swin_chain.cu does not hold once: {old!r}")
        src = src.replace(old, new)
    if src.count(LEAD[0]) != 2:
        raise SystemExit("swin_chain.cu: expected two lead flags")
    return src.replace(*LEAD)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from hdrvae_torch.core.config import Precision
    from hdrvae_torch.kernels import _build
    from hdrvae_torch.kernels import swin_attention as ska
    from hdrvae_torch.models.swinir import block_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(REPO, "hdrvae_torch", "csrc")
        for name in ("hopper.cuh", "window_attention.cuh"):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(open(os.path.join(csrc, name)).read())
        with open(os.path.join(tmp, "swin_chain.cu"), "w") as f:
            f.write(stamped_source())
        t0 = time.perf_counter()
        lib_path = os.path.join(tmp, "libchain_phases.so")
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             lib_path, os.path.join(tmp, "swin_chain.cu")],
            capture_output=True, text=True)
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.hdrvae_phase_read.argtypes = [ctypes.c_void_p]
    _build.library = lambda: lib

    fast = Precision.fast()
    rng = np.random.default_rng(0)
    buf = (ctypes.c_ulonglong * 32)()
    for name, h, w, ws, shift, extra in (cs.K7_SHAPES[0], cs.K7_SHAPES[2]):
        blk = cs._swin_block(rng, cs.SWIN_DIM, cs.SWIN_HEADS, ws)
        wts = block_weights(blk, cs.SWIN_HEADS, ws, torch.bfloat16)
        x = cs._bf16(rng, (1, h, w, cs.SWIN_DIM))
        e = cs._bf16(rng, (1, h, w, cs.SWIN_DIM), 0.5) if extra else None
        kw = dict(heads=cs.SWIN_HEADS, ws=ws, shift=shift,
                  grid=(h // ws, w // ws))
        qkv = ska.ln_qkv(x, wts, ws=ws, precision=fast)
        o = ska.window_attention_core(qkv, wts.bias, **kw)
        runs = {"K10": lambda: ska.ln_qkv(x, wts, ws=ws, precision=fast),
                "K11": lambda: ska.proj_mlp(o, x, wts, ws=ws, extra=e,
                                            precision=fast)}
        for kernel, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            lib.hdrvae_phase_zero()
            t = cs.cuda_ms(fn, iters=5, warmup=0)
            lib.hdrvae_phase_read(buf)
            clk = list(buf)
            items = max(clk[15] if kernel == "K10" else clk[14], 1)
            print(f"{kernel} {name} {h}x{w} ws {ws} shift {shift}: "
                  f"{t:.3f} ms (stamped), {items} warpgroup items",
                  flush=True)
            for i, label in PHASES[kernel].items():
                print(f"   {label}: {clk[i] / items:.0f} SM clocks an item",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
