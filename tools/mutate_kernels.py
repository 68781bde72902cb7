#!/usr/bin/env python3
"""Mutation check of a kernel's test in ``chip_smoke.py``, on one NVIDIA
GPU.

    python3 tools/mutate_kernels.py [k5|chain ...]   (default: both)

For each mutation of a target below it copies ``hdrvae_torch/`` and
``chip_smoke.py`` into a temporary directory, breaks one CUDA source
there, builds that copy's kernels and runs the
target's check of ``chip_smoke`` (k5: ``_check_k5``, K5 against its plain
version at the 2048^2 decode's junction and a ragged map; chain:
``_check_chain``, K10, K9 and K11 of the staged Swin chain at K7's v1
shapes and the chain against K7), then reports whether the check refused
the broken kernel.  The checkout itself is never changed.  Exits non-zero
if a mutant the check must catch survives; one marked ``sub-ulp`` moves
each value by less than one bf16 ulp, below what the 5e-2 budgets can see,
and is reported only.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# target: (chip_smoke call, log prefixes, mutations); each mutation name:
# (CUDA source under csrc/, text of it, its broken form, must the check
# catch it)
TARGETS = {
    "k5": ("_check_k5(np.random.default_rng(5))", ("K5",), {
        "band not zeroed outside the image": (
            "upconv.cu", "o[e] = in ? silu(zn) : 0.0f;", "o[e] = silu(zn);",
            True),
        "up_bias dropped": (
            "upconv.cu", "acc_a[mt][t][2 * hf + e] +\n"
            "                                           up_bias[n + e]",
            "acc_a[mt][t][2 * hf + e]", True),
        "last conv1 weight piece skipped": (
            "upconv.cu", "      const int j = i - na;\n",
            "      const int j = i - na;\n      if (j == npb - 1) continue;\n",
            True),
        "z not rounded to bf16 (sub-ulp)": (
            "upconv.cu", "const float z = round_bf16(", "const float z = (",
            False),
    }),
    # the masks live in window_attention.cuh, shared with K7: a broken mask
    # breaks both, and K9's check against its plain version refuses it
    "chain": ("_check_chain(np.random.default_rng(6))", ("swin_", "chain vs"), {
        "K10: LN1 skipped": (
            "swin_chain.cu",
            "layer_norm_rows<true>([&](int t) { return x + g.pix(win, t); }",
            "layer_norm_rows<false>([&](int t) { return x + g.pix(win, t); }",
            True),
        "K10: qkv bias dropped": (
            "swin_chain.cu", "v[i] + bq[c + i] : 0.0f;", "v[i] : 0.0f;", True),
        "K9: position bias dropped": (
            "window_attention.cuh", "float t = brow[j];", "float t = 0.0f;",
            True),
        "K9: last-row mask dropped": (
            "window_attention.cuh",
            "if (lr && qr != ((jr >> i) & 1u)) t += -100.0f;", "", True),
        "K9: last-column mask dropped": (
            "window_attention.cuh",
            "if (lc && qc != ((jc >> i) & 1u)) s += -100.0f;", "", True),
        "K9: last 16 keys dropped": (
            "swin_chain.cu", "n - r0, n, n16, [&](int r) {",
            "n - r0, n - 16, n16, [&](int r) {", True),
        "K11: extra dropped": (
            "swin_chain.cu",
            "if (a.extra != nullptr) o += __bfloat162float(er[i]);", "", True),
        "K11: fc2 bias dropped": (
            "swin_chain.cu", "xr[i] + v[i] + a.b2[c + i]", "xr[i] + v[i]",
            True),
    }),
}

CHECK = """
import sys
import numpy as np
sys.path.insert(0, '.')
import chip_smoke
chip_smoke.phase_build()
try:
    chip_smoke.{call}
    print('SURVIVED')
except AssertionError as exc:
    print('CAUGHT:', exc)
"""


def run_target(target: str) -> bool:
    """Every mutation of ``target``; True if each that must be caught
    was."""
    call, prefixes, mutations = TARGETS[target]
    csrc = os.path.join(REPO, "hdrvae_torch", "csrc")
    ok = True
    for name, (source, text, broken, must_catch) in mutations.items():
        src = open(os.path.join(csrc, source)).read()
        if src.count(text) != 1:
            print(f"== {name}: {source} does not hold the mutated text once",
                  file=sys.stderr)
            return False
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(REPO, "hdrvae_torch"),
                            os.path.join(tmp, "hdrvae_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
            with open(os.path.join(tmp, "hdrvae_torch", "csrc", source),
                      "w") as f:
                f.write(src.replace(text, broken))
            proc = subprocess.run(
                [sys.executable, "-c", CHECK.format(call=call)], cwd=tmp,
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


def main(argv=None) -> int:
    targets = (argv if argv is not None else sys.argv[1:]) or list(TARGETS)
    unknown = set(targets) - set(TARGETS)
    if unknown:
        print(f"unknown targets {sorted(unknown)}; expected {list(TARGETS)}",
              file=sys.stderr)
        return 2
    results = [run_target(t) for t in targets]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
