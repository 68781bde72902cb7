#!/usr/bin/env python3
"""Mutation check of K5's test in ``chip_smoke.py``, on one NVIDIA GPU.

    python3 tools/mutate_k5.py

For each mutation below it copies ``hdrvae_torch/`` and ``chip_smoke.py``
into a temporary directory, breaks ``csrc/upconv.cu`` there, builds that
copy's kernels and runs ``chip_smoke._check_k5`` (K5 against its plain
version at the 2048^2 decode's junction and a ragged map), then reports
whether the check refused the broken kernel.  The checkout itself is never
changed.  Exits non-zero if a mutant the check must catch survives; the
one marked ``sub-ulp`` moves each value by less than one bf16 ulp, below
what the 5e-2 budget can see, and is reported only.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (text of upconv.cu, its broken form, must the check catch it)
MUTATIONS = {
    "band not zeroed outside the image": (
        "o[e] = in ? silu(zn) : 0.0f;", "o[e] = silu(zn);", True),
    "up_bias dropped": (
        "acc_a[mt][t][2 * hf + e] +\n"
        "                                           up_bias[n + e]",
        "acc_a[mt][t][2 * hf + e]", True),
    "last conv1 weight piece skipped": (
        "      const int j = i - na;\n",
        "      const int j = i - na;\n      if (j == npb - 1) continue;\n",
        True),
    "z not rounded to bf16 (sub-ulp)": (
        "const float z = round_bf16(", "const float z = (", False),
}

CHECK = """
import sys
import numpy as np
sys.path.insert(0, '.')
import chip_smoke
chip_smoke.phase_build()
try:
    chip_smoke._check_k5(np.random.default_rng(5))
    print('SURVIVED')
except AssertionError as exc:
    print('CAUGHT:', exc)
"""


def main() -> int:
    src_path = os.path.join(REPO, "hdrvae_torch", "csrc", "upconv.cu")
    src = open(src_path).read()
    failed = False
    for name, (text, broken, must_catch) in MUTATIONS.items():
        if text not in src:
            print(f"== {name}: the source no longer has the mutated text",
                  file=sys.stderr)
            return 2
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(REPO, "hdrvae_torch"),
                            os.path.join(tmp, "hdrvae_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
            with open(os.path.join(tmp, "hdrvae_torch", "csrc",
                                   "upconv.cu"), "w") as f:
                f.write(src.replace(text, broken))
            proc = subprocess.run([sys.executable, "-c", CHECK], cwd=tmp,
                                  capture_output=True, text=True,
                                  timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(("K5", "CAUGHT", "SURVIVED"))]
        caught = proc.returncode == 0 and any(ln.startswith("CAUGHT")
                                              for ln in lines)
        print(f"== {name}: {'caught' if caught else 'not caught'}",
              *lines, sep="\n  ", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
        failed |= must_catch and not caught
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
