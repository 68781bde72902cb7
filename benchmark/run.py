"""The benchmark of hdrvae_torch: one cell of ``BENCHMARK.json`` on the
card, one JSON line of results.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell's traffic file names its kind
(``benchmark/harness/drivers.py``); the weights and inputs are made on the
card from ``--seed``; the window lasts ``--seconds``; the metrics are the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics, read
from a profiler span inside the window (``--trace 1``), each computed by
``benchmark/metrics/<name>.py``.  Once the window has closed the
reference (``benchmark/reference/``) checks what the timed path produced;
the numbers compared and their limits (``benchmark/checks/<cell>.json``)
are the last lines on standard error and the ``check`` key of the result.

Without a card, or with fewer cards than the cell asks for, the run exits
2 with no result.  It exits 3 with no result if a module of JAX or of the
JAX package was loaded.
"""

import os
import time

T_PC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hdrvae")


def since_process_start() -> float:
    """Seconds from this process's start to now (its start time in
    ``/proc``), or from the first line of this file where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_PC


def forbidden_modules(names=None) -> list:
    """Modules loaded in this process (or ``names``) whose top-level name
    is JAX's or the JAX package's, compared whole: ``hdrvae_torch`` is not
    ``hdrvae``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def card_line(n: int) -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return "; ".join(out[:n]) or "power limit not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # this moment on both clocks, to date the window's start from the
    # process's start
    since, t_pc = since_process_start(), time.perf_counter()

    import torch

    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA card(s), {visible} "
              "visible. No result.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    print(f"card: {name} x{visible} ({card_line(cell.chips)})",
          file=sys.stderr)

    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, since, t_pc)
    result = out["result"]
    result["device"]["kind"] = name

    bad = forbidden_modules()
    if bad:
        print(f"run: modules of JAX or of the JAX package were loaded: "
              f"{', '.join(bad)}. No result.", file=sys.stderr)
        return 3
    print("notes: " + json.dumps(out["notes"]), file=sys.stderr)
    print(f"check: correct={str(result['correct']).lower()} failed="
          f"{result['failed']} of {result['attempted']}", file=sys.stderr)
    for n, v, lim in out["rows"]:
        print(f"check: {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
