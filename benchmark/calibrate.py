"""Readings that the benchmark's limits and rates were set from, on the
card, in one process a call.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3]
    python3 benchmark/calibrate.py --workload <serve cell> \\
        --knee 4,5,6,7 [--seconds 40]

The first form runs the cell on each of ``--seeds`` (a short window at the
cell's own load and sizes, then the reference's check) and prints the
numbers compared; then, on each of ``--control-seeds``, the numbers of
the control: the reference computed in the precision below the cell's
(``control`` in ``benchmark/checks/<cell>.json``) put in the program's
place.  The lower reading of a limit is the largest number of the
program's seeds, the upper one the smallest of the control's.

The second form runs a served cell's open loop at each rate and prints
its latencies, the requests still pending when the window closed and how
late the generator ran: the knee is the highest rate whose backlog does
not grow over the window.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(s: str):
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--knee", default="")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from benchmark.harness import drivers, runner, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    for rate in [float(v) for v in args.knee.split(",") if v]:
        c = dataclasses.replace(cell, traffic={**cell.traffic,
                                               "rate_per_s": rate})
        m = drivers.serve_open(c, 1000 + int(rate * 100), args.seconds,
                               False, device)
        lat = m.latencies_ms          # in order of due time
        half = len(lat) // 2
        emit({"knee_rate": rate, "requests": len(lat), "failed": m.failed,
              "p50_ms": drivers.p_rank(lat, 0.5),
              "p95_ms": drivers.p_rank(lat, 0.95),
              "first_half_mean_ms": sum(lat[:half]) / max(1, half),
              "second_half_mean_ms": sum(lat[half:])
              / max(1, len(lat) - half),
              "peak_gib": m.peak_bytes / 2 ** 30, **m.notes})
        del m
        torch.cuda.empty_cache()

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        out = runner.run_cell(cell, seed, args.seconds, False, device,
                              0.0, time.perf_counter())
        emit({"seed": seed, "program": out["numbers"],
              "correct": out["result"]["correct"],
              "metrics": out["result"]["metrics"],
              "failed": out["result"]["failed"],
              "run_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        with torch.no_grad():
            numbers = drivers.control_numbers(cell, seed, device,
                                              cell.check["control"])
        emit({"seed": seed, "control": cell.check["control"],
              "numbers": numbers, "run_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
