"""One run of a cell after the look for a card: the driver's window, the
trace's reduction, the reference's check, and the metric readers, as the
result line's fields.  ``benchmark/run.py`` looks for the card, calls
:func:`run_cell`, and prints; the harness's tests call it on the CPU at
small sizes."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.harness import compare, drivers, spec, trace


def number(v) -> float:
    """A JSON number: an infinite reading (a request that never came) as
    1e30."""
    v = float(v)
    return v if math.isfinite(v) else 1e30


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, since_start: float, t_pc: float) -> Dict:
    """The result of one run: ``since_start`` seconds had passed since the
    process started at ``time.perf_counter() == t_pc``.  Returns the
    result line (without the device's name, which the caller adds), the
    rows compared and the driver's notes."""
    driver = drivers.DRIVERS[cell.traffic["kind"]]
    with torch.no_grad():
        measured = driver(cell, seed, seconds, traced, device)
    setup_s = since_start + (measured.started - t_pc)
    reduced = None
    if traced:
        reduced = trace.reduce_span(measured.span, spec.kernel_patterns())
    measured.span = None
    with torch.no_grad():
        numbers = measured.check()
    ok, rows = compare.judge(numbers, cell.check["limits"])
    ok = ok and measured.failed == 0

    ctx = {"kind": measured.kind, "cell": cell.name,
           "window_s": measured.window_s, "megapixels": measured.megapixels,
           "attempted": measured.attempted, "failed": measured.failed,
           "latencies_ms": measured.latencies_ms,
           "peak_bytes": measured.peak_bytes, "setup_s": setup_s,
           "work": measured.work, "counters": measured.counters,
           "trace": reduced}
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": number(value), "unit": m["unit"]}
    device_rec = {"platform": "gpu", "count": cell.chips,
                  "memory_peak_bytes": measured.peak_bytes}
    result = {"correct": bool(ok), "attempted": measured.attempted,
              "failed": measured.failed, "metrics": metrics,
              "device": device_rec}
    if reduced is not None:
        device_rec["busy_s"] = reduced["busy_s"]
        device_rec["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["check"] = {n: {"value": number(v), "limit": lim}
                       for n, v, lim in rows}
    notes = {**measured.notes, "window_s": measured.window_s,
             "setup_s": setup_s}
    if reduced is not None:
        notes["trace"] = {k: reduced[k] for k in
                          ("items", "class_s", "other_ops")}
    return {"result": result, "rows": rows, "notes": notes,
            "numbers": numbers}
