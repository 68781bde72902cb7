"""The device trace of a traced run: a ``torch.profiler`` span inside the
measured window, reduced to the device's busy time, the time of each work
class by the kernel-name patterns of ``benchmark/kernels/``, the device
operations that took the most time, and the longest idle gaps named by
what the host was doing in them."""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark.harness.spec import classify_kernel

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAMED_GAPS = 2000
NAME_CHARS = 160


def merged_name(name: str) -> str:
    """A kernel's name with its instance suffix (``.12``, ``_3``) merged,
    as ``hdrvae_torch/utils/profiling.py::kernel_rows`` merges them."""
    return re.sub(r"[._]?\d+$", "", name)[:NAME_CHARS]


class Span:
    """A profiler span: :meth:`start` and :meth:`stop` from the thread
    that drives the window; ``items`` counts the work finished inside."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None
        self.items = 0

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    @staticmethod
    def _profiler():
        import torch
        # the device's activity and the runtime calls that launched it:
        # recording every CPU op as well slows the host further, and in
        # the open loop that keeps the engine's queue full (the served
        # cell's traced idle share read 3-9 % so, 36-39 % without)
        return torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop a profiler once, in set-up: a process's first
        start loads and initializes the tracer, which took seconds and,
        inside the window, held up the open loop's arrivals."""
        import torch
        with self._profiler():
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def start(self, sync: bool = True) -> None:
        import torch
        if sync:
            torch.cuda.synchronize(self.device)
        self.prof = self._profiler()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, sync: bool = True) -> None:
        import torch
        if sync:
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self) -> List[dict]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return data["traceEvents"] if isinstance(data, dict) else data


def reduce_events(events: List[dict], patterns: List[Dict],
                  window_s: float) -> Dict:
    """busy_s, class_s, device_ops and idle_gaps of a chrome trace's
    events (times in microseconds)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["dur"]), e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["dur"]), e.get("name", "")))
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    dev.sort()
    ops: Dict[str, float] = collections.defaultdict(float)
    other: Dict[str, float] = collections.defaultdict(float)
    class_s: Dict[str, float] = collections.defaultdict(float)
    for ts, dur, name in dev:
        ops[merged_name(name)] += dur / 1e6
        cls = classify_kernel(name, patterns) or "other"
        class_s[cls] += dur / 1e6
        if cls == "other":
            other[merged_name(name)] += dur / 1e6
    # the union of the device intervals, and the gaps between them
    merged = []
    for ts, dur, _ in dev:
        end = ts + dur
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([ts, end])
    busy_s = sum(b - a for a, b in merged) / 1e6
    lo = min([ts for ts, _, _ in host] + [merged[0][0]])
    hi = max([ts + d for ts, d, _ in host] + [merged[-1][1]])
    edges = [lo] + [v for iv in merged for v in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = collections.defaultdict(float)
    if host:
        hs = np.asarray([h[0] for h in host])
        he = hs + np.asarray([h[1] for h in host])
        names = [h[2] for h in host]
    for a, b in gaps[:NAMED_GAPS]:
        name = "host: outside the CUDA runtime"
        if host:
            mid = (a + b) / 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if inside.size:
                k = inside[np.argmin(he[inside] - hs[inside])]
                name = "host: " + names[k][:NAME_CHARS]
        idle[name] += (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": window_s, "class_s": dict(class_s),
            "device_ops": top(ops), "idle_gaps": top(idle),
            "other_ops": top(other)}


def reduce_span(span: Optional[Span], patterns: List[Dict]) -> Optional[Dict]:
    if span is None or span.prof is None:
        return None
    out = reduce_events(span.events(), patterns, span.t1 - span.t0)
    out["items"] = span.items
    return out
