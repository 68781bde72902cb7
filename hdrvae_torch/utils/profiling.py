"""Tracing, profiling and numerics debugging, as
``hdrvae/utils/profiling.py``:

  - :func:`trace`: a ``torch.profiler`` trace of the enclosed work, written
    as a Chrome trace (and the profiler kept for its tables);
  - :class:`StageTimer`: wall-clock stage times that synchronize once at
    each stage's end, opt-in;
  - :func:`op_profile` / :func:`kernel_rows`: one run's device time per
    kernel (per op on the CPU), summed by name; :func:`collective_rows`:
    its process-group collectives, each with its wait for the other ranks;
  - :func:`debug_nans`: a scope that raises ``FloatingPointError`` at the
    first NaN an op or a kernel of the port writes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from hdrvae_torch.kernels import _build

logger = logging.getLogger(__name__)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work with ``torch.profiler`` (the card's
    kernels too, where there is one) and write its Chrome trace to
    ``logdir/trace.json``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(tree) -> None:
    """One synchronize of each CUDA device that holds a tensor of
    ``tree``."""
    leaves, _ = tree_flatten(tree)
    for dev in {t.device for t in leaves
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Wall-clock stage timer; a stage ends with one synchronize of the
    devices holding ``block_on`` (not one a statistic)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _sync(block_on)
        self.stages[name] = time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"total {total * 1e3:.1f} ms"]
        for name, dt in self.stages.items():
            lines.append(f"  {name}: {dt * 1e3:.1f} ms")
        return "\n".join(lines)


def op_profile(fn, *args, logdir: Optional[str] = None,
               top: int = 25) -> list:
    """Run ``fn(*args)`` once to warm up, then once under
    ``torch.profiler``; returns :func:`kernel_rows` of that run.
    ``logdir``: also write its Chrome trace there."""
    _sync(fn(*args))
    with torch.profiler.profile(activities=_activities()) as prof:
        _sync(fn(*args))
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return kernel_rows(prof, top)


def kernel_rows(prof: torch.profiler.profile,
                top: Optional[int] = 25) -> list:
    """(name, count, total ms) rows of a finished profile's device time
    (the card's kernels where there is one, else the CPU's ops by self
    time), sorted by time, with instance suffixes (``.12``, ``_3``) merged
    per name, the first ``top`` (all with None).  On the card only kernel
    events count: an op's device time is its kernels' time, so the rows
    partition the device time."""
    cuda = torch.cuda.is_available()
    agg: Dict[str, list] = {}
    for e in prof.key_averages():
        if cuda and e.device_type != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) if cuda \
            else e.self_cpu_time_total
        if not us:
            continue
        key = re.sub(r"[._]?\d+$", "", e.key)
        rec = agg.setdefault(key, [0, 0.0])
        rec[0] += e.count
        rec[1] += us / 1e3
    rows = sorted(((k, n, ms) for k, (n, ms) in agg.items()),
                  key=lambda r: -r[2])
    return rows if top is None else rows[:top]


def collective_rows(prof: torch.profiler.profile) -> list:
    """(name, count, total ms) rows of a finished profile's process-group
    collectives (the ``gloo:`` / ``nccl:`` host events), sorted by time.
    A gloo event lasts from the collective's start on this rank to its
    end, so its time includes the wait for the other ranks."""
    rows = [(e.key, e.count, e.cpu_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and e.key.startswith(("gloo:", "nccl:"))]
    return sorted(rows, key=lambda r: -r[2])


class _NanMode(TorchDispatchMode):
    """Checks the floating outputs of every op that writes values for a
    NaN: not of views (they write nothing) nor of the ``empty`` family
    (uninitialized memory)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        if func.is_view or name.startswith(("empty", "new_empty")):
            return out
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    bool(torch.isnan(t).any()):
                raise FloatingPointError(f"{func}: the op wrote a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """While open (``enable``), the first NaN that a PyTorch op or a kernel
    wrapper of the port writes raises ``FloatingPointError``: ops through
    a dispatch hook, the kernels (launched through ctypes, out of the
    hook's sight) by their wrappers' own check (``kernels._build
    .nan_check``).  Every check synchronizes: for debugging only."""
    if not enable:
        yield
        return
    _build.NAN_SCOPES += 1
    try:
        with _NanMode():
            yield
    finally:
        _build.NAN_SCOPES -= 1
