"""Tensor statistics kept on the device until one host fetch, as
``hdrvae/core/stats.py``."""

from __future__ import annotations

from typing import Dict

import torch


def tensor_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """min/max/mean/std of ``x`` as 0-d float32 tensors; ``std`` is the
    unbiased (ddof=1) estimator, zero for a single element.

    The squared deviations are formed in place on one float32 copy of x,
    after the float32 view of x is released: one full-size float32
    temporary at a time, where ``square(xf - mean)`` holds three (the same
    values, bit for bit)."""
    xf = x.float()
    n = xf.numel()
    mean, mn, mx = xf.mean(), xf.min(), xf.max()
    del xf
    if n > 1:
        dev = x.to(torch.float32, copy=True).sub_(mean).square_()
        var = torch.sum(dev) / (n - 1)
        del dev
    else:
        var = torch.zeros((), dtype=torch.float32, device=x.device)
    return {"min": mn, "max": mx, "mean": mean, "std": torch.sqrt(var)}


def hdr_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Range plus HDR (> 1) and negative pixel counts."""
    xf = x.float()
    return {"min": xf.min(), "max": xf.max(),
            "hdr_pixels": torch.sum(xf > 1.0).to(torch.int32),
            "negative_pixels": torch.sum(xf < 0.0).to(torch.int32)}


def stats_to_host(stats) -> Dict[str, float]:
    """Pull a (possibly nested) stats dict to Python scalars: floats for
    floating tensors, ints otherwise."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = stats_to_host(v)
        else:
            t = torch.as_tensor(v)
            out[k] = float(t) if t.is_floating_point() else int(t)
    return out
