"""Tensor statistics kept on the device until one host fetch, as
``hdrvae/core/stats.py``."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


Layout = List[Tuple[Tuple[str, ...], bool, int]]


def pack_stats(stats) -> Tuple[torch.Tensor, Layout]:
    """The 0-d leaves of a (possibly nested) stats dict as one float64
    tensor on their device, and its layout: each leaf's key path, whether
    it is floating, and its index in the tensor.  float32 values and int32
    counts are exact in float64, so :func:`unpack_stats` gives back what
    one host fetch of each leaf would."""
    paths, leaves = [], []

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            t = torch.as_tensor(v)
            if t.numel() != 1:
                raise ValueError(f"stats leaf {path + (k,)} has shape "
                                 f"{tuple(t.shape)}, not a scalar")
            paths.append(path + (k,))
            leaves.append(t.reshape(()))
    walk(stats, ())
    if not leaves:
        return torch.zeros(0, dtype=torch.float64), []
    device = leaves[0].device
    # one stack a dtype, then a cast and one cat: a few launches, not one
    # a leaf
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    index, parts, offset = [0] * len(leaves), [], 0
    for idx in groups.values():
        for j, i in enumerate(idx):
            index[i] = offset + j
        offset += len(idx)
        parts.append(torch.stack([leaves[i].to(device) for i in idx]))
    flat = torch.cat([p.to(torch.float64) for p in parts])
    layout = [(path, t.is_floating_point(), i)
              for path, t, i in zip(paths, leaves, index)]
    return flat, layout


def unpack_stats(flat, layout: Layout) -> Dict[str, Any]:
    """The nested dict of Python scalars from :func:`pack_stats`'s tensor
    (on the host) and layout: floats for floating leaves, ints
    otherwise."""
    values = flat.tolist()
    out: Dict[str, Any] = {}
    for path, floating, i in layout:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = float(values[i]) if floating else int(values[i])
    return out


def stats_to_host(stats) -> Dict[str, Any]:
    """Pull a (possibly nested) stats dict to Python scalars, floats for
    floating tensors and ints otherwise, in one device-to-host copy."""
    flat, layout = pack_stats(stats)
    return unpack_stats(flat.cpu(), layout)
