"""Spatial filters on NHWC tensors, as ``hdrvae/upscale/filters.py``: the
gaussian pre-filter (torchvision's ``gaussian_blur``, reflect padding) and
the median post-filter (kornia's ``median_blur``, zero padding)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64) - half
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect(x: torch.Tensor, top: int, left: int) -> torch.Tensor:
    """Reflect-pad the H (``top``) or W (``left``) axis of NHWC ``x``."""
    xp = F.pad(x.permute(0, 3, 1, 2), (left, left, top, top), mode="reflect")
    return xp.permute(0, 2, 3, 1)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 3,
                  sigma: float = 0.1) -> torch.Tensor:
    """Separable gaussian blur with reflect padding; the defaults are the
    upscale node's hot-pixel pre-filter (k = 3, sigma = 0.1)."""
    k = _gaussian_kernel1d(kernel_size, sigma).tolist()
    pad = kernel_size // 2
    h, w = x.shape[1], x.shape[2]
    xp = _reflect(x, pad, 0)
    out = sum(k[i] * xp[:, i:i + h] for i in range(kernel_size))
    xp = _reflect(out, 0, pad)
    return sum(k[i] * xp[:, :, i:i + w] for i in range(kernel_size))


def median_blur(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """k x k median over NHWC ``x``.  Borders use ZERO padding, as kornia
    (its window extraction is a zero-padded conv), so a border median
    counts the implicit zeros."""
    pad = kernel_size // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    h, w = x.shape[1], x.shape[2]
    windows = torch.stack([xp[:, dy:dy + h, dx:dx + w]
                           for dy in range(kernel_size)
                           for dx in range(kernel_size)], dim=0)
    n = kernel_size * kernel_size
    return torch.sort(windows, dim=0).values[n // 2]
