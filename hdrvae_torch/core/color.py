"""Color primitives on tensors (channel-last), as ``hdrvae/core/color.py``."""

from __future__ import annotations

import torch


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """Sign-preserving inverse sRGB EOTF: the curve is applied to |x| and
    the sign restored, so negative values survive."""
    a = torch.abs(srgb)
    linear_part = a / 12.92
    gamma_part = torch.pow((a + 0.055) / 1.055, 2.4)
    out = torch.where(a <= 0.04045, linear_part, gamma_part)
    return torch.sign(srgb) * out


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Sign-preserving forward sRGB OETF, the inverse of
    :func:`srgb_to_linear`."""
    a = torch.abs(linear)
    lin_part = a * 12.92
    gamma_part = 1.055 * torch.pow(a, 1.0 / 2.4) - 0.055
    out = torch.where(a <= 0.0031308, lin_part, gamma_part)
    return torch.sign(linear) * out


# BT.601 YCbCr offset of kornia and of the upscale node's own inverse.
_YCBCR_DELTA = 0.5


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> YCbCr (BT.601, kornia's coefficients), never clamped, so HDR
    luma and out-of-gamut chroma survive."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + _YCBCR_DELTA
    cr = (r - y) * 0.713 + _YCBCR_DELTA
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """YCbCr -> RGB, unclamped (the upscale node's 1.403 / 0.714 / 0.344 /
    1.773 inverse)."""
    y = ycbcr[..., 0]
    cb = ycbcr[..., 1] - _YCBCR_DELTA
    cr = ycbcr[..., 2] - _YCBCR_DELTA
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.stack([r, g, b], dim=-1)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma with a trailing singleton channel."""
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return y[..., None]
