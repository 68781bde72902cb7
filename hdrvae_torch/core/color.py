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
